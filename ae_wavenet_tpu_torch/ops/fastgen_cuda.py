"""Fused autoregressive sampler: one CUDA launch generates T samples.

Replaces the TPU kernel ``ae_wavenet_tpu/ops/fastgen_pallas.py``
``generate_fused`` (its bf16, int8 and int4 branches) with
``csrc/fastgen.cu``, kernels written by hand for Hopper (``sm_90a``).  Each
step embeds the previous id,
runs every gated layer with its ring-buffer queue, the post-net and
Gumbel-max (or greedy) sampling; the contract, down to where bf16
rounding happens, is spelled out at the top of the CUDA source and
implemented in plain PyTorch by :func:`generate_fused_reference`.

What bounds it on the card: every step reads all layer weights (about
25.6 MB in bf16 at the flagship width), since the AR dependency allows no
reuse across steps.  They fit the H100's 50 MB L2.  The kernel gives each
cluster of 8 blocks 8 batch rows for the whole rollout (clusters never
synchronise); the blocks of a cluster split every GEMM's output columns,
so each SM reads 1/8 of the weights per step, and exchange activations
through distributed shared memory.

:func:`generate_fused` dispatches on the device of the tensors it is
given: CUDA tensors launch the kernel (or raise), CPU tensors take the
plain version.  ``generate_fused.launches`` counts the bf16 kernel's
launches, ``.launches_int8`` and ``.launches_int4`` the quantized kernels';
``generate_fused_reference.launches`` counts every run of the plain version.

Quantized weights (``quantized="int8"`` or ``"int4"``): per-output-column
int8 or nibble-packed int4 layer weights, activations quantized to int8 per
layer and step with one scale over the whole batch tile, int32 sums; the
embedding and the post-net stay bf16.  The layout is this card's: four
consecutive input rows of one column share a 32-bit word (``__dp4a``), and
the input rows are zero-padded to a multiple of 8.  The scale couples every
batch row, so with more than 8 rows the kernel reduces across the whole grid
and all its clusters must be resident at once: :func:`quantized_max_batch`
gives the bound and :func:`generate_fused` raises ``ValueError`` above it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ae_wavenet_tpu_torch.models.wavenet import WaveNet
from ae_wavenet_tpu_torch.ops import fastgen
from ae_wavenet_tpu_torch.ops.fastgen import GenState
from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

_MAX_LAYERS = 64  # csrc/fastgen.cu MAX_LAYERS


class KernelParams(NamedTuple):
    """Weights laid out for the sampler, input-major (xin @ W)."""

    w_in: torch.Tensor     # [L, 2*n_res + n_cond, 2*n_dil] bf16 (prev|cur|cond)
    b_in: torch.Tensor     # [L, 2*n_dil] f32
    w_out: torch.Tensor    # [L, n_dil, n_res + n_skp] bf16
    b_out: torch.Tensor    # [L, n_res + n_skp] f32
    embed: torch.Tensor    # [n_quant, n_res] bf16
    post1_w: torch.Tensor  # [n_skp, n_post] bf16
    post1_b: torch.Tensor  # [n_post] f32
    post2_w: torch.Tensor  # [n_post, n_quant] bf16
    post2_b: torch.Tensor  # [n_quant] f32


@torch.no_grad()
def pack_for_kernel(wavenet: WaveNet, cfg: WaveNetConfig) -> KernelParams:
    p = fastgen.pack_params(wavenet, cfg)
    bf16 = torch.bfloat16
    return KernelParams(
        w_in=torch.stack(p["w_in"]).to(bf16).contiguous(),
        b_in=torch.stack(p["b_in"]).float().contiguous(),
        w_out=torch.stack(p["w_out"]).to(bf16).contiguous(),
        b_out=torch.stack(p["b_out"]).float().contiguous(),
        embed=p["embed"].to(bf16).contiguous(),
        post1_w=p["post1_w"].to(bf16).contiguous(),
        post1_b=p["post1_b"].float().contiguous(),
        post2_w=p["post2_w"].to(bf16).contiguous(),
        post2_b=p["post2_b"].float().contiguous(),
    )


class Int8KernelParams(NamedTuple):
    """Per-output-column int8 layer weights; the rest as KernelParams.  Row k
    of an unpacked plane is byte k % 4 of word k // 4."""

    w_in_q: torch.Tensor   # [L, Kp/4, 2*n_dil, 4] int8, Kp = xin rows padded to 8
    w_in_s: torch.Tensor   # [L, 1, 2*n_dil] f32 per-column scales
    b_in: torch.Tensor
    w_out_q: torch.Tensor  # [L, Dp/4, n_res + n_skp, 4] int8, Dp = n_dil padded to 8
    w_out_s: torch.Tensor  # [L, 1, n_res + n_skp] f32
    b_out: torch.Tensor
    embed: torch.Tensor
    post1_w: torch.Tensor
    post1_b: torch.Tensor
    post2_w: torch.Tensor
    post2_b: torch.Tensor


class Int4KernelParams(NamedTuple):
    """Nibble-packed int4 layer weights: byte k of a column holds the code of
    row k in its high nibble (signed, [-7, 7]) and the code of row k + Kp/2
    plus 8 in its low nibble ([1, 15]); bytes laid out as in
    Int8KernelParams.  Scales are per output column over the whole column."""

    w_in_p: torch.Tensor   # [L, Kp/8, 2*n_dil, 4] int8 bytes
    w_in_s: torch.Tensor   # [L, 1, 2*n_dil] f32
    b_in: torch.Tensor
    w_out_p: torch.Tensor  # [L, Dp/8, n_res + n_skp, 4] int8 bytes
    w_out_s: torch.Tensor  # [L, 1, n_res + n_skp] f32
    b_out: torch.Tensor
    embed: torch.Tensor
    post1_w: torch.Tensor
    post1_b: torch.Tensor
    post2_w: torch.Tensor
    post2_b: torch.Tensor


_ZERO_POINT = 8  # the int4 low nibble stores code + 8


def _norm_wq(quantized) -> str | None:
    """The public ``quantized`` knob: False/None/'none' -> None, True/'int8'
    -> 'int8', 'int4' -> 'int4'."""
    if quantized is None or quantized is False or quantized == "none":
        return None
    if quantized is True or quantized == "int8":
        return "int8"
    if quantized == "int4":
        return "int4"
    raise ValueError(f"quantized={quantized!r}: expected bool, 'int8' or 'int4'")


def quantize_per_out_channel(w: torch.Tensor):
    """w [..., in, out] f32 -> (int8 codes, [..., 1, out] f32 scales)."""
    s = torch.clamp(w.abs().amax(-2, keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), s.float()


def quantize_int4_pair(w: torch.Tensor):
    """w [..., IN, OUT] f32 -> (nibble-packed [..., IN//2, OUT] int8 bytes,
    [..., 1, OUT] f32 scales): byte i holds row i (high nibble, signed) and
    row i + IN/2 (low nibble, code + 8).  IN must be even."""
    rows = w.shape[-2]
    if rows % 2:
        raise ValueError(f"quantize_int4_pair pairs row i with row i + IN/2: "
                         f"IN={rows} must be even")
    s = torch.clamp(w.abs().amax(-2, keepdim=True) / 7.0, min=1e-12)
    q = torch.clamp(torch.round(w / s), -7, 7).to(torch.int32)
    hi, lo = q[..., : rows // 2, :], q[..., rows // 2 :, :] + _ZERO_POINT
    return ((hi << 4) | lo).to(torch.int8), s.float()


def _pad_rows(w: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = -w.shape[-2] % multiple
    return torch.nn.functional.pad(w, (0, 0, 0, pad)) if pad else w


def _words(rows: torch.Tensor) -> torch.Tensor:
    """[L, R, N] bytes -> [L, R/4, N, 4]: four consecutive rows per word."""
    n_l, r, n = rows.shape
    return rows.reshape(n_l, r // 4, 4, n).permute(0, 1, 3, 2).contiguous()


def unpack_int8(words: torch.Tensor) -> torch.Tensor:
    """Int8KernelParams weights -> the int8 plane [L, Kp, N] (the inverse of
    :func:`_words`)."""
    n_l, r4, n, _ = words.shape
    return words.permute(0, 1, 3, 2).reshape(n_l, r4 * 4, n)


def unpack_int4(words: torch.Tensor):
    """Int4KernelParams weights -> (hi [L, Kp/2, N] in [-7, 7], lo
    [L, Kp/2, N] in [1, 15]) int8 planes: rows [0, Kp/2) and [Kp/2, Kp)."""
    b = unpack_int8(words)
    return b >> 4, b & 15


@torch.no_grad()
def pack_for_kernel_int8(wavenet: WaveNet, cfg: WaveNetConfig) -> Int8KernelParams:
    """Quantized from the bf16-rounded weights, in f32."""
    p = pack_for_kernel(wavenet, cfg)
    w_in_q, w_in_s = quantize_per_out_channel(_pad_rows(p.w_in.float(), 8))
    w_out_q, w_out_s = quantize_per_out_channel(_pad_rows(p.w_out.float(), 8))
    return Int8KernelParams(_words(w_in_q), w_in_s.contiguous(), p.b_in,
                            _words(w_out_q), w_out_s.contiguous(), p.b_out, *p[4:])


@torch.no_grad()
def pack_for_kernel_int4(wavenet: WaveNet, cfg: WaveNetConfig) -> Int4KernelParams:
    p = pack_for_kernel(wavenet, cfg)
    w_in_p, w_in_s = quantize_int4_pair(_pad_rows(p.w_in.float(), 8))
    w_out_p, w_out_s = quantize_int4_pair(_pad_rows(p.w_out.float(), 8))
    return Int4KernelParams(_words(w_in_p), w_in_s.contiguous(), p.b_in,
                            _words(w_out_p), w_out_s.contiguous(), p.b_out, *p[4:])


#: by sampler mode (None: bf16 weights): the packer and the type it returns
PACKERS = {None: pack_for_kernel, "int8": pack_for_kernel_int8,
           "int4": pack_for_kernel_int4}
_PARAMS = {None: KernelParams, "int8": Int8KernelParams, "int4": Int4KernelParams}


def _check_mode(packed, mode: str | None) -> None:
    if type(packed) is not _PARAMS[mode]:
        raise ValueError(f"quantized={mode!r} takes {_PARAMS[mode].__name__}, got "
                         f"{type(packed).__name__}")


def flat_buffers(cfg: WaveNetConfig):
    """Ring layout: flat [sum(dilations), B, n_res] bf16 with static per-layer
    offsets.  Layer l's slot at step t is off[l] + (t % d_l)."""
    offs, acc = [], 0
    for d in cfg.dilations:
        offs.append(acc)
        acc += d
    return offs, acc


def state_to_flat(state: GenState, cfg: WaveNetConfig) -> torch.Tensor:
    # per layer [B, C, d] -> [d, B, C], stacked along the slot axis
    return torch.cat([b.permute(2, 0, 1) for b in state.bufs]).to(
        torch.bfloat16).contiguous()


def flat_to_state(flat: torch.Tensor, prev_id: torch.Tensor, t: int,
                  cfg: WaveNetConfig) -> GenState:
    offs, _ = flat_buffers(cfg)
    bufs = tuple(flat[o : o + d].permute(1, 2, 0).float().contiguous()
                 for o, d in zip(offs, cfg.dilations))
    return GenState(bufs, prev_id, t)


# ------------------------------------------------------------ Philox bits

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a uint32 constant and uint32
    values held in int64, without overflowing int64 (16-bit split)."""
    p1, p0 = a * (b >> 16), a * (b & 0xFFFF)  # each < 2**48
    lo = (((p1 & 0xFFFF) << 16) + p0) & _U32
    return (p1 + (p0 >> 16)) >> 16, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 words: ctr is four
    broadcastable tensors, key two ints.  Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def gumbel_noise(seed: int, rows: torch.Tensor, t_abs: int,
                 n_quant: int) -> torch.Tensor:
    """The kernel's Gumbel draws for ``rows`` at step ``t_abs``: [R, n_quant]
    f32, from Philox key (seed, 0), counter (col // 4, row, t_abs, 0), word
    col % 4."""
    col = torch.arange(n_quant, device=rows.device)
    shape = (rows.shape[0], n_quant)
    c0 = (col >> 2)[None, :].expand(shape)
    c1 = rows.long()[:, None].expand(shape)
    c2 = torch.full(shape, t_abs, dtype=torch.long, device=rows.device)
    words = torch.stack(philox4x32_10((c0, c1, c2, torch.zeros_like(c2)),
                                      (seed, 0)))
    bits = torch.gather(words, 0, (col & 3)[None, None, :].expand(1, *shape))[0]
    u = (bits >> 8).float() * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u + 1e-12) + 1e-12)


# ------------------------------------------------------------ the sampler

def _tile_scale(v: torch.Tensor) -> torch.Tensor:
    """One int8 scale for the whole [B, C] tile: max(max|v|, 1e-9) / 127."""
    return torch.clamp(v.abs().max(), min=1e-9) * (1.0 / 127.0)


def _quantize_tile(v: torch.Tensor):
    """-> (integer-valued f64 codes in [-127, 127], the tile's f32 scale)."""
    s = _tile_scale(v)
    return torch.clamp(torch.round(v / s), -127, 127).double(), s


def _zero_point_correction(xq_lo: torch.Tensor) -> torch.Tensor:
    return _ZERO_POINT * xq_lo.sum(1, keepdim=True)


def _int_planes(packed, mode: str):
    """The layer weights as integer-valued f64 planes (f64 products and sums
    of these integers are exact): int8 -> ((w_in,), (w_out,)); int4 ->
    ((hi, lo), (hi, lo))."""
    if mode == "int8":
        return ((unpack_int8(packed.w_in_q).double(),),
                (unpack_int8(packed.w_out_q).double(),))
    return (tuple(p.double() for p in unpack_int4(packed.w_in_p)),
            tuple(p.double() for p in unpack_int4(packed.w_out_p)))


def _int_matmul(v: torch.Tensor, planes, l: int):
    """Quantize the tile v [B, C] and contract it with layer l's integer
    weights: -> (the int32 sums as f32 [B, N], the tile's scale)."""
    xq, s = _quantize_tile(v)
    kp = sum(p.shape[1] for p in planes)
    xq = torch.nn.functional.pad(xq, (0, kp - xq.shape[1]))
    if len(planes) == 1:
        acc = xq @ planes[0][l]
    else:  # int4: both halves of the rows, the zero-point as a row-sum term
        half = kp // 2
        acc = (xq[:, :half] @ planes[0][l] + xq[:, half:] @ planes[1][l]
               - _zero_point_correction(xq[:, half:]))
    return acc.float(), s


@torch.no_grad()
def generate_fused_reference(packed, cfg: WaveNetConfig,
                             flat: torch.Tensor, prev_id: torch.Tensor,
                             t0: int, cond: torch.Tensor, seed: int,
                             temperature: float = 1.0,
                             debug_logits: bool = False, quantized=False):
    """Plain PyTorch version of the kernels' contract (csrc/fastgen.cu).

    flat [sum_d, B, n_res] bf16 is updated in place; cond [B, n_cond, T]
    already carries the speaker embedding.  ``quantized`` selects the int8
    or int4 contract and the matching ``packed`` type.  Returns (ids [B, T]
    int32, flat, last_id [B] int32) and, with ``debug_logits``, logits
    [T, B, n_quant] f32."""
    mode = _norm_wq(quantized)
    _check_mode(packed, mode)
    generate_fused_reference.launches += 1
    bf16 = torch.bfloat16
    batch, _, t_len = cond.shape
    offs, _ = flat_buffers(cfg)
    n_res, n_dil = cfg.n_res, cfg.n_dil
    if mode is None:
        w_in, w_out = packed.w_in.float(), packed.w_out.float()
    else:
        q_in, q_out = _int_planes(packed, mode)
    embed = packed.embed.float()
    p1w, p2w = packed.post1_w.float(), packed.post2_w.float()
    cond_tm = cond.permute(2, 0, 1).to(bf16)
    rows = torch.arange(batch, device=flat.device)
    prev = prev_id.long()
    ids = torch.empty(batch, t_len, dtype=torch.int32, device=flat.device)
    all_logits = []
    for t in range(t_len):
        t_abs = t0 + t
        x = embed[prev]
        skip = torch.zeros(batch, cfg.n_skp, device=flat.device)
        for l, d in enumerate(cfg.dilations):
            slot = offs[l] + t_abs % d
            xb = x.to(bf16)
            xin = torch.cat([flat[slot], xb, cond_tm[t]], 1).float()
            flat[slot] = xb  # read (above), then write
            if mode is None:
                y = torch.addmm(packed.b_in[l], xin, w_in[l])
                h = torch.tanh(y[:, :n_dil]) * torch.sigmoid(y[:, n_dil:])
                rs = torch.addmm(packed.b_out[l], h.to(bf16).float(), w_out[l])
            else:
                acc, sx = _int_matmul(xin, q_in, l)
                y = acc * (sx * packed.w_in_s[l]) + packed.b_in[l]
                h = torch.tanh(y[:, :n_dil]) * torch.sigmoid(y[:, n_dil:])
                acc, sh = _int_matmul(h, q_out, l)
                rs = acc * (sh * packed.w_out_s[l]) + packed.b_out[l]
            x = x + rs[:, :n_res]
            skip = skip + rs[:, n_res:]
        h = torch.relu(skip).to(bf16).float()
        h = torch.relu(torch.addmm(packed.post1_b, h, p1w)).to(bf16).float()
        logits = torch.addmm(packed.post2_b, h, p2w)
        if debug_logits:
            all_logits.append(logits)
        scores = logits
        if temperature > 0.0:
            scores = logits * (1.0 / temperature) + gumbel_noise(
                seed, rows, t_abs, cfg.n_quant)
        prev = torch.argmax(scores, 1)
        ids[:, t] = prev.to(torch.int32)
    out = (ids, flat, ids[:, -1].clone())
    return out + (torch.stack(all_logits),) if debug_logits else out


generate_fused_reference.launches = 0


def _r8(n: int) -> int:
    return -(-n // 8) * 8


def _check_cuda_args(packed, mode: str | None, cfg: WaveNetConfig,
                     flat: torch.Tensor, prev_id: torch.Tensor,
                     cond: torch.Tensor) -> None:
    dev = flat.device
    n_layers = len(cfg.dilations)
    n_cond = cfg.n_lc_out + cfg.n_global_embed
    batch = cond.shape[0]
    xin, n_gate, n_out = 2 * cfg.n_res + n_cond, 2 * cfg.n_dil, cfg.n_res + cfg.n_skp
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    if mode is None:
        want = {"w_in": ((n_layers, xin, n_gate), bf16),
                "w_out": ((n_layers, cfg.n_dil, n_out), bf16)}
    else:
        per_word = 4 if mode == "int8" else 8  # input rows per 32-bit word
        w = "q" if mode == "int8" else "p"
        want = {f"w_in_{w}": ((n_layers, _r8(xin) // per_word, n_gate, 4), i8),
                "w_in_s": ((n_layers, 1, n_gate), f32),
                f"w_out_{w}": ((n_layers, _r8(cfg.n_dil) // per_word, n_out, 4), i8),
                "w_out_s": ((n_layers, 1, n_out), f32)}
    want.update({
        "b_in": ((n_layers, n_gate), f32),
        "b_out": ((n_layers, n_out), f32),
        "embed": ((cfg.n_quant, cfg.n_res), bf16),
        "post1_w": ((cfg.n_skp, cfg.n_post), bf16),
        "post1_b": ((cfg.n_post,), f32),
        "post2_w": ((cfg.n_post, cfg.n_quant), bf16),
        "post2_b": ((cfg.n_quant,), f32),
    })
    tensors = dict(packed._asdict(), flat=flat, prev_id=prev_id, cond=cond)
    want.update(flat=((sum(cfg.dilations), batch, cfg.n_res), bf16),
                prev_id=((batch,), None), cond=((batch, n_cond, cond.shape[2]), None))
    for name, (shape, dtype) in want.items():
        v = tensors[name]
        if v.device != dev:
            raise ValueError(f"{name} is on {v.device}, flat on {dev}")
        if tuple(v.shape) != shape or (dtype is not None and v.dtype != dtype):
            raise ValueError(f"{name}: {tuple(v.shape)} {v.dtype}, the kernel "
                             f"takes {shape} {dtype}")
        if not v.is_contiguous() and name not in ("cond", "prev_id"):
            raise ValueError(f"{name} must be contiguous")
        if name in packed._fields and v.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (vector loads)")
    if n_layers > _MAX_LAYERS:
        raise ValueError(f"{n_layers} layers; the kernel takes at most {_MAX_LAYERS}")
    if cfg.filter_sz != 2:
        raise ValueError("the sampler's two-tap cell needs filter_sz == 2")
    lo, hi = int(prev_id.min()), int(prev_id.max())
    if lo < 0 or hi >= cfg.n_quant:
        raise ValueError(f"prev_id out of [0, {cfg.n_quant}): [{lo}, {hi}]")


def _cuda_error(lib, rc: int, what: str) -> RuntimeError:
    return RuntimeError(f"{what} failed: CUDA error {rc} "
                        f"({lib.awt_cuda_error_string(rc).decode()})")


@functools.lru_cache(maxsize=None)
def _max_batch(int4: bool, widths: tuple, device_index: int) -> int:
    from ae_wavenet_tpu_torch.ops import _build

    lib = _build.load()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.awt_fastgen_q_max_batch(int(int4), *widths, ctypes.byref(out))
    if rc != 0:
        raise _cuda_error(lib, rc, "the quantized sampler's occupancy query")
    return out.value


def quantized_max_batch(cfg: WaveNetConfig, quantized, device) -> int:
    """The most batch rows the quantized sampler takes on ``device`` at these
    widths: its batch-wide activation scale is a reduction over the whole
    grid, so every cluster (8 rows each) must be resident at once."""
    mode = _norm_wq(quantized)
    if mode is None:
        raise ValueError("the bf16 sampler has no batch bound")
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    widths = (cfg.n_res, cfg.n_dil, cfg.n_skp, cfg.n_post, cfg.n_quant,
              cfg.n_lc_out + cfg.n_global_embed)
    return _max_batch(mode == "int4", widths, index)


def generate_fused(packed, cfg: WaveNetConfig,
                   flat: torch.Tensor, prev_id: torch.Tensor, t0: int,
                   cond: torch.Tensor, seed: int, temperature: float = 1.0,
                   debug_logits: bool = False, quantized=False):
    """T autoregressive steps -> (ids [B, T] int32, flat, last_id [B] int32
    [, logits [T, B, n_quant] f32]).

    flat [sum_d, B, n_res] bf16 (:func:`state_to_flat`) is the ring state,
    updated in place; t0 is its phase; cond [B, n_cond, T] already carries
    the speaker embedding (``fastgen.with_gc``).  ``quantized`` (False,
    True/'int8' or 'int4') selects the kernel and the type of ``packed``.
    On CUDA tensors this launches ``csrc/fastgen.cu`` on the current stream;
    on CPU tensors it runs :func:`generate_fused_reference`."""
    if t0 < 0 or cond.shape[-1] < 1:
        raise ValueError(f"need t0 >= 0 and at least one step, got t0={t0}, "
                         f"{cond.shape[-1]} steps")
    if not 0.0 <= temperature < math.inf:
        raise ValueError(f"temperature must be finite and >= 0, got {temperature}")
    mode = _norm_wq(quantized)
    _check_mode(packed, mode)
    seed = int(seed) & 0x7FFFFFFF  # the kernel takes a 31-bit seed
    if flat.device.type == "cpu":
        return generate_fused_reference(packed, cfg, flat, prev_id, t0, cond,
                                        seed, temperature, debug_logits, mode)
    if flat.device.type != "cuda":
        raise ValueError(f"no sampler for device {flat.device}")
    _check_cuda_args(packed, mode, cfg, flat, prev_id, cond)
    batch, n_cond, t_len = cond.shape
    dev = flat.device
    if mode is not None:
        bound = quantized_max_batch(cfg, mode, dev)
        if batch > bound:
            raise ValueError(
                f"batch {batch}: the {mode} sampler takes at most {bound} rows "
                "at these widths on this card (its activation scale spans the "
                "batch, so all its clusters must be resident at once)")
    from ae_wavenet_tpu_torch.ops import _build

    lib = _build.load()
    cond_tm = cond.permute(2, 0, 1).to(torch.bfloat16).contiguous()
    prev = prev_id.to(torch.int32).contiguous()
    ids = torch.empty(batch, t_len, dtype=torch.int32, device=dev)
    last = torch.empty(batch, dtype=torch.int32, device=dev)
    logits = (torch.empty(t_len, batch, cfg.n_quant, device=dev)
              if debug_logits else None)
    offs, _ = flat_buffers(cfg)
    n_layers = len(offs)
    offs_c = (ctypes.c_int * n_layers)(*offs)
    dils_c = (ctypes.c_int * n_layers)(*cfg.dilations)
    greedy = temperature == 0.0
    state = (cond_tm.data_ptr(), prev.data_ptr(), flat.data_ptr(), ids.data_ptr(),
             last.data_ptr(), logits.data_ptr() if debug_logits else None)
    dims = (batch, t_len, n_layers, cfg.n_res, cfg.n_dil, cfg.n_skp, cfg.n_post,
            cfg.n_quant, n_cond, int(t0), seed, 0.0 if greedy else 1.0 / temperature,
            int(greedy))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode is None:
            rc = lib.awt_fastgen_bf16(*(v.data_ptr() for v in packed), *state,
                                      offs_c, dils_c, *dims, stream)
        else:
            # the grid-wide reduction's arrival count and rotating slots
            scratch = torch.zeros(4, dtype=torch.int64, device=dev)
            rc = lib.awt_fastgen_q(int(mode == "int4"),
                                   *(v.data_ptr() for v in packed), *state,
                                   scratch.data_ptr(), offs_c, dils_c, *dims,
                                   stream)
    if rc != 0:
        raise _cuda_error(lib, rc, f"fastgen {mode or 'bf16'} kernel launch")
    if mode is None:
        generate_fused.launches += 1
    elif mode == "int8":
        generate_fused.launches_int8 += 1
    else:
        generate_fused.launches_int4 += 1
    out = (ids, flat, last)
    return out + (logits,) if debug_logits else out


generate_fused.launches = 0
generate_fused.launches_int8 = 0
generate_fused.launches_int4 = 0


@torch.no_grad()
def generate_auto(wavenet: WaveNet, cfg: WaveNetConfig, state: GenState,
                  cond: torch.Tensor, generator: torch.Generator | None = None,
                  gc_ids: torch.Tensor | None = None, temperature: float = 1.0,
                  quantized=False):
    """Sample cond.shape[-1] mu-law ids from a primed state with the fused
    sampler: bf16 weights, or int8 / int4 with ``quantized`` (True/'int8',
    'int4').  cond: [B, n_lc_out, T] without the speaker embedding.  The
    kernel's seed is drawn from ``generator``.  Returns (ids [B, T] int32,
    new GenState)."""
    mode = _norm_wq(quantized)
    packed = PACKERS[mode](wavenet, cfg)
    flat = state_to_flat(state, cfg)
    cond_gc = fastgen.with_gc(wavenet, cfg, cond, gc_ids)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    ids, flat, last = generate_fused(packed, cfg, flat, state.prev_id, state.t,
                                     cond_gc, seed, temperature, quantized=mode)
    return ids, flat_to_state(flat, last, state.t + cond.shape[-1], cfg)
