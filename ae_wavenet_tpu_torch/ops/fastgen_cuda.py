"""Fused autoregressive sampler: one CUDA launch generates T samples.

Replaces the TPU kernel ``ae_wavenet_tpu/ops/fastgen_pallas.py``
``generate_fused`` (its bf16, int8 and int4 branches) with
``csrc/fastgen.cu``, one kernel template written by hand for Hopper
(``sm_90a``).  Each step embeds the previous id, runs every gated layer with
its ring-buffer queue, the post-net and Gumbel-max (or greedy) sampling; the
contract, down to where bf16 rounding happens, is spelled out at the top of
the CUDA source and implemented in plain PyTorch by
:func:`generate_fused_reference`.

What bounds it on the card: the AR dependency allows no reuse of a weight
within a step, and every step needs all layer weights (about 25.6 MB in
bf16 at the flagship width).  So the weights must not move each step: one
persistent cooperative grid of about one block per SM splits every matrix
by output column (:func:`share_plan`), and each block keeps its column share
of every layer (201,728 bytes at ``chorowski`` in bf16, 128 blocks) resident
in shared memory for the whole launch.  Per step what remains is the
dependency chain: two grid-wide exchanges of activations per layer and
three for the post-net and the argmax, each a barrier with an L2 round
trip, and the products (on the tensor cores, operands straight from L2).
That chain bounds the time at small B; the activations' L2 reads, and for
int8 / int4 their quantization, bound it at large B.  Layers whose shares
do not fit stay in global memory and are read through L2 each step by the
same code.

:func:`generate_fused` dispatches on the device of the tensors it is
given: CUDA tensors launch the kernel (or raise), CPU tensors take the
plain version.  ``generate_fused.launches`` counts the bf16 kernel's
launches, ``.launches_int8`` and ``.launches_int4`` the quantized kernels';
``generate_fused_reference.launches`` counts every run of the plain version.

Quantized weights (``quantized="int8"`` or ``"int4"``): per-output-column
int8 or nibble-packed int4 layer weights, activations quantized to int8 per
layer and step with one scale over the whole batch, int32 sums; the
embedding and the post-net stay bf16.  The packed layout is this card's:
four consecutive input rows of one column share a 32-bit word, and the
input rows are zero-padded to a multiple of 8.  Every block reads the whole
activation matrix for its own product, so it quantizes it itself, with the
batch-wide scale taken from the blocks' published maxima: the quantized
kernels have no batch bound, as the bf16 one has none.
"""

from __future__ import annotations

import ctypes
import dataclasses
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


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _r64(n: int) -> int:
    return -(-n // 64) * 64


_PASS_ROWS = 64        # batch rows per pass of a GEMM (csrc/fastgen.cu PASS)
_MISC_SMEM = 64        # csrc/fastgen.cu: block maxima and a broadcast
_OWN_SMEM = 4096       # csrc/fastgen.cu OWN_BYTES: a block's x and skip columns
#: the column shares, each in its own matrix's column index space:
#: ``filter`` and ``gate`` of w_in, ``res`` and ``skip`` of w_out, ``post1``
#: and ``post2`` of the post-net's two matrices
SHARES = ("filter", "gate", "res", "skip", "post1", "post2")


@dataclasses.dataclass(frozen=True)
class SharePlan:
    """How the sampler's grid splits the weights (:func:`share_plan`).

    Block r owns the output columns ``cols(name, r)`` of each matrix; its
    share of a matrix is K-major per owned column (each column's input rows
    contiguous, zero-padded to ``col_bytes[name]``, a multiple of 64: the
    kernel's tensor-core products take 64-byte chunks of a column, a lane 16
    contiguous bytes of them).  In global memory block r's
    share is ``stride`` bytes at ``r * stride``: post1, post2, then each
    layer's filter, gate, res and skip columns.  The post-net and the first
    ``resident_layers`` layers (``resident_bytes`` at most, over the blocks)
    are copied into the block's shared memory at the start of a launch; the
    rest stay in global memory and are read through L2 each step."""

    n_blocks: int
    n_layers: int
    widths: tuple          # n_res, n_dil, n_skp, n_post, n_quant, xin
    col_bytes: dict        # SHARES name -> bytes of one owned column
    resident_layers: int
    resident_bytes: int
    stride: int
    aux_bytes: int         # own biases, scales and embedding columns
    part_units: int        # partial sums per row: most owned columns + 1
    smem_bytes: int        # dynamic shared memory of one block

    def _width(self, name: str) -> int:
        n_res, n_dil, n_skp, n_post, n_quant, _ = self.widths
        return {"filter": n_dil, "gate": n_dil, "res": n_res, "skip": n_skp,
                "post1": n_post, "post2": n_quant}[name]

    def cols(self, name: str, r):
        """Block r's columns [lo, hi) of matrix ``name`` (r an int, or a
        tensor of block indices)."""
        n, g = self._width(name), self.n_blocks
        base = {"gate": self.widths[1], "skip": self.widths[0]}.get(name, 0)
        return base + n * r // g, base + n * (r + 1) // g

    def n_cols(self, name: str, r: int) -> int:
        lo, hi = self.cols(name, r)
        return hi - lo

    def post_bytes(self, r: int) -> int:
        return sum(self.n_cols(n, r) * self.col_bytes[n] for n in ("post1", "post2"))

    def layer_bytes(self, r: int) -> int:
        return sum(self.n_cols(n, r) * self.col_bytes[n]
                   for n in ("filter", "gate", "res", "skip"))


@functools.lru_cache(maxsize=64)
def share_plan(n_res: int, n_dil: int, n_skp: int, n_post: int, n_quant: int,
               n_cond: int, n_layers: int, mode: str | None, n_sms: int,
               smem_capacity: int) -> SharePlan:
    """The sampler grid's split of the weights on a card with ``n_sms`` SMs
    and ``smem_capacity`` bytes of shared memory per block (232,448 on an
    H100).  The block count is the largest count up to ``n_sms`` that
    divides every output width, when that is at least half the SMs;
    otherwise ``n_sms`` blocks split each width as evenly as integers allow
    (some may own no column of a matrix).  Raises ``ValueError`` where no
    block can hold the post-net's share, the biases and the partial sums.
    A pure function of its arguments, kept for the next call with them."""
    mode = _norm_wq(mode)
    widths = (n_res, n_dil, n_skp, n_post, n_quant)
    if min(widths + (n_cond + 1, n_layers, n_sms)) < 1:
        raise ValueError(f"share_plan: widths {widths}, n_cond {n_cond}, "
                         f"{n_layers} layers, {n_sms} SMs")
    even = next(g for g in range(n_sms, 0, -1) if all(w % g == 0 for w in widths))
    n_blocks = even if 2 * even >= n_sms else n_sms
    xin = 2 * n_res + n_cond
    k_in, k_dil = _r8(xin), _r8(n_dil)
    if mode is None:
        c_in, c_out = 2 * k_in, 2 * k_dil
    elif mode == "int8":
        c_in, c_out = k_in, k_dil
    else:  # int4: a byte holds input rows k and k + Kp/2
        c_in, c_out = k_in // 2, k_dil // 2
    # whole 64-byte chunks per column (two tensor-core products each)
    col_bytes = {"filter": _r64(c_in), "gate": _r64(c_in), "res": _r64(c_out),
                 "skip": _r64(c_out), "post1": _r64(2 * n_skp),
                 "post2": _r64(2 * n_post)}
    plan = SharePlan(n_blocks, n_layers, widths + (xin,), col_bytes, 0, 0, 0, 0, 0, 0)
    rs = range(n_blocks)
    widest = max(max(2 * plan.n_cols("filter", r), plan.n_cols("res", r)
                     + plan.n_cols("skip", r), plan.n_cols("post1", r),
                     plan.n_cols("post2", r)) for r in rs)
    part_units = widest + 1  # and the int4 zero-point correction
    # the own columns' biases and scales of every layer (f32), the
    # post-net's biases, the embedding's own columns (bf16)
    aux_bytes = max(_r16(4 * (2 * n_layers * (2 * plan.n_cols("filter", r)
                                              + plan.n_cols("res", r)
                                              + plan.n_cols("skip", r))
                              + plan.n_cols("post1", r) + plan.n_cols("post2", r))
                         + 2 * n_quant * plan.n_cols("res", r)) for r in rs)
    # those, partial sums and scores ([64 rows, part_units] f32 each), misc,
    # and the block's own columns of x and skip (when B rows of them fit)
    act = aux_bytes + 2 * _PASS_ROWS * part_units * 4 + _MISC_SMEM + _OWN_SMEM
    post = max(plan.post_bytes(r) for r in rs)
    layer = max(plan.layer_bytes(r) for r in rs)
    room = smem_capacity - act - post
    if room < 0:
        raise ValueError(
            f"no block layout takes these widths: the post-net's share, the "
            f"biases and the partial sums need {act + post} bytes of shared "
            f"memory per block, the card has {smem_capacity}")
    resident = min(n_layers, room // layer) if layer else n_layers
    resident_bytes = max(plan.post_bytes(r) + resident * plan.layer_bytes(r)
                         for r in rs)
    stride = _r16(max(plan.post_bytes(r) + n_layers * plan.layer_bytes(r)
                      for r in rs))
    return dataclasses.replace(
        plan, resident_layers=resident, resident_bytes=resident_bytes,
        stride=stride, part_units=part_units, aux_bytes=aux_bytes,
        smem_bytes=resident_bytes + act)


def plan_for(cfg: WaveNetConfig, mode, n_sms: int, smem_capacity: int) -> SharePlan:
    return share_plan(cfg.n_res, cfg.n_dil, cfg.n_skp, cfg.n_post, cfg.n_quant,
                      cfg.n_lc_out + cfg.n_global_embed, len(cfg.dilations), mode,
                      n_sms, smem_capacity)


def _columns(w: torch.Tensor, col_bytes: int) -> torch.Tensor:
    """[..., K, N] -> [..., N, col_bytes] uint8: each column's K values
    contiguous, zero-padded."""
    cols = w.transpose(-1, -2).contiguous()
    k_bytes = cols.shape[-1] * cols.element_size()
    cols = cols.view(torch.uint8).reshape(*cols.shape[:-1], k_bytes)
    return torch.nn.functional.pad(cols, (0, col_bytes - k_bytes))


@torch.no_grad()
def pack_shares(packed, plan: SharePlan) -> torch.Tensor:
    """The layer and post-net weights as the blocks' shares: [n_blocks,
    stride] uint8, block r's row laid out as :class:`SharePlan` says.

    One gather of 64-byte units (every column's bytes are whole units):
    each row is a run of segments, each a block's columns of one matrix
    (contiguous in the source), then zeros to the stride."""
    if isinstance(packed, KernelParams):
        w_in, w_out = packed.w_in, packed.w_out
    elif isinstance(packed, Int8KernelParams):
        w_in, w_out = unpack_int8(packed.w_in_q), unpack_int8(packed.w_out_q)
    else:  # the raw nibble-pair bytes: byte k holds rows k and k + Kp/2
        w_in, w_out = unpack_int8(packed.w_in_p), unpack_int8(packed.w_out_p)
    cb, g, n_l = plan.col_bytes, plan.n_blocks, plan.n_layers
    # the source: the columns of post1, post2, every layer's w_in and w_out,
    # then one zero unit
    mats = [_columns(packed.post1_w, cb["post1"]), _columns(packed.post2_w, cb["post2"]),
            _columns(w_in, cb["filter"]), _columns(w_out, cb["res"])]
    src = torch.cat([m.flatten() for m in mats] + [w_in.new_zeros(64, dtype=torch.uint8)])
    base = [0]
    for m in mats:
        base.append(base[-1] + m.numel() // 64)
    dev = src.device

    def seg(name, mat, layer=None):
        # each block's first unit of its columns of mats[mat] (per layer:
        # [g, L]) and their count of units
        lo, hi = plan.cols(name, torch.arange(g, device=dev))
        units = cb[name] // 64
        n = (hi - lo) * units
        if layer is None:
            return base[mat] + lo * units, n
        return base[mat] + (layer * mats[mat].shape[-2] + lo[:, None]) * units, n[:, None]

    layer = torch.arange(n_l, device=dev)[None]
    parts = [seg("post1", 0), seg("post2", 1)]
    lay = [seg(name, 2 if name in ("filter", "gate") else 3, layer)
           for name in ("filter", "gate", "res", "skip")]
    # per layer filter, gate, res, skip: [g, L, 4] -> [g, 4 L]
    starts = torch.cat([torch.stack([s for s, _ in parts], 1),
                        torch.stack([s for s, _ in lay], 2).reshape(g, -1)], 1)
    lens = torch.cat([torch.stack([n for _, n in parts], 1),
                      torch.stack([n.expand(g, n_l) for _, n in lay], 2).reshape(g, -1)], 1)
    n_units = plan.stride // 64
    pad = n_units - lens.sum(1, keepdim=True)
    starts = torch.cat([starts, torch.full_like(pad, base[-1])], 1)
    lens = torch.cat([lens, pad], 1)
    step = torch.ones_like(lens)
    step[:, -1] = 0  # the zero unit, repeated
    end = lens.cumsum(1)
    pos = torch.arange(n_units, device=dev).expand(g, -1).contiguous()
    which = torch.searchsorted(end, pos, right=True)
    index = (starts.gather(1, which)
             + (pos - (end - lens).gather(1, which)) * step.gather(1, which))
    return src.view(-1, 64)[index].reshape(g, plan.stride)


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
def _device_caps(device_index: int) -> tuple[int, int]:
    """(SM count, shared memory a block may opt in to) of the card."""
    from ae_wavenet_tpu_torch.ops import _build

    lib = _build.load()
    n_sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.awt_fastgen_device(ctypes.byref(n_sms), ctypes.byref(smem))
    if rc != 0:
        raise _cuda_error(lib, rc, "the sampler's device query")
    return n_sms.value, smem.value


def device_plan(cfg: WaveNetConfig, quantized, device) -> SharePlan:
    """:func:`share_plan` for ``cfg`` on the CUDA ``device``."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return plan_for(cfg, _norm_wq(quantized), *_device_caps(index))


def generate_fused(packed, cfg: WaveNetConfig,
                   flat: torch.Tensor, prev_id: torch.Tensor, t0: int,
                   cond: torch.Tensor, seed: int, temperature: float = 1.0,
                   debug_logits: bool = False, quantized=False,
                   clocks: torch.Tensor | None = None):
    """T autoregressive steps -> (ids [B, T] int32, flat, last_id [B] int32
    [, logits [T, B, n_quant] f32]).

    flat [sum_d, B, n_res] bf16 (:func:`state_to_flat`) is the ring state,
    updated in place; t0 is its phase; cond [B, n_cond, T] already carries
    the speaker embedding (``fastgen.with_gc``).  ``quantized`` (False,
    True/'int8' or 'int4') selects the kernel and the type of ``packed``.
    On CUDA tensors this launches ``csrc/fastgen.cu`` on the current stream
    (one cooperative grid: it raises when the card cannot hold every block
    at once); on CPU tensors it runs :func:`generate_fused_reference`.
    Instrumentation: ``clocks``, an int64 CUDA tensor of 3, gets block 0's
    clock cycles over the launch, inside the grid barriers and in the
    layers' GEMMs."""
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
    from ae_wavenet_tpu_torch.ops import _build

    lib = _build.load()
    batch, n_cond, t_len = cond.shape
    dev = flat.device
    plan = device_plan(cfg, mode, dev)
    share = pack_shares(packed, plan)
    g, f32, bf16, i32 = plan.n_blocks, torch.float32, torch.bfloat16, torch.int32
    cond_tm = cond.permute(2, 0, 1).to(bf16).contiguous()
    prev = prev_id.to(i32).contiguous()
    ids = torch.empty(batch, t_len, dtype=i32, device=dev)
    last = torch.empty(batch, dtype=i32, device=dev)
    logits = (torch.empty(t_len, batch, cfg.n_quant, device=dev)
              if debug_logits else None)
    # scratch: the barrier's arrival count (zeroed), the exchanged
    # activations, the argmax candidates, each block's x and skip columns
    # and its published maxima (quantized)
    scratch = [torch.zeros(2, dtype=torch.int64, device=dev),
               torch.empty(batch, 2 * cfg.n_res, dtype=bf16, device=dev),
               torch.empty(batch, cfg.n_dil, dtype=bf16 if mode is None else f32,
                           device=dev),
               torch.empty(batch, cfg.n_skp, dtype=bf16, device=dev),
               torch.empty(batch, cfg.n_post, dtype=bf16, device=dev),
               torch.empty(batch, g, dtype=f32, device=dev),
               torch.empty(batch, g, dtype=i32, device=dev),
               torch.empty(batch, cfg.n_res, dtype=f32, device=dev),
               torch.empty(batch, cfg.n_skp, dtype=f32, device=dev),
               torch.empty(g, dtype=f32, device=dev),
               torch.empty(g, dtype=f32, device=dev)]
    scales = ((packed.w_in_s, packed.w_out_s) if mode is not None else (None, None))
    ptrs = [share, scales[0], packed.b_in, scales[1], packed.b_out, packed.embed,
            packed.post1_b, packed.post2_b, cond_tm, prev, flat, ids, last, logits,
            *scratch, clocks]
    ptrs_c = (ctypes.c_uint64 * len(ptrs))(
        *(0 if v is None else v.data_ptr() for v in ptrs))
    offs, _ = flat_buffers(cfg)
    cb = plan.col_bytes
    greedy = temperature == 0.0
    ints = [batch, t_len, len(offs), cfg.n_res, cfg.n_dil, cfg.n_skp, cfg.n_post,
            cfg.n_quant, n_cond, int(t0), seed, int(greedy), g,
            plan.resident_layers, plan.stride, plan.part_units, plan.smem_bytes, cb["filter"], cb["res"], cb["post1"], cb["post2"],
            plan.resident_bytes, plan.aux_bytes, *offs, *cfg.dilations]
    ints_c = (ctypes.c_int * len(ints))(*ints)
    max_blocks = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.awt_fastgen(_MODES[mode], ptrs_c, ints_c,
                             0.0 if greedy else 1.0 / temperature,
                             ctypes.byref(max_blocks), stream)
    if rc != 0:
        if 0 <= max_blocks.value < g:
            raise RuntimeError(
                f"fastgen {mode or 'bf16'}: the cooperative grid needs {g} blocks "
                f"of {plan.smem_bytes} bytes of shared memory resident at once; "
                f"the card holds {max_blocks.value} (is another kernel running?)")
        raise _cuda_error(lib, rc, f"fastgen {mode or 'bf16'} kernel launch")
    if mode is None:
        generate_fused.launches += 1
    elif mode == "int8":
        generate_fused.launches_int8 += 1
    else:
        generate_fused.launches_int4 += 1
    out = (ids, flat, last)
    return out + (logits,) if debug_logits else out


_MODES = {None: 0, "int8": 1, "int4": 2}  # csrc/fastgen.cu Mode
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
