"""Fused autoregressive sampler: one CUDA launch generates T samples.

Replaces the TPU kernel ``ae_wavenet_tpu/ops/fastgen_pallas.py``
``generate_fused`` (its bf16 branch) with ``csrc/fastgen.cu``, a kernel
written by hand for Hopper (``sm_90a``).  Each step embeds the previous id,
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
plain version.  Each counts its runs in ``.launches``.
"""

from __future__ import annotations

import ctypes
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

@torch.no_grad()
def generate_fused_reference(packed: KernelParams, cfg: WaveNetConfig,
                             flat: torch.Tensor, prev_id: torch.Tensor,
                             t0: int, cond: torch.Tensor, seed: int,
                             temperature: float = 1.0,
                             debug_logits: bool = False):
    """Plain PyTorch version of the kernel's contract (csrc/fastgen.cu).

    flat [sum_d, B, n_res] bf16 is updated in place; cond [B, n_cond, T]
    already carries the speaker embedding.  Returns (ids [B, T] int32,
    flat, last_id [B] int32) and, with ``debug_logits``, logits
    [T, B, n_quant] f32."""
    generate_fused_reference.launches += 1
    bf16 = torch.bfloat16
    batch, _, t_len = cond.shape
    offs, _ = flat_buffers(cfg)
    n_res, n_dil = cfg.n_res, cfg.n_dil
    w_in, w_out = packed.w_in.float(), packed.w_out.float()
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
            y = torch.addmm(packed.b_in[l], xin, w_in[l])
            h = torch.tanh(y[:, :n_dil]) * torch.sigmoid(y[:, n_dil:])
            rs = torch.addmm(packed.b_out[l], h.to(bf16).float(), w_out[l])
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


def _check_cuda_args(packed: KernelParams, cfg: WaveNetConfig,
                     flat: torch.Tensor, prev_id: torch.Tensor,
                     cond: torch.Tensor) -> None:
    dev = flat.device
    n_layers = len(cfg.dilations)
    n_cond = cfg.n_lc_out + cfg.n_global_embed
    batch = cond.shape[0]
    want = {
        "w_in": ((n_layers, 2 * cfg.n_res + n_cond, 2 * cfg.n_dil), torch.bfloat16),
        "b_in": ((n_layers, 2 * cfg.n_dil), torch.float32),
        "w_out": ((n_layers, cfg.n_dil, cfg.n_res + cfg.n_skp), torch.bfloat16),
        "b_out": ((n_layers, cfg.n_res + cfg.n_skp), torch.float32),
        "embed": ((cfg.n_quant, cfg.n_res), torch.bfloat16),
        "post1_w": ((cfg.n_skp, cfg.n_post), torch.bfloat16),
        "post1_b": ((cfg.n_post,), torch.float32),
        "post2_w": ((cfg.n_post, cfg.n_quant), torch.bfloat16),
        "post2_b": ((cfg.n_quant,), torch.float32),
    }
    tensors = dict(packed._asdict(), flat=flat, prev_id=prev_id, cond=cond)
    want.update(flat=((sum(cfg.dilations), batch, cfg.n_res), torch.bfloat16),
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


def generate_fused(packed: KernelParams, cfg: WaveNetConfig,
                   flat: torch.Tensor, prev_id: torch.Tensor, t0: int,
                   cond: torch.Tensor, seed: int, temperature: float = 1.0,
                   debug_logits: bool = False):
    """T autoregressive steps -> (ids [B, T] int32, flat, last_id [B] int32
    [, logits [T, B, n_quant] f32]).

    flat [sum_d, B, n_res] bf16 (:func:`state_to_flat`) is the ring state,
    updated in place; t0 is its phase; cond [B, n_cond, T] already carries
    the speaker embedding (``fastgen.with_gc``).  On CUDA tensors this
    launches ``csrc/fastgen.cu`` on the current stream; on CPU tensors it
    runs :func:`generate_fused_reference`."""
    if t0 < 0 or cond.shape[-1] < 1:
        raise ValueError(f"need t0 >= 0 and at least one step, got t0={t0}, "
                         f"{cond.shape[-1]} steps")
    if not 0.0 <= temperature < math.inf:
        raise ValueError(f"temperature must be finite and >= 0, got {temperature}")
    seed = int(seed) & 0x7FFFFFFF  # the kernel takes a 31-bit seed
    if flat.device.type == "cpu":
        return generate_fused_reference(packed, cfg, flat, prev_id, t0, cond,
                                        seed, temperature, debug_logits)
    if flat.device.type != "cuda":
        raise ValueError(f"no sampler for device {flat.device}")
    _check_cuda_args(packed, cfg, flat, prev_id, cond)
    from ae_wavenet_tpu_torch.ops import _build

    lib = _build.load()
    batch, n_cond, t_len = cond.shape
    dev = flat.device
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.awt_fastgen_bf16(
            *(v.data_ptr() for v in packed), cond_tm.data_ptr(),
            prev.data_ptr(), flat.data_ptr(), ids.data_ptr(), last.data_ptr(),
            logits.data_ptr() if debug_logits else None, offs_c, dils_c,
            batch, t_len, n_layers, cfg.n_res, cfg.n_dil, cfg.n_skp,
            cfg.n_post, cfg.n_quant, n_cond, int(t0), seed,
            0.0 if greedy else 1.0 / temperature, int(greedy), stream)
    if rc != 0:
        raise RuntimeError("fastgen kernel launch failed: CUDA error "
                           f"{rc} ({lib.awt_cuda_error_string(rc).decode()})")
    generate_fused.launches += 1
    out = (ids, flat, last)
    return out + (logits,) if debug_logits else out


generate_fused.launches = 0


@torch.no_grad()
def generate_auto(wavenet: WaveNet, cfg: WaveNetConfig, state: GenState,
                  cond: torch.Tensor, generator: torch.Generator | None = None,
                  gc_ids: torch.Tensor | None = None, temperature: float = 1.0):
    """Sample cond.shape[-1] mu-law ids from a primed state with the fused
    sampler (bf16 weights; the int8/int4 branches are not ported yet).
    cond: [B, n_lc_out, T] without the speaker embedding.  The kernel's seed
    is drawn from ``generator``.  Returns (ids [B, T] int32, new GenState)."""
    packed = pack_for_kernel(wavenet, cfg)
    flat = state_to_flat(state, cfg)
    cond_gc = fastgen.with_gc(wavenet, cfg, cond, gc_ids)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    ids, flat, last = generate_fused(packed, cfg, flat, state.prev_id, state.t,
                                     cond_gc, seed, temperature)
    return ids, flat_to_state(flat, last, state.t + cond.shape[-1], cfg)
