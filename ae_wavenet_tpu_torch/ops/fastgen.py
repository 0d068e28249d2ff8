"""Fast autoregressive WaveNet state: O(1)/sample ring-buffer queues.

Counterpart of ``ae_wavenet_tpu.ops.fastgen`` (Fast WaveNet,
arXiv:1611.09482): each dilated layer keeps a queue of its last
``dilation`` input activations, so one new sample costs one matmul pass
through the stack.  This module holds the state, the plain f32 cell,
:func:`prime`, which warms the queues on real context, and the eager f32
samplers :func:`generate` (the quality eval's rollout and the fused
sampler's oracle) and :func:`generate_naive` (the O(receptive field) per
sample oracle).  The fused sampler runs in ``ops/fastgen_cuda.py``.

State layout per layer l: buf [B, n_res, d_l] f32 holding the layer's input
activation at positions t-1 .. t-d_l (circular, index t mod d_l), as in the
reference.  Unlike the reference's pure functions, the cell and
:func:`prime` update the buffers in place: a flagship batch of 64 holds
200 MB of them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ae_wavenet_tpu_torch.models.wavenet import WaveNet
from ae_wavenet_tpu_torch.utils.config import WaveNetConfig


class GenState(NamedTuple):
    bufs: Tuple[torch.Tensor, ...]  # per layer [B, n_res, d_l] f32
    prev_id: torch.Tensor           # [B] last emitted/consumed sample id
    t: int                          # global time (buffer phase)


def init_state(cfg: WaveNetConfig, batch: int, fill_id: int = 128,
               device=None) -> GenState:
    """Zero-filled queues; ``fill_id`` (mu-law silence) seeds the AR input."""
    bufs = tuple(torch.zeros(batch, cfg.n_res, d, device=device)
                 for d in cfg.dilations)
    return GenState(bufs, torch.full((batch,), fill_id, dtype=torch.long,
                                     device=device), 0)


def pack_params(wavenet: WaveNet, cfg: WaveNetConfig) -> dict:
    """Per layer, the five taps as two GEMMs, stored input-major:
        y     = [x_prev | x_cur | cond_t] @ w_in + b_in
        [r|s] = h @ w_out + b_out
    """
    w_in, b_in, w_out, b_out = [], [], [], []
    for p in wavenet.layers:
        w_in.append(torch.cat([p.w_prev["w"], p.w_cur["w"], p.w_cond["w"]], 1).t())
        b_in.append(p.w_prev["b"] + p.w_cur["b"] + p.w_cond["b"])
        w_out.append(torch.cat([p.w_res["w"], p.w_skip["w"]], 0).t())
        b_out.append(torch.cat([p.w_res["b"], p.w_skip["b"]]))
    return {
        "embed": wavenet.embed, "w_in": w_in, "b_in": b_in,
        "w_out": w_out, "b_out": b_out,
        "post1_w": wavenet.post1["w"].t(), "post1_b": wavenet.post1["b"],
        "post2_w": wavenet.post2["w"].t(), "post2_b": wavenet.post2["b"],
    }


def _cell(packed: dict, cfg: WaveNetConfig, state: GenState,
          x_id: torch.Tensor, cond_t: torch.Tensor) -> torch.Tensor:
    """One f32 AR step: consume sample ids x_id [B] and the cond column
    [B, n_cond]; writes the queues in place and returns logits [B, n_quant]."""
    x = packed["embed"][x_id]  # [B, n_res]
    skip = None
    for i, d in enumerate(cfg.dilations):
        buf = state.bufs[i]
        ptr = state.t % d
        x_prev = buf[:, :, ptr].clone()  # read before the write below
        buf[:, :, ptr] = x
        xin = torch.cat([x_prev, x, cond_t], 1)
        y = torch.addmm(packed["b_in"][i], xin, packed["w_in"][i])
        f, g = y.chunk(2, 1)
        h = torch.tanh(f) * torch.sigmoid(g)
        rs = torch.addmm(packed["b_out"][i], h, packed["w_out"][i])
        res, s = rs[:, : cfg.n_res], rs[:, cfg.n_res :]
        skip = s if skip is None else skip + s
        x = x + res
    h = torch.relu(skip)
    h = torch.relu(torch.addmm(packed["post1_b"], h, packed["post1_w"]))
    return torch.addmm(packed["post2_b"], h, packed["post2_w"])


def with_gc(wavenet: WaveNet, cfg: WaveNetConfig, cond: torch.Tensor,
            gc_ids: torch.Tensor | None) -> torch.Tensor:
    """Append the (time-constant) speaker embedding to the cond channels:
    [B, n_lc_out, T] -> [B, n_lc_out + n_global_embed, T]."""
    b, _, t = cond.shape
    if gc_ids is None:
        g = cond.new_zeros(b, cfg.n_global_embed)
    else:
        g = wavenet.gc_embed[gc_ids]
    g = g[:, :, None].expand(b, cfg.n_global_embed, t).to(cond.dtype)
    return torch.cat([cond, g], 1)


@torch.no_grad()
def prime(wavenet: WaveNet, cfg: WaveNetConfig, state: GenState,
          ids: torch.Tensor, cond: torch.Tensor,
          gc_ids: torch.Tensor | None = None) -> GenState:
    """Warm the queues with known samples (teacher context), in place.

    ids: [B, T0] real samples at positions [t, t+T0).  The first T0-1 are
    consumed through the stack (their logits discarded); the LAST one is
    left as ``prev_id`` so the next generation step consumes it.
    cond: [B, n_lc_out, >= T0-1] columns for the consumed positions.
    """
    t0 = ids.shape[-1]
    cond_tm = with_gc(wavenet, cfg, cond[..., : t0 - 1], gc_ids).permute(2, 0, 1)
    packed = pack_params(wavenet, cfg)
    st = state
    for j in range(t0 - 1):
        _cell(packed, cfg, st, ids[:, j], cond_tm[j])
        st = GenState(st.bufs, ids[:, j], st.t + 1)
    return GenState(st.bufs, ids[:, -1], st.t)


def _draw(logits: torch.Tensor, temperature: float,
          generator: torch.Generator | None) -> torch.Tensor:
    """Next ids [B] from logits [B, Q]: argmax at temperature 0, else a
    categorical draw from softmax(logits / temperature) by Gumbel-max, the
    uniforms taken from ``generator`` on its own device."""
    if temperature == 0.0:
        return torch.argmax(logits, -1)
    u_dev = logits.device if generator is None else generator.device
    u = torch.rand(logits.shape, generator=generator, device=u_dev).to(logits.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits / temperature + g, -1)


@torch.no_grad()
def generate(wavenet: WaveNet, cfg: WaveNetConfig, state: GenState,
             cond: torch.Tensor, generator: torch.Generator | None = None,
             gc_ids: torch.Tensor | None = None, n_steps: int | None = None,
             temperature: float = 1.0, return_logits: bool = False):
    """Sample ``n_steps`` (default: the cond length) mu-law ids with the f32
    cell, one eager step per sample.

    cond: [B, n_lc_out, T]; column p conditions the step that consumes the
    sample at position p (the training lattice).  The queues of ``state``
    are updated in place.  Returns (ids [B, T] int32, final state) and, with
    ``return_logits``, the per-step logits [B, n_quant, T]: the free-running
    predictive distributions that eval/quality scores ground truth under."""
    t_len = cond.shape[-1] if n_steps is None else n_steps
    if t_len > cond.shape[-1]:
        raise ValueError(f"n_steps={t_len} exceeds the {cond.shape[-1]} "
                         "conditioning columns provided")
    cond_tm = with_gc(wavenet, cfg, cond[..., :t_len], gc_ids).permute(2, 0, 1)
    packed = pack_params(wavenet, cfg)
    st, ids, all_logits = state, [], []
    for j in range(t_len):
        logits = _cell(packed, cfg, st, st.prev_id, cond_tm[j])
        nxt = _draw(logits, temperature, generator)
        st = GenState(st.bufs, nxt, st.t + 1)
        ids.append(nxt.to(torch.int32))
        if return_logits:
            all_logits.append(logits)
    out = (torch.stack(ids, 1), st)
    return out + (torch.stack(all_logits, 2),) if return_logits else out


@torch.no_grad()
def generate_naive(wavenet: WaveNet, cfg: WaveNetConfig, ctx_ids: torch.Tensor,
                   cond: torch.Tensor, generator: torch.Generator | None = None,
                   gc_ids: torch.Tensor | None = None, n_steps: int = 16,
                   temperature: float = 1.0) -> torch.Tensor:
    """O(receptive field) per sample: re-runs the teacher-forcing stack for
    every emitted sample.  A test oracle only.

    ctx_ids: [B, rf + 1], the window of AR inputs for which ``apply`` emits
    exactly one logit column; cond: [B, n_lc_out, rf + 1 + n_steps] aligned
    with the consumed inputs.  Returns ids [B, n_steps] int32."""
    from ae_wavenet_tpu_torch.models import wavenet as wn

    rf = wn.receptive_field(cfg)
    if ctx_ids.shape[-1] != rf + 1:
        raise ValueError(f"ctx_ids has {ctx_ids.shape[-1]} samples, need rf + 1 = "
                         f"{rf + 1}")
    ids, out = ctx_ids, []
    for j in range(n_steps):
        logits = wn.apply(wavenet, cfg, ids[..., -(rf + 1):],
                          cond[..., j : j + rf + 1], gc_ids)
        nxt = _draw(logits[..., -1], temperature, generator)
        out.append(nxt.to(torch.int32))
        ids = torch.cat([ids, nxt[:, None].to(ids.dtype)], -1)
    return torch.stack(out, 1)
