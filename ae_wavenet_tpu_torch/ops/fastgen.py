"""Fast autoregressive WaveNet state: O(1)/sample ring-buffer queues.

Counterpart of ``ae_wavenet_tpu.ops.fastgen`` (Fast WaveNet,
arXiv:1611.09482): each dilated layer keeps a queue of its last
``dilation`` input activations, so one new sample costs one matmul pass
through the stack.  This module holds the state, the plain f32 cell and
:func:`prime`, which warms the queues on real context.  Sampling runs in
``ops/fastgen_cuda.py``.

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
