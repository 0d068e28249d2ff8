"""The f32 cell's per-layer eager loop as it stood before the port's step
program and one-pass prime (``ops/fastgen``): one step a consumed sample,
a clone and an indexed write of each layer's queue at the host's
``state.t``.  The oracle that tests/test_torch_fastgen_graph.py (on the CPU)
and tests/test_torch_cuda.py (on the card) hold prime and the f32 rollout
to; it imports no jax."""

import copy

import torch

from ae_wavenet_tpu_torch.ops import fastgen as tfg


def old_cell(packed, cfg, state, x_id, cond_t, dtype=torch.float32):
    """One AR step -> logits [B, n_out]; writes every queue at slot
    state.t mod d_l.  x_id: mu-law ids, or samples where ``packed`` holds
    a mixture output's input map."""
    rnd = tfg._rounder(dtype)
    if "in0_w" in packed:
        x = x_id[:, None] * packed["in0_w"] + packed["in0_b"]
    else:
        x = packed["embed"][x_id]
    cond_t = rnd(cond_t)
    skip = None
    for i, d in enumerate(cfg.dilations):
        buf = state.bufs[i]
        ptr = state.t % d
        x_prev = buf[:, :, ptr].clone()
        buf[:, :, ptr] = x
        xin = torch.cat([rnd(x_prev), rnd(x), cond_t], 1)
        y = torch.addmm(packed["b_in"][i], xin, packed["w_in"][i])
        f, g = y.chunk(2, 1)
        h = rnd(torch.tanh(f) * torch.sigmoid(g))
        rs = torch.addmm(packed["b_out"][i], h, packed["w_out"][i])
        res, s = rs[:, : cfg.n_res], rs[:, cfg.n_res :]
        skip = s if skip is None else skip + s
        x = x + res
    h = rnd(torch.relu(skip))
    h = rnd(torch.relu(torch.addmm(packed["post1_b"], h, packed["post1_w"])))
    return torch.addmm(packed["post2_b"], h, packed["post2_w"])


@torch.no_grad()
def old_prime(wavenet, cfg, state, ids, cond, gc_ids=None):
    """:func:`ops.fastgen.prime`'s contract, one step a consumed sample."""
    t0 = ids.shape[-1]
    cond_tm = tfg.with_gc(wavenet, cfg, cond[..., : t0 - 1], gc_ids).permute(2, 0, 1)
    packed = tfg.pack_params(wavenet, cfg)
    st = state
    for j in range(t0 - 1):
        old_cell(packed, cfg, st, ids[:, j], cond_tm[j])
        st = tfg.GenState(st.bufs, ids[:, j], st.t + 1)
    return tfg.GenState(st.bufs, ids[:, -1], st.t)


@torch.no_grad()
def old_generate(wavenet, cfg, state, cond, generator=None, gc_ids=None,
                 temperature=1.0, dtype=torch.float32):
    """-> (ids [B, T] int32, state, logits [B, Q, T]), one draw a step."""
    t_len = cond.shape[-1]
    cond_tm = tfg.with_gc(wavenet, cfg, cond, gc_ids).permute(2, 0, 1)
    packed = tfg.pack_params(wavenet, cfg, dtype)
    st, ids, lgs = state, [], []
    for j in range(t_len):
        logits = old_cell(packed, cfg, st, st.prev_id, cond_tm[j], dtype)
        nxt = tfg._draw(logits, temperature, generator)
        st = tfg.GenState(st.bufs, nxt, st.t + 1)
        ids.append(nxt.to(torch.int32))
        lgs.append(logits)
    return torch.stack(ids, 1), st, torch.stack(lgs, 2)


def exact_prime(wavenet, cfg, ids, cond, gc_ids=None):
    """:func:`old_prime` in float64 from zero queues: the rings that every
    f32 reduction order approximates."""
    st = tfg.init_state(cfg, ids.shape[0], device=ids.device)
    st = tfg.GenState(tuple(b.double() for b in st.bufs), st.prev_id, st.t)
    return old_prime(copy.deepcopy(wavenet).double(), cfg, st, ids, cond.double(), gc_ids)

