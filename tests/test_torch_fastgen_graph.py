"""The port's f32 cell as one step that reads every input from tensors
(``ops/fastgen._cell``, the step that prime and generate capture as a CUDA
graph on the card), on the CPU: against the JAX package's jitted ``prime``
and ``generate``, against the per-layer eager loop it replaces (kept here
as the oracle, bit for bit), and its up-front draws against the per-step
stream of the same generator.  The graph itself runs only on the card:
tests/test_torch_cuda.py and ``chip_smoke.py`` phase 5."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ae_wavenet_tpu.models import wavenet as jwn
from ae_wavenet_tpu.ops import fastgen as jfg
from ae_wavenet_tpu.training.torch_compat import flatten_named
from ae_wavenet_tpu.utils.config import WaveNetConfig
from ae_wavenet_tpu_torch.models import wavenet as twn
from ae_wavenet_tpu_torch.ops import fastgen as tfg
from ae_wavenet_tpu_torch.utils import config as tcfg

CFG = WaveNetConfig(
    n_blocks=2, n_block_layers=3, n_res=16, n_dil=16, n_skp=16, n_post=16,
    n_lc_in=8, n_lc_out=12, n_speakers=5, n_global_embed=4,
)
TCFG = tcfg.WaveNetConfig(**dataclasses.asdict(CFG))
RF = sum(CFG.dilations)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny widths gain nothing from more, and the
    suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=0, batch=3, n=24):
    params = jwn.init(jax.random.PRNGKey(seed), CFG)
    port = twn.WaveNet(TCFG)
    port.load_state_dict({k: torch.tensor(v)
                          for k, v in flatten_named(params).items()})
    with torch.no_grad():
        port.post2["w"].mul_(20.0)  # informative logits: draws that depend on them
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (batch, RF + 1 + n)).astype(np.int32)
    cond = (rng.normal(size=(batch, CFG.n_lc_out, RF + 1 + n)) * 0.3).astype(np.float32)
    spk = rng.integers(0, 5, (batch,)).astype(np.int32)
    return params, port, ids, cond, spk


def _copy(state):
    return tfg.GenState(tuple(b.clone() for b in state.bufs), state.prev_id.clone(),
                        state.t)


# ------------------------------------------- the loop the step replaces

def _old_cell(packed, cfg, state, x_id, cond_t, dtype=torch.float32):
    """The per-layer eager cell as it was: a clone and an indexed write of
    each layer's queue at the host's ``state.t``."""
    rnd = tfg._rounder(dtype)
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


def _old_prime(wavenet, cfg, state, ids, cond, gc_ids=None):
    t0 = ids.shape[-1]
    cond_tm = tfg.with_gc(wavenet, cfg, cond[..., : t0 - 1], gc_ids).permute(2, 0, 1)
    packed = tfg.pack_params(wavenet, cfg)
    st = state
    for j in range(t0 - 1):
        _old_cell(packed, cfg, st, ids[:, j], cond_tm[j])
        st = tfg.GenState(st.bufs, ids[:, j], st.t + 1)
    return tfg.GenState(st.bufs, ids[:, -1], st.t)


def _old_generate(wavenet, cfg, state, cond, generator=None, gc_ids=None,
                  temperature=1.0, dtype=torch.float32):
    """-> (ids [B, T] int32, state, logits [B, Q, T]), one draw a step."""
    t_len = cond.shape[-1]
    cond_tm = tfg.with_gc(wavenet, cfg, cond, gc_ids).permute(2, 0, 1)
    packed = tfg.pack_params(wavenet, cfg, dtype)
    st, ids, lgs = state, [], []
    for j in range(t_len):
        logits = _old_cell(packed, cfg, st, st.prev_id, cond_tm[j], dtype)
        nxt = tfg._draw(logits, temperature, generator)
        st = tfg.GenState(st.bufs, nxt, st.t + 1)
        ids.append(nxt.to(torch.int32))
        lgs.append(logits)
    return torch.stack(ids, 1), st, torch.stack(lgs, 2)


def _primed_both(seed=0, batch=3, n=24, extra=0):
    """The same weights and context primed by the step and by the old
    loop.  ``extra`` more context samples take the ring past one wrap."""
    params, port, ids, cond, spk = _setup(seed, batch, n + extra)
    ctx = torch.from_numpy(ids[:, : RF + 1 + extra]).long()
    cond_t, spk_t = torch.from_numpy(cond), torch.from_numpy(spk).long()
    new = tfg.prime(port, TCFG, tfg.init_state(TCFG, batch), ctx, cond_t, spk_t)
    old = _old_prime(port, TCFG, tfg.init_state(TCFG, batch), ctx, cond_t, spk_t)
    return params, port, ids, cond, spk, new, old


def _same_state(a, b):
    assert a.t == b.t
    assert torch.equal(a.prev_id, b.prev_id)
    for x, y in zip(a.bufs, b.bufs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("extra", [0, 9])
def test_prime_is_the_old_loop_bit_for_bit(extra):
    before = (tfg.prime.eager_steps, tfg.prime.graph_replays)
    *_, new, old = _primed_both(seed=3, extra=extra)
    _same_state(new, old)
    assert new.t == RF + extra
    # on the CPU the step runs in the Python loop: one step a consumed sample
    assert (tfg.prime.eager_steps - before[0],
            tfg.prime.graph_replays - before[1]) == (RF + extra, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_is_the_old_loop_bit_for_bit(dtype, temperature):
    """ids, logits, queues and last ids; at temperature 1 both draw from
    one CPU generator (the old loop a step at a time)."""
    _, port, _, cond, spk, new, old = _primed_both(seed=4)
    gen_cond = torch.from_numpy(cond[..., RF : RF + 24])
    spk_t = torch.from_numpy(spk).long()
    before = (tfg.generate.eager_steps, tfg.generate.graph_replays)
    ids, st, lg = tfg.generate(port, TCFG, new, gen_cond,
                               torch.Generator().manual_seed(5), gc_ids=spk_t,
                               temperature=temperature, return_logits=True,
                               dtype=dtype)
    want_ids, want_st, want_lg = _old_generate(
        port, TCFG, old, gen_cond, torch.Generator().manual_seed(5), spk_t,
        temperature, dtype)
    assert ids.dtype == torch.int32 and torch.equal(ids, want_ids)
    assert torch.equal(lg, want_lg)
    _same_state(st, want_st)
    assert (tfg.generate.eager_steps - before[0],
            tfg.generate.graph_replays - before[1]) == (24, 0)
    if temperature:
        assert len(set(ids.flatten().tolist())) > 8  # the draws took effect


def test_eager_flag_is_the_same_loop_on_the_cpu():
    """``eager=True`` (the graph's plain version on the card) runs the same
    loop here."""
    _, port, _, cond, spk, new, _ = _primed_both(seed=6)
    gen_cond = torch.from_numpy(cond[..., RF : RF + 12])
    runs = [tfg.generate(port, TCFG, _copy(new), gen_cond,
                         torch.Generator().manual_seed(1), temperature=1.0,
                         return_logits=True, eager=eager) for eager in (False, True)]
    (a, sa, la), (b, sb, lb) = runs
    assert torch.equal(a, b) and torch.equal(la, lb)
    _same_state(sa, sb)


# ------------------------------------------------------- against JAX

def test_chained_primes_match_jax_prime():
    """Two primes in a row (the second starting at the first's phase t)
    give the queues of JAX's one prime over the whole context, past one
    wrap of every ring."""
    n_ctx = RF + 1 + 11
    params, port, ids, cond, spk = _setup(seed=7, batch=2)
    want = jfg.prime(params, CFG, jfg.init_state(CFG, 2), jnp.asarray(ids[:, :n_ctx]),
                     jnp.asarray(cond), jnp.asarray(spk))
    spk_t, cond_t = torch.from_numpy(spk).long(), torch.from_numpy(cond)
    ids_t = torch.from_numpy(ids).long()
    cut = 9
    st = tfg.prime(port, TCFG, tfg.init_state(TCFG, 2), ids_t[:, :cut], cond_t, spk_t)
    st = tfg.prime(port, TCFG, st, ids_t[:, cut - 1 : n_ctx], cond_t[..., cut - 1 :],
                   spk_t)
    assert st.t == int(want.t) == n_ctx - 1
    np.testing.assert_array_equal(st.prev_id.numpy(), np.asarray(want.prev_id))
    for a, b in zip(want.bufs, st.bufs):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)


def test_generate_matches_jax_greedy_without_speakers():
    """Temperature 0 from a primed state without speaker ids: the ids over
    the inclusive greedy prefix (every row), the logits there within 1e-4
    (tests/test_torch_fastgen.py's tolerance)."""
    n = 20
    params, port, ids, cond, _ = _setup(seed=8, n=n)
    ctx, cond_t = ids[:, : RF + 1], torch.from_numpy(cond)
    jst = jfg.prime(params, CFG, jfg.init_state(CFG, 3), jnp.asarray(ctx),
                    jnp.asarray(cond))
    tst = tfg.prime(port, TCFG, tfg.init_state(TCFG, 3), torch.from_numpy(ctx).long(),
                    cond_t)
    gen = cond[..., RF : RF + n]
    want_ids, _, want_lg = jfg.generate(
        {**params, "post2": {k: v * 20.0 if k == "w" else v
                             for k, v in params["post2"].items()}},
        CFG, jst, jnp.asarray(gen), jax.random.PRNGKey(0), temperature=0.0,
        return_logits=True)
    got_ids, _, got_lg = tfg.generate(port, TCFG, tst, torch.from_numpy(gen),
                                      temperature=0.0, return_logits=True)
    want_ids, want_lg = np.asarray(want_ids), np.asarray(want_lg)
    for r in range(3):
        diff = np.nonzero(got_ids[r].numpy() != want_ids[r])[0]
        k = int(diff[0]) + 1 if len(diff) else n  # inclusive prefix
        assert k >= 8, (r, k)
        np.testing.assert_allclose(got_lg[r, :, :k].numpy(), want_lg[r, :, :k], atol=1e-4)


# ---------------------------------------------------------------- draws

@pytest.mark.parametrize("chunk", [1, 5, 7, 40])
def test_up_front_draws_are_the_per_step_stream(chunk):
    """Chunks of steps from one CPU generator give the numbers of the same
    steps drawn one at a time (as ``_draw`` took them)."""
    shape, n = (3, 256), 23
    got = torch.cat(list(tfg._draws(torch.Generator().manual_seed(9), n, chunk,
                                    shape, "cpu")))
    g = torch.Generator().manual_seed(9)
    want = torch.stack([torch.rand(shape, generator=g) for _ in range(n)])
    assert torch.equal(got, want)


def test_chunked_draws_give_the_same_rollout(monkeypatch):
    """A rollout whose draws exceed DRAW_CHUNK_BYTES draws them in chunks
    of steps: the ids and logits of one chunk."""
    _, port, _, cond, spk, new, _ = _primed_both(seed=10)
    gen_cond = torch.from_numpy(cond[..., RF : RF + 24])

    def run():
        return tfg.generate(port, TCFG, _copy(new), gen_cond,
                            torch.Generator().manual_seed(2), temperature=1.0,
                            return_logits=True)

    whole = run()
    monkeypatch.setattr(tfg, "DRAW_CHUNK_BYTES", 5 * 3 * CFG.n_quant * 4)  # 5 steps
    chunked = run()
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[2], chunked[2])
