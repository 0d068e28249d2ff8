"""The port's one-pass prime and its f32 cell as one step that reads every
input from tensors (``ops/fastgen._cell``, the step that generate captures
as a CUDA graph on the card), on the CPU: against the JAX package's jitted
``prime`` and ``generate``, against the per-layer eager loop they replace
(``tests/fastgen_oracle.py``: the rollout bit for bit, prime within f32
reduction order), and the rollout's up-front draws against the per-step
stream of the same generator.  The graph itself runs only on the card:
tests/test_torch_cuda.py and ``chip_smoke.py`` phase 5."""

import dataclasses

import fastgen_oracle as oracle
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


# ------------------------------------------- the loop the pass and step replace

def _primed_both(seed=0, batch=3, n=24, extra=0):
    """The same weights and context primed by the pass and by the old
    loop.  ``extra`` more context samples take the ring past one wrap."""
    params, port, ids, cond, spk = _setup(seed, batch, n + extra)
    ctx = torch.from_numpy(ids[:, : RF + 1 + extra]).long()
    cond_t, spk_t = torch.from_numpy(cond), torch.from_numpy(spk).long()
    new = tfg.prime(port, TCFG, tfg.init_state(TCFG, batch), ctx, cond_t, spk_t)
    old = oracle.old_prime(port, TCFG, tfg.init_state(TCFG, batch), ctx, cond_t, spk_t)
    return params, port, ids, cond, spk, new, old


def _same_state(a, b):
    assert a.t == b.t
    assert torch.equal(a.prev_id, b.prev_id)
    for x, y in zip(a.bufs, b.bufs):
        assert torch.equal(x, y)


def _close_state(a, b):
    """The same phase and last ids, the queues within f32 reduction order
    (test_chained_primes_match_jax_prime's tolerance)."""
    assert a.t == b.t
    assert torch.equal(a.prev_id, b.prev_id)
    for x, y in zip(a.bufs, b.bufs):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("extra", [0, 9])
def test_prime_is_the_old_loop_bit_for_bit(extra):
    """The one pass against the old step loop: the queues agree within f32
    reduction order (GEMMs of T x B rows against T of B rows), not in every
    bit; one pass counted, over B x T positions."""
    before = (tfg.prime.passes, tfg.prime.positions)
    *_, new, old = _primed_both(seed=3, extra=extra)
    _close_state(new, old)
    assert new.t == RF + extra
    assert (tfg.prime.passes - before[0],
            tfg.prime.positions - before[1]) == (1, 3 * (RF + extra))


@pytest.mark.parametrize("cuts", [(8, 4, 5), (8, 2, 3), (1, 8, 4, 1)])
def test_a_short_prime_from_a_mid_ring_phase_is_the_old_loop(cuts):
    """Primes in a row, each starting where the last ended: one starts at
    phase 7, which no dilation above 1 divides, with fewer samples (1 to 3)
    than the largest dilation (4), and a one-sample context consumes
    nothing.  After each: the queues within f32 reduction order, the phase
    and the last ids equal."""
    _, port, ids, cond, spk = _setup(seed=11, batch=2)
    ids_t, cond_t = torch.from_numpy(ids).long(), torch.from_numpy(cond)
    spk_t = torch.from_numpy(spk).long()
    new, old, p = tfg.init_state(TCFG, 2), tfg.init_state(TCFG, 2), 0
    for c in cuts:
        args = (ids_t[:, p : p + c], cond_t[..., p:], spk_t)
        new = tfg.prime(port, TCFG, new, *args)
        old = oracle.old_prime(port, TCFG, old, *args)
        p += c - 1
        _close_state(new, old)
    assert new.t == sum(cuts) - len(cuts) and max(CFG.dilations) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_is_the_old_loop_bit_for_bit(dtype, temperature):
    """ids, logits, queues and last ids; at temperature 1 both draw from
    one CPU generator (the old loop a step at a time)."""
    _, port, _, cond, spk, new, _ = _primed_both(seed=4)
    gen_cond = torch.from_numpy(cond[..., RF : RF + 24])
    spk_t = torch.from_numpy(spk).long()
    before = (tfg.generate.eager_steps, tfg.generate.graph_replays)
    ids, st, lg = tfg.generate(port, TCFG, _copy(new), gen_cond,
                               torch.Generator().manual_seed(5), gc_ids=spk_t,
                               temperature=temperature, return_logits=True,
                               dtype=dtype)
    want_ids, want_st, want_lg = oracle.old_generate(
        port, TCFG, new, gen_cond, torch.Generator().manual_seed(5), spk_t,
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
