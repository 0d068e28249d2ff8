"""The port's generation state and sampler against the JAX package.

``generate_fused_reference`` (the plain version of csrc/fastgen.cu) is
held against the Pallas kernel run in interpret mode, as
tests/test_fastgen_pallas.py runs it.  The CUDA kernel itself runs only on
the card: tests/test_torch_cuda.py and ``chip_smoke.py``."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ae_wavenet_tpu.models import wavenet as jwn
from ae_wavenet_tpu.ops import fastgen as jfg
from ae_wavenet_tpu.ops import fastgen_pallas as jfp
from ae_wavenet_tpu.training.torch_compat import flatten_named
from ae_wavenet_tpu.utils.config import WaveNetConfig
from ae_wavenet_tpu_torch.models import wavenet as twn
from ae_wavenet_tpu_torch.ops import fastgen as tfg
from ae_wavenet_tpu_torch.ops import fastgen_cuda as tfc
from ae_wavenet_tpu_torch.utils import config as tcfg

CFG = WaveNetConfig(
    n_blocks=2, n_block_layers=3, n_res=16, n_dil=16, n_skp=16, n_post=16,
    n_lc_in=8, n_lc_out=12, n_speakers=5, n_global_embed=4,
)
TCFG = tcfg.WaveNetConfig(**dataclasses.asdict(CFG))
RF = sum(CFG.dilations)
# greedy logits, plain version vs Pallas interpret: both accumulate bf16
# products in f32, in other orders; a bf16 rounding of h may flip by one
# ulp.  Relative to max |logits|.
LOGIT_TOL = 1e-2


def _setup(seed=0, batch=2, n=24):
    params = jwn.init(jax.random.PRNGKey(seed), CFG)
    port = twn.WaveNet(TCFG)
    port.load_state_dict({k: torch.tensor(v)
                          for k, v in flatten_named(params).items()})
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (batch, RF + 1 + n)).astype(np.int32)
    cond = (rng.normal(size=(batch, CFG.n_lc_out, RF + 1 + n)) * 0.3).astype(np.float32)
    spk = rng.integers(0, 5, (batch,)).astype(np.int32)
    return params, port, ids, cond, spk


def _primed(seed=0, batch=2, n=24):
    params, port, ids, cond, spk = _setup(seed, batch, n)
    jstate = jfg.prime(params, CFG, jfg.init_state(CFG, batch),
                       jnp.asarray(ids[:, : RF + 1]), jnp.asarray(cond),
                       jnp.asarray(spk))
    tstate = tfg.prime(port, TCFG, tfg.init_state(TCFG, batch),
                       torch.from_numpy(ids[:, : RF + 1]).long(),
                       torch.from_numpy(cond), torch.from_numpy(spk).long())
    return params, port, cond, spk, jstate, tstate


def test_prime_matches_jax():
    _, _, _, _, jstate, tstate = _primed()
    assert tstate.t == int(jstate.t) == RF
    np.testing.assert_array_equal(tstate.prev_id.numpy(), np.asarray(jstate.prev_id))
    for a, b in zip(jstate.bufs, tstate.bufs):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)


def test_flat_state_round_trip():
    _, _, _, _, jstate, tstate = _primed(seed=2)
    flat = tfc.state_to_flat(tstate, TCFG)
    want = np.asarray(jfp.state_to_flat(jstate, CFG)).astype(np.float32)
    assert flat.dtype == torch.bfloat16 and tuple(flat.shape) == want.shape
    # f32 rings agree to ~1e-6, so bf16 rounding may differ by one ulp
    np.testing.assert_allclose(flat.float().numpy(), want, rtol=8e-3, atol=1e-6)
    back = tfc.flat_to_state(flat, tstate.prev_id, tstate.t, TCFG)
    for a, b in zip(tstate.bufs, back.bufs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=8e-3, atol=1e-6)
    assert torch.equal(tfc.state_to_flat(back, TCFG), flat)


def _both_greedy(seed, batch, n):
    params, port, cond, spk, jstate, tstate = _primed(seed, batch, n)
    gen_cond = cond[..., RF : RF + n]
    cond_gc = jfg._with_gc(params, CFG, jnp.asarray(gen_cond), jnp.asarray(spk))
    want_ids, _, want_last, want_lg = jfp.generate_fused(
        jfp.pack_for_pallas(params, CFG), CFG, jfp.state_to_flat(jstate, CFG),
        jstate.prev_id, jstate.t, cond_gc, jnp.int32(0), temperature=0.0,
        debug_logits=True, interpret=True)
    packed = tfc.pack_for_kernel(port, TCFG)
    cond_t = tfg.with_gc(port, TCFG, torch.from_numpy(gen_cond),
                         torch.from_numpy(spk).long())
    got = tfc.generate_fused_reference(
        packed, TCFG, tfc.state_to_flat(tstate, TCFG), tstate.prev_id,
        tstate.t, cond_t, 0, temperature=0.0, debug_logits=True)
    return (np.asarray(want_ids), np.asarray(want_last), np.asarray(want_lg)), got


def test_reference_matches_pallas_greedy():
    (want_ids, want_last, want_lg), (ids, _, last, lg) = _both_greedy(0, 2, 24)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(last.numpy(), want_last)
    assert lg.shape == want_lg.shape == (24, 2, CFG.n_quant)
    rel = np.abs(lg.numpy() - want_lg).max() / np.abs(want_lg).max()
    assert rel < LOGIT_TOL, rel


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_chunk_carry(temperature):
    """10 + 14 steps (phase carried by t0) give the ids of 24 steps.  The
    Philox counter holds the absolute step, so this holds when sampling
    too."""
    _, port, cond, spk, _, state = _primed(seed=1)
    packed = tfc.pack_for_kernel(port, TCFG)
    cond_gc = tfg.with_gc(port, TCFG, torch.from_numpy(cond[..., RF : RF + 24]),
                          torch.from_numpy(spk).long())
    flat = tfc.state_to_flat(state, TCFG)
    whole, _, _ = tfc.generate_fused_reference(
        packed, TCFG, flat.clone(), state.prev_id, state.t, cond_gc, 7, temperature)
    a, flat2, last = tfc.generate_fused_reference(
        packed, TCFG, flat.clone(), state.prev_id, state.t, cond_gc[..., :10], 7,
        temperature)
    b, _, _ = tfc.generate_fused_reference(
        packed, TCFG, flat2, last, state.t + 10, cond_gc[..., 10:], 7, temperature)
    assert torch.equal(whole, torch.cat([a, b], 1))


def _pit_statistic(ids, logits, temperature, seed=0):
    """Kolmogorov-Smirnov distance to U(0,1) of the randomized probability
    integral transform of each draw under softmax(logits / temperature).
    Draws of an AR rollout give i.i.d. uniforms when each is sampled from
    its own predictive distribution."""
    p = torch.softmax(logits.double() / temperature, -1)   # [T, B, Q]
    idx = ids.t().long()[..., None]                        # [T, B, 1]
    below = (torch.cumsum(p, -1).gather(-1, idx) - p.gather(-1, idx))[..., 0]
    v = torch.rand(below.shape, generator=torch.Generator().manual_seed(seed),
                   dtype=torch.float64)
    u = torch.sort((below + v * p.gather(-1, idx)[..., 0]).flatten()).values
    n = u.numel()
    k = torch.arange(1, n + 1, dtype=torch.float64)
    return float(torch.maximum(k / n - u, u - (k - 1) / n).max()), n


# Dvoretzky-Kiefer-Wolfowitz (Massart's constant): P(D > eps) <= 2
# exp(-2 n eps^2), so eps(alpha) bounds the false-failure rate by alpha.
def _dkw_eps(n, alpha=1e-6):
    return math.sqrt(math.log(2.0 / alpha) / (2.0 * n))


def test_sampled_ids_follow_softmax():
    """T = 1 draws pass a KS test against softmax(logits) with false-failure
    rate <= 1e-6; the same draws scored under the wrong temperature fail
    it (the test has power at this n)."""
    batch, n = 64, 256
    _, port, _, _, _, state = _primed(seed=5, batch=batch, n=0)
    with torch.no_grad():  # peaked predictive distributions
        port.post2["w"].mul_(200.0)
    packed = tfc.pack_for_kernel(port, TCFG)
    cond = torch.from_numpy(np.random.default_rng(5).normal(
        size=(batch, TCFG.n_lc_out + TCFG.n_global_embed, n)).astype(np.float32) * 0.3)
    ids, _, _, lg = tfc.generate_fused_reference(
        packed, TCFG, tfc.state_to_flat(state, TCFG), state.prev_id, state.t,
        cond, 1234, temperature=1.0, debug_logits=True)
    d, count = _pit_statistic(ids, lg, 1.0)
    assert count >= 16384
    assert d < _dkw_eps(count), (d, _dkw_eps(count))
    d_wrong, _ = _pit_statistic(ids, lg, 2.0)
    assert d_wrong > _dkw_eps(count), d_wrong


def test_two_seeds_give_different_ids():
    _, port, cond, spk, _, state = _primed(seed=3)
    packed = tfc.pack_for_kernel(port, TCFG)
    cond_gc = tfg.with_gc(port, TCFG, torch.from_numpy(cond[..., RF : RF + 24]),
                          torch.from_numpy(spk).long())
    flat = tfc.state_to_flat(state, TCFG)
    a = tfc.generate_fused_reference(packed, TCFG, flat.clone(), state.prev_id,
                                     state.t, cond_gc, 1)[0]
    b = tfc.generate_fused_reference(packed, TCFG, flat.clone(), state.prev_id,
                                     state.t, cond_gc, 2)[0]
    assert not torch.equal(a, b)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    def run(ctr, key):
        out = tfc.philox4x32_10(tuple(torch.tensor([c]) for c in ctr), key)
        return [int(w) for w in out]

    assert run((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_generate_auto_on_cpu_takes_plain_version():
    _, port, cond, spk, _, state = _primed(seed=4)
    tfc.generate_fused.launches = 0
    tfc.generate_fused_reference.launches = 0
    gen = torch.Generator().manual_seed(0)
    ids, new = tfc.generate_auto(port, TCFG, state, torch.from_numpy(cond[..., :8]),
                                 gen, gc_ids=torch.from_numpy(spk).long())
    assert tuple(ids.shape) == (2, 8) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < TCFG.n_quant
    assert new.t == state.t + 8
    assert torch.equal(new.prev_id, ids[:, -1])
    assert tfc.generate_fused.launches == 0
    assert tfc.generate_fused_reference.launches == 1
