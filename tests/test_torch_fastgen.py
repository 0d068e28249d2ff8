"""The port's generation state and sampler against the JAX package.

``generate_fused_reference`` (the plain version of csrc/fastgen.cu) is
held against the Pallas kernel run in interpret mode, as
tests/test_fastgen_pallas.py runs it: its bf16, int8 and int4 branches, the
quantized ones at B = 8 and B = 16 (their activation scale spans the whole
batch).  The eager samplers ``generate`` and ``generate_naive`` are held to
the reference's at temperature 0.  The CUDA kernels themselves run only on
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
# the quantized branches: integer sums are exact on both sides, so only the
# f32 gate and the bf16 post-net differ: measured 2e-8 to 8e-8 of max |logits|
# with every id equal (int8 and int4, B = 8 and 16), while a scale taken per
# 8 rows reads 1.5e-2 at B = 16.  The bound leaves room for an f32 ulp
# flipping one activation code by one unit.
Q_LOGIT_TOL = 1e-3
JAX_PACKERS = {None: jfp.pack_for_pallas, "int8": jfp.pack_for_pallas_int8,
               "int4": jfp.pack_for_pallas_int4}


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


def _both_greedy(seed, batch, n, mode=None):
    params, port, cond, spk, jstate, tstate = _primed(seed, batch, n)
    gen_cond = cond[..., RF : RF + n]
    cond_gc = jfg._with_gc(params, CFG, jnp.asarray(gen_cond), jnp.asarray(spk))
    jpack, tpack = JAX_PACKERS[mode], tfc.PACKERS[mode]
    want_ids, _, want_last, want_lg = jfp.generate_fused(
        jpack(params, CFG), CFG, jfp.state_to_flat(jstate, CFG),
        jstate.prev_id, jstate.t, cond_gc, jnp.int32(0), temperature=0.0,
        debug_logits=True, interpret=True, quantized=mode or False)
    packed = tpack(port, TCFG)
    cond_t = tfg.with_gc(port, TCFG, torch.from_numpy(gen_cond),
                         torch.from_numpy(spk).long())
    got = tfc.generate_fused_reference(
        packed, TCFG, tfc.state_to_flat(tstate, TCFG), tstate.prev_id,
        tstate.t, cond_t, 0, temperature=0.0, debug_logits=True, quantized=mode)
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


# ------------------------------------------------- the quantized branches

def test_int8_packer_matches_pallas():
    """Unpacked int8 planes equal the reference's on the real rows (its
    rows past 2*n_res + n_cond are 128-lane padding), scales within 1e-6."""
    params, port, *_ = _setup(seed=6)
    want = jfp.pack_for_pallas_int8(params, CFG)
    got = tfc.pack_for_kernel_int8(port, TCFG)
    for qn, sn in (("w_in_q", "w_in_s"), ("w_out_q", "w_out_s")):
        ref = np.asarray(getattr(want, qn))
        plane = tfc.unpack_int8(getattr(got, qn)).numpy()
        rows = min(ref.shape[1], plane.shape[1])
        assert rows >= (2 * CFG.n_res + 16 if qn == "w_in_q" else CFG.n_dil)
        np.testing.assert_array_equal(plane[:, :rows], ref[:, :rows])
        assert not plane[:, rows:].any() and not ref[:, rows:].any()
        np.testing.assert_allclose(getattr(got, sn).numpy(),
                                   np.asarray(getattr(want, sn)), rtol=1e-6)
    np.testing.assert_array_equal(got.b_in.numpy(), np.asarray(want.b_in))


def test_int4_packer_matches_pallas():
    """The port pairs row i with row i + Kp/2 of its own 8-padded rows, the
    reference with row i + 64 of its 128-padded rows; the unpacked codes
    (hi, lo - 8) are the same on the real rows, and the bytes are packed
    (half as many as codes)."""
    params, port, *_ = _setup(seed=6)
    want = jfp.pack_for_pallas_int4(params, CFG)
    got = tfc.pack_for_kernel_int4(port, TCFG)
    k_in = 2 * CFG.n_res + CFG.n_lc_out + CFG.n_global_embed
    for pn, sn, k in (("w_in_p", "w_in_s", k_in), ("w_out_p", "w_out_s", CFG.n_dil)):
        pk = np.asarray(getattr(want, pn)).astype(np.int32)
        ref = np.concatenate([pk >> 4, (pk & 15) - 8], 1)
        hi, lo = tfc.unpack_int4(getattr(got, pn))
        assert int(lo.min()) >= 1 and int(lo.max()) <= 15 and int(hi.abs().max()) <= 7
        codes = torch.cat([hi, lo - 8], 1).numpy()
        assert getattr(got, pn).numel() * 2 == codes.size
        np.testing.assert_array_equal(codes[:, :k], ref[:, :k])
        assert not codes[:, k:].any()
        np.testing.assert_allclose(getattr(got, sn).numpy(),
                                   np.asarray(getattr(want, sn)), rtol=1e-6)


def _quantized_matches_pallas(mode, batch, n=12):
    """The plain int8 / int4 version against the Pallas branch in interpret
    mode: ids over each row's inclusive greedy prefix, logits there within
    Q_LOGIT_TOL of max |logits|.  -> (passes, worst logit gap, agreed steps)."""
    (want_ids, _, want_lg), (ids, _, _, lg) = _both_greedy(3, batch, n, mode)
    scale = np.abs(want_lg).max()
    agree, worst = 0, 0.0
    for r in range(batch):
        diff = np.nonzero(ids[r].numpy() != want_ids[r])[0]
        t_div = int(diff[0]) if len(diff) else n
        agree += t_div
        hi = min(t_div + 1, n)
        worst = max(worst, np.abs(lg[:hi, r].numpy() - want_lg[:hi, r]).max() / scale)
    return worst < Q_LOGIT_TOL and agree >= n * batch // 2, worst, agree


@pytest.mark.parametrize("batch", [8, 16])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_reference_matches_pallas(mode, batch):
    """At B = 8 and B = 16: the activation scale spans the whole batch, so a
    per-8-row scale fails at 16 (the next test)."""
    ok, worst, agree = _quantized_matches_pallas(mode, batch)
    assert ok, (worst, agree)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_per_cluster_scale_would_not_match_pallas(monkeypatch, mode):
    """The check above has power: with a scale taken per 8 rows (what a
    kernel whose clusters never talk would compute) the same predicate
    fails at B = 16, and still passes at B = 8 where the two scales are one."""
    monkeypatch.setattr(tfc, "_tile_scale", lambda v: torch.clamp(
        v.abs().reshape(-1, 8, v.shape[1]).amax((1, 2)), min=1e-9
    ).repeat_interleave(8)[:, None] * (1.0 / 127.0))
    ok, worst, agree = _quantized_matches_pallas(mode, 16)
    assert not ok and worst >= Q_LOGIT_TOL, (worst, agree)
    assert _quantized_matches_pallas(mode, 8)[0]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_chunk_carry_quantized(mode):
    _, port, cond, spk, _, state = _primed(seed=1, batch=3)
    packed = tfc.PACKERS[mode](port, TCFG)
    cond_gc = tfg.with_gc(port, TCFG, torch.from_numpy(cond[..., RF : RF + 24]),
                          torch.from_numpy(spk).long())
    flat = tfc.state_to_flat(state, TCFG)

    def run(ring, prev, t0, c):
        return tfc.generate_fused(packed, TCFG, ring, prev, t0, c, 7, 1.0,
                                  quantized=mode)

    whole = run(flat.clone(), state.prev_id, state.t, cond_gc)[0]
    a, flat2, last = run(flat.clone(), state.prev_id, state.t, cond_gc[..., :10])
    b = run(flat2, last, state.t + 10, cond_gc[..., 10:])[0]
    assert torch.equal(whole, torch.cat([a, b], 1))


def test_quantized_needs_matching_params():
    _, port, cond, spk, _, state = _primed(seed=1)
    flat = tfc.state_to_flat(state, TCFG)
    cond_gc = tfg.with_gc(port, TCFG, torch.from_numpy(cond[..., RF : RF + 2]),
                          torch.from_numpy(spk).long())
    with pytest.raises(ValueError, match="Int8KernelParams"):
        tfc.generate_fused(tfc.pack_for_kernel(port, TCFG), TCFG, flat,
                           state.prev_id, state.t, cond_gc, 0, 0.0, quantized=True)


@pytest.mark.parametrize("given,want", [(False, None), (None, None), ("none", None),
                                        (True, "int8"), ("int8", "int8"),
                                        ("int4", "int4")])
def test_norm_wq(given, want):
    assert tfc._norm_wq(given) == want == jfp._norm_wq(given)


def test_norm_wq_refuses_other_widths():
    with pytest.raises(ValueError, match="int2"):
        tfc._norm_wq("int2")


def test_quantize_int4_pair_matches_reference_and_refuses_odd_rows():
    w = np.random.default_rng(7).normal(size=(3, 8, 6)).astype(np.float32)
    packed, s = tfc.quantize_int4_pair(torch.from_numpy(w))
    want_p, want_s = jfp.quantize_int4_pair(jnp.asarray(w))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-6)
    with pytest.raises(ValueError, match="even"):
        tfc.quantize_int4_pair(torch.from_numpy(w[:, :7]))


# ------------------------------------------------------ the eager samplers

def test_generate_matches_jax_greedy():
    n = 16
    params, port, cond, spk, jstate, tstate = _primed(seed=8, n=n)
    gen_cond = cond[..., RF : RF + n]
    want_ids, want_state, want_lg = jfg.generate(
        params, CFG, jstate, jnp.asarray(gen_cond), jax.random.PRNGKey(0),
        gc_ids=jnp.asarray(spk), temperature=0.0, return_logits=True)
    ids, state, lg = tfg.generate(port, TCFG, tstate, torch.from_numpy(gen_cond),
                                  gc_ids=torch.from_numpy(spk).long(),
                                  temperature=0.0, return_logits=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert tuple(lg.shape) == (2, CFG.n_quant, n)
    np.testing.assert_allclose(lg.numpy(), np.asarray(want_lg), atol=1e-4)
    assert state.t == int(want_state.t) == RF + n
    np.testing.assert_array_equal(state.prev_id.numpy(), np.asarray(want_state.prev_id))
    short = tfg.generate(port, TCFG, state, torch.from_numpy(gen_cond),
                         gc_ids=torch.from_numpy(spk).long(), n_steps=3)[0]
    assert tuple(short.shape) == (2, 3)
    with pytest.raises(ValueError, match="exceeds"):
        tfg.generate(port, TCFG, state, torch.from_numpy(gen_cond), n_steps=n + 1)


def test_generate_naive_matches_jax_and_the_queue_sampler():
    n = 5
    params, port, ids, cond, spk = _setup(seed=9, n=n)
    want = jfg.generate_naive(params, CFG, jnp.asarray(ids[:, : RF + 1]),
                              jnp.asarray(cond), jax.random.PRNGKey(0),
                              gc_ids=jnp.asarray(spk), n_steps=n, temperature=0.0)
    spk_t = torch.from_numpy(spk).long()
    got = tfg.generate_naive(port, TCFG, torch.from_numpy(ids[:, : RF + 1]).long(),
                             torch.from_numpy(cond), gc_ids=spk_t, n_steps=n,
                             temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    state = tfg.prime(port, TCFG, tfg.init_state(TCFG, 2),
                      torch.from_numpy(ids[:, : RF + 1]).long(),
                      torch.from_numpy(cond), spk_t)
    fast = tfg.generate(port, TCFG, state, torch.from_numpy(cond[..., RF : RF + n]),
                        gc_ids=spk_t, temperature=0.0)[0]
    assert torch.equal(fast, got)


def test_generate_draws_follow_softmax():
    """The categorical branch: 20,000 draws from one distribution match
    softmax(logits / T) within 4 standard errors per class."""
    logits = torch.tensor([[2.0, 0.0, -1.0, 1.0]]).repeat(20000, 1)
    ids = tfg._draw(logits, 0.5, torch.Generator().manual_seed(0))
    p = torch.softmax(logits[0] / 0.5, 0)
    freq = torch.bincount(ids, minlength=4).float() / len(ids)
    assert bool(((freq - p).abs() < 4 * torch.sqrt(p * (1 - p) / len(ids))).all())
