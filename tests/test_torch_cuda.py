"""The port's correctness on the card: the CUDA kernels against their
plain versions (the sampler with bf16, int8 and int4 weights and the
mixture-of-logistics tail, the fused VQ lookup, the gated training stack),
at tiny widths and at the flagship's (``chorowski``, the training path's B
= 4 x 48,000, the cells' batches); the MFCC inverter's path through them,
and the int8 quality gate; the one-pass prime against the old step loop;
the f32 rollout and the training step replayed as CUDA graphs against the
same step in the eager loop; and a two-rank step sharing the card against
one process.  ``chip_smoke.py`` times the kernels and drives the CLIs; a
kernel's check belongs here.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  The file
imports no jax, so on a machine with the card and without JAX it runs
without the JAX suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import contextlib
import dataclasses
import functools
import io
import math
import os

import chip_smoke
import fastgen_oracle as oracle
import numpy as np
import pytest
import torch

from ae_wavenet_tpu_torch.models import wavenet as twn
from ae_wavenet_tpu_torch.ops import fastgen as tfg
from ae_wavenet_tpu_torch.ops import fastgen_cuda as tfc
from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

# "scalar": widths with no common divisor near the SM count, so the grid's
# blocks split them unevenly and many own no column of a matrix; "vector":
# multiples of 64 (an even split, as at the flagship width)
CFGS = {
    "scalar": WaveNetConfig(n_blocks=2, n_block_layers=4, n_res=48, n_dil=40,
                            n_skp=24, n_post=32, n_lc_out=12, n_global_embed=4,
                            n_speakers=5),
    "vector": WaveNetConfig(n_blocks=2, n_block_layers=4, n_res=64, n_dil=64,
                            n_skp=64, n_post=64, n_lc_out=12, n_global_embed=4,
                            n_speakers=5),
}
CFG = CFGS["scalar"]
# relative to max |logits|; both sides accumulate bf16 products in f32
LOGIT_TOL = 1e-2
Q_BIG_BATCH = 136       # past the earlier cluster design's 120-row bound


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _agreed(got, want, tol) -> int:
    """The steps over which each row's ids agree with the plain version's,
    summed over the rows, once the logits over each row's inclusive
    agreeing prefix are held within ``tol`` of max |logits|."""
    agree, err = chip_smoke.compare(got[0], got[3], want[0], want[3])
    assert err / float(want[3].abs().max()) < tol, (agree, err)
    return sum(agree)


def _setup(dev, batch, n, seed=0, cfg=CFG, pack=tfc.pack_for_kernel):
    gen = torch.Generator().manual_seed(seed)
    wn = twn.WaveNet(cfg, gen)
    with torch.no_grad():
        wn.post2["w"].mul_(50.0)  # informative logits
    wn = wn.to(dev)
    rf = sum(cfg.dilations)
    ctx = torch.randint(0, cfg.n_quant, (batch, rf + 1), generator=gen).to(dev)
    cond = (torch.randn(batch, cfg.n_lc_out, rf, generator=gen) * 0.3).to(dev)
    state = tfg.prime(wn, cfg, tfg.init_state(cfg, batch, device=dev), ctx, cond)
    n_cond = cfg.n_lc_out + cfg.n_global_embed
    gcond = (torch.randn(batch, n_cond, n, generator=gen) * 0.3).to(dev)
    return pack(wn, cfg), tfc.state_to_flat(state, cfg), state, gcond


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("batch", [1, 11])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_kernel_matches_plain_version(cuda_device, name, batch, temperature):
    """Same ids over each row's inclusive agreeing prefix (the same Philox
    bits feed both when sampling), logits within LOGIT_TOL there, and, when
    every id agreed, the same last ids and rings within one bf16 rounding
    (the ring stores bf16 of an f32 sum taken in another order)."""
    n, cfg = 32, CFGS[name]
    packed, flat, state, cond = _setup(cuda_device, batch, n, cfg=cfg)
    before = tfc.generate_fused.launches
    got = tfc.generate_fused(packed, cfg, flat.clone(), state.prev_id, state.t,
                             cond, 9, temperature, debug_logits=True)
    want = tfc.generate_fused_reference(packed, cfg, flat.clone(), state.prev_id,
                                        state.t, cond, 9, temperature,
                                        debug_logits=True)
    torch.cuda.synchronize()
    assert tfc.generate_fused.launches == before + 1
    agree = _agreed(got, want, LOGIT_TOL)
    assert agree >= n * batch // 2
    if agree == n * batch:
        assert torch.equal(got[2], want[2])
        ring_err = (got[1].float() - want[1].float()).abs().max()
        assert float(ring_err) <= 1e-2 * float(want[1].float().abs().max())


@pytest.mark.cuda
def test_kernel_chunk_carry(cuda_device):
    packed, flat, state, cond = _setup(cuda_device, 11, 24, seed=1)
    whole = tfc.generate_fused(packed, CFG, flat.clone(), state.prev_id, state.t,
                               cond, 3, 1.0)[0]
    a, ring, last = tfc.generate_fused(packed, CFG, flat.clone(), state.prev_id,
                                       state.t, cond[..., :10], 3, 1.0)
    b = tfc.generate_fused(packed, CFG, ring, last, state.t + 10, cond[..., 10:],
                           3, 1.0)[0]
    assert torch.equal(whole, torch.cat([a, b], 1))


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    packed, flat, state, cond = _setup(cuda_device, 2, 4, seed=2)
    with pytest.raises(ValueError, match="w_in"):
        tfc.generate_fused(packed._replace(w_in=packed.w_in.float()), CFG, flat,
                           state.prev_id, state.t, cond, 0, 0.0)
    with pytest.raises(ValueError, match="prev_id"):
        tfc.generate_fused(packed, CFG, flat, state.prev_id + CFG.n_quant,
                           state.t, cond, 0, 0.0)
    with pytest.raises(ValueError, match="cpu"):
        tfc.generate_fused(packed, CFG, flat, state.prev_id.cpu(), state.t,
                           cond, 0, 0.0)


# ------------------------------------------------ the quantized sampler

# integer sums are exact on both sides; only tanhf/expf and the post-net's
# sums differ, and an f32 ulp may flip one activation code by one unit
Q_LOGIT_TOL = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("batch", [1, 11, 16])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_kernel_matches_plain_version(cuda_device, name, batch, mode):
    """int8 and int4 kernels against the plain version: one row (B = 1),
    two 8-row tiles with a ragged one (B = 11: the scale spans both, rows
    past B stay out of it) and B = 16; ids over each row's inclusive
    agreeing prefix, logits there within Q_LOGIT_TOL of max |logits|."""
    n, cfg = 24, CFGS[name]
    packed, flat, state, cond = _setup(cuda_device, batch, n, cfg=cfg,
                                       pack=tfc.PACKERS[mode])
    counter = "launches_" + mode
    before = getattr(tfc.generate_fused, counter)
    got = tfc.generate_fused(packed, cfg, flat.clone(), state.prev_id, state.t,
                             cond, 9, 1.0, debug_logits=True, quantized=mode)
    want = tfc.generate_fused_reference(packed, cfg, flat.clone(), state.prev_id,
                                        state.t, cond, 9, 1.0, debug_logits=True,
                                        quantized=mode)
    torch.cuda.synchronize()
    assert getattr(tfc.generate_fused, counter) == before + 1
    assert bool(torch.isfinite(got[3]).all())
    agree = _agreed(got, want, Q_LOGIT_TOL)
    assert agree >= n * batch // 2
    if agree == n * batch:
        assert torch.equal(got[2], want[2])
        ring_err = (got[1].float() - want[1].float()).abs().max()
        assert float(ring_err) <= 1e-2 * float(want[1].float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_kernel_chunk_carry_and_batch_bound(cuda_device, mode):
    packed, flat, state, cond = _setup(cuda_device, 11, 24, seed=1,
                                       pack=tfc.PACKERS[mode])

    def run(ring, prev, t0, c):
        return tfc.generate_fused(packed, CFG, ring, prev, t0, c, 3, 1.0,
                                  quantized=mode)

    whole = run(flat.clone(), state.prev_id, state.t, cond)[0]
    a, ring, last = run(flat.clone(), state.prev_id, state.t, cond[..., :10])
    b = run(ring, last, state.t + 10, cond[..., 10:])[0]
    assert torch.equal(whole, torch.cat([a, b], 1))
    # no batch bound (the old cluster design refused more than 120 rows at
    # the flagship width): 17 tiles of 8 rows against the plain version
    _held_to_plain(cuda_device, CFG, mode, 136, 8, seed=5)


def _held_to_plain(dev, cfg, mode, batch, n, seed, primed=True, tol=None):
    """The kernel against the plain version on one input: ids over each
    row's inclusive agreeing prefix, logits there within the tolerance of
    max |logits|, and every row agreeing at least half the steps."""
    pack = tfc.PACKERS[mode]
    if primed:
        packed, flat, state, cond = _setup(dev, batch, n, seed=seed, cfg=cfg, pack=pack)
        prev, t0 = state.prev_id, state.t
    else:  # a random ring: priming a deep stack takes thousands of eager steps
        gen = torch.Generator().manual_seed(seed)
        wn = twn.WaveNet(cfg, gen)
        with torch.no_grad():
            wn.post2["w"].mul_(50.0)
        packed = pack(wn.to(dev), cfg)
        n_cond = cfg.n_lc_out + cfg.n_global_embed
        flat = (torch.randn(sum(cfg.dilations), batch, cfg.n_res, generator=gen)
                * 0.5).to(dev, torch.bfloat16)
        prev = torch.randint(0, cfg.n_quant, (batch,), generator=gen).to(dev)
        cond = (torch.randn(batch, n_cond, n, generator=gen) * 0.3).to(dev)
        t0 = 3
    got = tfc.generate_fused(packed, cfg, flat.clone(), prev, t0, cond, 9, 1.0,
                             debug_logits=True, quantized=mode)
    want = tfc.generate_fused_reference(packed, cfg, flat.clone(), prev, t0, cond,
                                        9, 1.0, debug_logits=True, quantized=mode)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[3]).all())
    assert _agreed(got, want, tol or (LOGIT_TOL if mode is None else Q_LOGIT_TOL)) >= (
        n * batch // 2)
    return got


# the flagship's decoder on primed rows
GREEDY_T = 128          # steps of the greedy comparison
MIN_PREFIX = 8          # greedy steps over which every row's ids must agree
STATE_T = 16            # steps after which rings and last ids are compared
KS_ALPHA = 1e-6         # false-failure rate of the sampling test
MIN_DRAWS = 16384       # draws of a sampling test, at any batch
Q_VS_BF16_TOL = {"int8": 0.10, "int4": 0.40}  # tests_tpu/test_pallas_tpu.py:241-269


def pit_ks(ids, logits, seed: int = 0):
    """KS distance to U(0,1) of the randomized probability integral
    transform of each draw under softmax(logits), and the number of draws;
    i.i.d. uniform when every draw of the rollout comes from its own
    predictive distribution."""
    p = torch.softmax(logits.double(), -1).cpu()          # [T, B, Q]
    idx = ids.t().long().cpu()[..., None]                 # [T, B, 1]
    pk = p.gather(-1, idx)[..., 0]
    below = torch.cumsum(p, -1).gather(-1, idx)[..., 0] - pk
    v = torch.rand(pk.shape, generator=torch.Generator().manual_seed(seed),
                   dtype=torch.float64)
    u = torch.sort((below + v * pk).flatten()).values
    n = u.numel()
    k = torch.arange(1, n + 1, dtype=torch.float64)
    return float(torch.maximum(k / n - u, u - (k - 1) / n).max()), n


@functools.lru_cache(maxsize=1)
def _flagship_rows(dev):
    """The ``chorowski`` decoder of ``autoencoder.init`` (seed 0) with
    informative logits (its post-net's last product x POST2_SCALE: max |logits| ~5),
    and for each batch of the flagship cases (ring, last ids, phase, cond)
    of rows primed on rf + 1 context ids, all drawn from one generator:
    8 rows with cond for 2,048 steps; 136, whose first 64 are the B = 64
    case; B = 1 the first of the 8; the others with cond for MIN_DRAWS
    draws."""
    from ae_wavenet_tpu_torch.models import autoencoder as tae
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    cfg = chorowski_config()
    wcfg = cfg.wavenet
    gen = torch.Generator().manual_seed(0)
    wn = tae.init(cfg, gen, dev).eval().wavenet
    with torch.no_grad():
        wn.post2["w"].mul_(chip_smoke.POST2_SCALE)
    rf, n_cond = sum(wcfg.dilations), wcfg.n_lc_out + wcfg.n_global_embed

    def primed(n):
        ctx = torch.randint(0, wcfg.n_quant, (n, rf + 1), generator=gen).to(dev)
        cond = (torch.randn(n, wcfg.n_lc_out, rf, generator=gen) * 0.3).to(dev)
        spk = torch.randint(0, wcfg.n_speakers, (n,), generator=gen).to(dev)
        st = tfg.prime(wn, wcfg, tfg.init_state(wcfg, n, device=dev), ctx, cond, spk)
        return tfc.state_to_flat(st, wcfg), st.prev_id, st.t

    def draws(n):
        return (torch.randn(n, n_cond, -(-MIN_DRAWS // n), generator=gen) * 0.3).to(dev)

    flat, prev, t = primed(8)
    rows = {8: (flat, prev, t, draws(8))}
    flat_all, prev_all, t_all = primed(Q_BIG_BATCH)
    rows[1] = (flat[:, :1].contiguous(), prev[:1].contiguous(), t, draws(1))
    rows[64] = (flat_all[:, :64].contiguous(), prev_all[:64].contiguous(), t_all, draws(64))
    rows[Q_BIG_BATCH] = (flat_all, prev_all, t_all, draws(Q_BIG_BATCH))
    return wn, rows


def _held_rows(ids, lg, ref_ids, ref_lg, tol, scale) -> tuple[bool, dict]:
    """Greedy ids [R, T] and logits [T, R, Q] against a reference's: every
    row's ids agree for MIN_PREFIX steps or part before at a near-tie, where
    the reference's logit gap between its pick and the other's is within the
    largest |logit difference| of the two sides at that step; and the
    logits over each row's inclusive agreeing prefix lie within ``tol`` of
    ``scale``.  -> (whether they do, the readings: each row's prefix, the
    logits' largest difference over ``scale``, and each early parting's
    (row, step, gap, difference))."""
    agree, err = chip_smoke.compare(ids, lg, ref_ids, ref_lg)
    partings = []
    for r, t in enumerate(agree):
        if t < MIN_PREFIX:
            want, got = ref_lg[t, r].float(), lg[t, r].float()
            partings.append((r, t, float(want[int(ref_ids[r, t])] - want[int(ids[r, t])]),
                             float((got - want).abs().max())))
    ok = err / scale < tol and all(gap <= diff for _, _, gap, diff in partings)
    return ok, {"prefix": agree, "logits": err / scale, "partings": partings}


def _flagship_faults(packed, cfg, phase, mode, batch, dev) -> dict:
    """{name: (keywords of the plain run, patch or None)}: faults planted in
    the plain version, which the flagship check must reject.  bf16: layer
    L / 2's skip dropped, the ring slot off by one, one block's share of
    layer 0 shifted by a column (its share alone differs); int8 and int4:
    the activation scale taken per 8 rows at Q_BIG_BATCH rows, int4's
    zero-point correction dropped below it."""
    from unittest import mock

    if mode is not None:
        def per_8_rows(v):
            m = v.abs().reshape(-1, 8, v.shape[1]).amax((1, 2))
            return (torch.clamp(m, min=1e-9) * (1.0 / 127.0)).repeat_interleave(8)[:, None]

        if batch == Q_BIG_BATCH:
            return {"scale per 8 rows": ({}, mock.patch.object(tfc, "_tile_scale",
                                                                per_8_rows))}
        if mode == "int4":
            return {"zero point dropped": ({}, mock.patch.object(tfc, "_ZERO_POINT", 0))}
        return {}
    l_bad = len(cfg.dilations) // 2
    w_out, b_out = packed.w_out.clone(), packed.b_out.clone()
    w_out[l_bad, :, cfg.n_res:] = 0
    b_out[l_bad, cfg.n_res:] = 0
    # block r_bad reads each of its columns of layer 0 one column to the
    # right (the shares differ in its row only)
    plan = tfc.device_plan(cfg, None, dev)
    r_bad = plan.n_blocks // 3
    s_in, s_out = packed.w_in.clone(), packed.w_out.clone()
    for name, w in (("filter", s_in), ("gate", s_in), ("res", s_out), ("skip", s_out)):
        lo, hi = plan.cols(name, r_bad)
        w[0, :, lo:hi] = w[0, :, lo + 1:hi + 1].clone()
    shifted = packed._replace(w_in=s_in, w_out=s_out)
    differ = (tfc.pack_shares(shifted, plan) != tfc.pack_shares(packed, plan)).any(1)
    assert differ.nonzero().flatten().tolist() == [r_bad]
    return {f"layer {l_bad}'s skip dropped":
            (dict(pk=packed._replace(w_out=w_out, b_out=b_out)), None),
            "ring slot off by one": (dict(t0=phase + 1), None),
            f"block {r_bad}'s layer-0 share shifted a column": (dict(pk=shifted), None)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode,batch", [(None, 8)] + [(m, b) for m in ("int8", "int4")
                                                      for b in (1, 8, 64, Q_BIG_BATCH)])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_kernel_matches_plain_version_on_primed_flagship_rows(cuda_device, mode, batch,
                                                             temperature):
    """The ``chorowski`` decoder on ``batch`` primed rows (``_flagship_rows``:
    one 8-row tile in bf16; the CLI's request, one tile, the batched request
    and past the earlier cluster design's 120-row bound in int8 and int4)
    against its plain version.  Greedy (T = 0) over GREEDY_T steps, every
    row held by ``_held_rows`` at LOGIT_REL_TOL; in bf16 each row alone
    gives the kernel's bits in the batch and is held to the better of the
    plain version's runs alone and in the batch (cuBLAS sums in another
    order at 1 row than at B); the same check rejects the faults of
    ``_flagship_faults``.  After STATE_T greedy steps, on every row whose
    ids all agree (half the rows or more), the last ids are equal and the
    rings within 1e-2 of their largest value; two chunks give one call's
    ids; int8 and int4's first-step logits lie within Q_VS_BF16_TOL of the
    bf16 kernel's.  Sampled (T = 1): the draws' randomized PIT passes a KS
    test at false-failure rate KS_ALPHA over MIN_DRAWS draws or more; in
    bf16 another seed gives other ids, all in range."""
    dev = cuda_device
    wn, rows = _flagship_rows(torch.device(dev))
    cfg = wn.cfg
    flat, prev0, phase, cond = rows[batch]
    n = cond.shape[-1]
    packed, bf16 = tfc.PACKERS[mode](wn, cfg), tfc.pack_for_kernel(wn, cfg)
    tol = chip_smoke.LOGIT_REL_TOL[mode]

    def run(fn, steps=GREEDY_T, seed=0, temperature=0.0, debug=True, pk=packed, m=mode,
            ring=flat, prev=prev0, t0=phase, c=cond):
        return fn(pk, cfg, ring.clone(), prev, t0, c[..., :steps], seed, temperature,
                  debug, m)

    if temperature > 0.0:
        ids, _, _, lg = run(tfc.generate_fused, n, seed=1234, temperature=temperature)
        d, n_draws = pit_ks(ids, lg)
        eps = math.sqrt(math.log(2.0 / KS_ALPHA) / (2.0 * n_draws))  # DKW bound
        assert n_draws >= MIN_DRAWS and d < eps, (d, eps, n_draws)
        if mode is None:
            other = run(tfc.generate_fused, n, seed=4321, temperature=temperature,
                        debug=False)[0]
            assert not torch.equal(other, ids)
            assert int(ids.min()) >= 0 and int(ids.max()) < cfg.n_quant
        return
    got, want = run(tfc.generate_fused), run(tfc.generate_fused_reference)
    assert bool(torch.isfinite(got[3]).all())
    scale = float(want[3].abs().max())
    for r in range(batch):
        ids, lg = got[0][r:r + 1], got[3][:, r:r + 1]
        runs = [(want[0][r:r + 1], want[3][:, r:r + 1])]
        if mode is None:
            one = dict(ring=flat[:, r:r + 1].contiguous(),
                       prev=prev0[r:r + 1].contiguous(), c=cond[r:r + 1].contiguous())
            alone = run(tfc.generate_fused, **one)
            assert torch.equal(alone[0], ids) and torch.equal(alone[3], lg), r
            plain = run(tfc.generate_fused_reference, **one)
            runs.append((plain[0], plain[3]))
        held = [_held_rows(ids, lg, *w, tol, scale) for w in runs]
        assert any(ok for ok, _ in held), (r, held)
    for name, (kw, patch) in _flagship_faults(packed, cfg, phase, mode, batch,
                                              dev).items():
        with patch or contextlib.nullcontext():
            bad = run(tfc.generate_fused_reference, **kw)
        ok, readings = _held_rows(got[0], got[3], bad[0], bad[3], tol,
                                  float(bad[3].abs().max()))
        assert not ok, (name, readings)
    if mode is not None:
        lg_b = run(tfc.generate_fused, 1, pk=bf16, m=None)[3]
        vs_bf16 = float((got[3][0] - lg_b[0]).abs().max()) / float(lg_b.abs().max())
        assert vs_bf16 < Q_VS_BF16_TOL[mode], vs_bf16
    s_k, ring_k, last_k = run(tfc.generate_fused, STATE_T, debug=False)
    s_r, ring_r, last_r = run(tfc.generate_fused_reference, STATE_T, debug=False)
    same = [r for r in range(batch) if torch.equal(s_k[r], s_r[r])]
    assert len(same) >= max(1, batch // 2), same
    assert torch.equal(last_k[same], last_r[same])
    ring_err = float((ring_k[:, same].float() - ring_r[:, same].float()).abs().max())
    assert ring_err <= 1e-2 * float(ring_r[:, same].float().abs().max())
    half = got[0].shape[1] // 2
    a, ring_a, last_a = run(tfc.generate_fused, half, debug=False)
    b = run(tfc.generate_fused, got[0].shape[1] - half, debug=False, ring=ring_a,
            prev=last_a, t0=phase + half, c=cond[..., half:])[0]
    assert torch.equal(torch.cat([a, b], 1), got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n_blocks", [(None, 4), ("int8", 6)])
def test_kernel_partly_resident_matches_plain(cuda_device, mode, n_blocks):
    """40 layers (bf16, about 51 MB of weights) and 60 (int8) at the
    ``chorowski`` widths: the first layers' shares live in shared memory,
    the rest are read from global memory by the same kernel; B = 2 against
    the plain version, at the flagship's tolerances (chip_smoke.py)."""
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    cfg = dataclasses.replace(chorowski_config().wavenet, n_blocks=n_blocks)
    plan = tfc.device_plan(cfg, mode, cuda_device)
    assert 0 < plan.resident_layers < len(cfg.dilations)
    _held_to_plain(cuda_device, cfg, mode, 2, 12, seed=6, primed=False,
                   tol=chip_smoke.LOGIT_REL_TOL[mode])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_kernel_at_batch_128_matches_plain(cuda_device, mode):
    """B = 128 at the ``chorowski`` widths, 64 steps (``scripts/bench_gen.py``'s
    batch: every GEMM in two passes of 64 rows) against the plain version,
    at the flagship's tolerances."""
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    _held_to_plain(cuda_device, chorowski_config().wavenet, mode, 128, 64, seed=8,
                   primed=False, tol=chip_smoke.LOGIT_REL_TOL[mode])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_kernel_gives_the_same_bits_twice(cuda_device, mode):
    """Fixed-order sums: a second launch on the same inputs gives the same
    ids, rings, last ids and logits."""
    packed, flat, state, cond = _setup(cuda_device, 11, 16, seed=7,
                                       pack=tfc.PACKERS[mode])
    runs = [tfc.generate_fused(packed, CFG, flat.clone(), state.prev_id, state.t,
                               cond, 9, 1.0, debug_logits=True, quantized=mode)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ------------------------------------- the mixture-of-logistics sampler

MOL_CFGS = {
    "scalar": dataclasses.replace(CFGS["scalar"], n_global_embed=0, n_mix=3, n_quant=65536),
    "vector": dataclasses.replace(CFGS["vector"], n_global_embed=0, n_mix=10, n_quant=65536),
}
# samples within this of the plain version's while the components agree
# (the same draws; mixture parameters within LOGIT_TOL of their largest,
# which moves a mean and a log-scale by as much)
MOL_SAMPLE_TOL = 0.05
MOL_B, MOL_T = chip_smoke.MOL_B, 64   # the MoL cell's batch; steps of its teacher-forced check


def _mol_setup(dev, cfg, batch, n, seed, primed=True):
    """Packed weights whose mixture is informative (means within [-1, 1],
    scales about 0.05), the ring, the previous samples and the cond."""
    gen = torch.Generator().manual_seed(seed)
    wn = twn.WaveNet(cfg, gen)
    k = cfg.n_mix
    with torch.no_grad():
        wn.post2["w"].mul_(10.0)
        wn.post2["b"][2 * k :] = -3.0
    wn = wn.to(dev)
    rf = sum(cfg.dilations)
    if primed:
        ctx = (torch.rand(batch, rf + 1, generator=gen) * 1.2 - 0.6).to(dev)
        c = (torch.randn(batch, cfg.n_lc_out, rf, generator=gen) * 0.3).to(dev)
        st = tfg.prime(wn, cfg, tfg.init_state(cfg, batch, device=dev), ctx, c)
        flat, prev, t0 = tfc.state_to_flat(st, cfg), st.prev_id, st.t
    else:  # a random ring: priming 30 layers of 512 eagerly takes long
        flat = (torch.randn(rf, batch, cfg.n_res, generator=gen) * 0.5).to(dev, torch.bfloat16)
        prev, t0 = (torch.rand(batch, generator=gen) - 0.5).to(dev), 3
    cond = (torch.randn(batch, cfg.n_lc_out, n, generator=gen) * 0.3).to(dev)
    return tfc.pack_for_kernel(wn, cfg), flat, prev, t0, cond


def _mol_held_to_plain(dev, cfg, batch, n, seed, temperature, primed=True, tol=LOGIT_TOL):
    """The MoL kernel against the plain version: samples within
    MOL_SAMPLE_TOL over each row's inclusive agreeing prefix, mixture
    parameters there within ``tol`` of their largest magnitude, every row
    agreeing at least half the steps."""
    packed, flat, prev, t0, cond = _mol_setup(dev, cfg, batch, n, seed, primed)
    before = (tfc.generate_fused.launches, tfc.generate_fused.mol_launches)
    got = tfc.generate_fused(packed, cfg, flat.clone(), prev, t0, cond, 9, temperature,
                             debug_logits=True)
    want = tfc.generate_fused_reference(packed, cfg, flat.clone(), prev, t0, cond, 9,
                                        temperature, debug_logits=True)
    torch.cuda.synchronize()
    assert (tfc.generate_fused.launches, tfc.generate_fused.mol_launches) == (
        before[0] + 1, before[1] + 1)
    assert got[0].dtype == torch.float32 and bool(torch.isfinite(got[3]).all())
    assert float(got[0].abs().max()) <= 1.0
    scale = float(want[3].abs().max())
    agree = 0
    for r in range(batch):
        diff = torch.nonzero((got[0][r] - want[0][r]).abs() > MOL_SAMPLE_TOL)
        t_div = n if len(diff) == 0 else int(diff[0])
        agree += t_div
        hi = min(t_div + 1, n)
        rel = float((got[3][:hi, r] - want[3][:hi, r]).abs().max()) / scale
        assert rel < tol, (r, t_div, rel)
    assert agree >= n * batch // 2, agree
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MOL_CFGS))
@pytest.mark.parametrize("batch", [1, 11, 70])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_mol_kernel_matches_plain_version(cuda_device, name, batch, temperature):
    _mol_held_to_plain(cuda_device, MOL_CFGS[name], batch, 16, 11, temperature)


def _mol_published(dev):
    """``wavenet_mol_24k``'s decoder config and its plan on the card: 18 of
    30 layers resident, 12 read through L2 each step."""
    import json
    import pathlib

    from ae_wavenet_tpu_torch.utils import config as tcfg

    doc = (pathlib.Path(__file__).resolve().parent.parent
           / chip_smoke.MOL_CONFIG).read_text()
    cfg = tcfg.from_json(doc).wavenet
    assert json.loads(doc)["wavenet"]["n_mix"] == 10
    plan = tfc.device_plan(cfg, None, dev)
    assert (plan.resident_layers, plan.n_layers) == (18, 30)
    return cfg, plan


@pytest.mark.cuda
def test_mol_kernel_streams_layers_at_the_published_widths(cuda_device):
    """``wavenet_mol_24k``'s decoder (``_mol_published``); the counters take
    the launch's plan.  B = 2 on a random ring against the plain version at
    the flagship's tolerance."""
    cfg, plan = _mol_published(cuda_device)
    streamed = tfc.generate_fused.streamed_bytes
    for temperature in (0.0, 1.0):
        _mol_held_to_plain(cuda_device, cfg, 2, 12, 13, temperature, primed=False,
                           tol=chip_smoke.LOGIT_REL_TOL[None])
    assert tfc.generate_fused.resident_layers == 18
    assert tfc.generate_fused.streamed_bytes - streamed == 2 * 12 * plan.streamed_bytes


# the MoL cell's batch on a primed ring, the plain version run step by step
# on the kernel's own samples: a free-running comparison drifts with a
# continuous input
MOL_TIE_TOL = 0.02      # picks may differ only where two scores nearly tie (of max|logits|)
MOL_VALUE_TOL = 0.01    # kernel and plain samples where they pick one component
MOL_TAIL_TOL = 1e-5     # the kernel's samples against mol_draw of its own mixture
# the seeded post-net's last product rescaled so that the mixture is
# informative, as a trained vocoder's is (``benchmark/loops/vocode_mol``):
# the spread of the logits, the means and the log-scales over the batch's
# first step; each component's mean centred on its point of [-0.6, 0.6],
# each log-scale on -3
MOL_MIX_STD, MOL_MEAN_SPREAD, MOL_LOG_SCALE_CENTRE = (1.5, 0.1, 0.2), 0.6, -3.0


def _mol_pick(mix, n_mix: int, seed: int, rows, t_abs: int, temperature: float):
    """Each row's component scores [R, K] at step t_abs (the logits over the
    temperature plus the kernel's Gumbel draws, or the logits at 0) and the
    component drawn [R]."""
    sc = mix[:, :n_mix]
    if temperature > 0.0:
        sc = sc * (1.0 / temperature) + tfc.gumbel_noise(seed, rows, t_abs, n_mix)
    return sc, sc.argmax(1)


def _mol_teacher(packed, cfg, flat, prev, t0: int, cond, seed: int, temperature: float,
                 x):
    """The plain version step by step on the kernel's samples x [B, T] (its
    ring follows the kernel's inputs): its mixture [T, B, 3K] and its own
    draw [B, T] at each step."""
    ring, mixes, draws = flat.clone(), [], []
    for t in range(x.shape[1]):
        d, ring, _, m = tfc.generate_fused_reference(packed, cfg, ring, prev, t0 + t,
                                                     cond[..., t:t + 1], seed, temperature,
                                                     True)
        mixes.append(m[0])
        draws.append(d[:, 0])
        prev = x[:, t]
    return torch.stack(mixes), torch.stack(draws, 1)


def _mol_compare(cfg, seed: int, t0: int, temperature: float, got, want) -> dict:
    """The kernel's samples and mixture (``got``: samples [B, T], mix [T, B,
    3K]) against the plain version's on the same inputs (``want``, from
    :func:`_mol_teacher`), step by step: the largest mixture difference of
    each group (logits, means, log-scales) over that group's largest
    magnitude ("param"); where the two pick different components, the plain
    version's score gap between its pick and the kernel's over the largest
    logit's magnitude ("gap": temperatures up to 1 scale the logits' errors
    by at most that) and how many row-steps ("parted"); where they pick the
    same, the largest sample difference ("value")."""
    k = cfg.n_mix
    (x_a, mix_a), (x_b, mix_b) = got, want
    rows = torch.arange(x_a.shape[0], device=x_a.device)
    param = chip_smoke.mol_param_err(mix_a, mix_b, k)
    gap, parted, value = 0.0, 0, 0.0
    logit_max = float(mix_b[..., :k].abs().max())
    for t in range(x_a.shape[1]):
        sc_b, k_b = _mol_pick(mix_b[t], k, seed, rows, t0 + t, temperature)
        _, k_a = _mol_pick(mix_a[t], k, seed, rows, t0 + t, temperature)
        same = k_a == k_b
        gaps = sc_b.gather(1, k_b[:, None]) - sc_b.gather(1, k_a[:, None])
        gap = max(gap, float(gaps.max()) / logit_max)
        parted += int((~same).sum())
        value = max(value, float(torch.where(same, (x_a[:, t] - x_b[:, t]).abs(), 0.0).max()))
    return {"param": param, "gap": gap, "parted": parted, "value": value}


def _mol_passes(c: dict) -> bool:
    """The mixture parameters agree, the picks differ only at near-ties,
    and the samples agree where the picks do."""
    return (c["param"] < chip_smoke.MOL_PARAM_TOL and c["gap"] <= MOL_TIE_TOL
            and c["value"] <= MOL_VALUE_TOL)


@pytest.mark.cuda
def test_mol_kernel_teacher_forced_at_the_published_widths(cuda_device):
    """``fastgen_kernel<3>`` at ``wavenet_mol_24k``'s widths
    (``_mol_published``) and its cell's batch, MOL_B rows primed on rf + 1
    context samples, its mixture made informative: at T = 0 and 1 its
    samples are ``mol_draw`` of its own mixture (MOL_TAIL_TOL) and, against
    the plain version run on its samples (``_mol_teacher``),
    ``_mol_passes``; the counters move by the two launches' plan; the same
    check rejects a streamed layer's shares zeroed in the kernel (the first
    and the last) and the tail's mean taken from the next component in the
    plain version."""
    dev = cuda_device
    cfg, plan = _mol_published(dev)
    k, n_layers = cfg.n_mix, len(cfg.dilations)
    gen = torch.Generator().manual_seed(20)
    wn = twn.WaveNet(cfg, gen).to(dev)
    rf = sum(cfg.dilations)
    ctx = (torch.rand(MOL_B, rf + 1, generator=gen) * 1.2 - 0.6).to(dev)
    c_ctx = (torch.randn(MOL_B, cfg.n_lc_out, rf, generator=gen) * 0.3).to(dev)
    st = tfg.prime(wn, cfg, tfg.init_state(cfg, MOL_B, device=dev), ctx, c_ctx)
    flat, prev, t_ring = tfc.state_to_flat(st, cfg), st.prev_id, st.t
    cond = (torch.randn(MOL_B, cfg.n_lc_out, MOL_T, generator=gen) * 0.3).to(dev)
    mix0 = tfc.generate_fused_reference(tfc.pack_for_kernel(wn, cfg), cfg, flat.clone(),
                                        prev, t_ring, cond[..., :1], 0, 0.0, True)[3][0]
    centres = (None, torch.linspace(-MOL_MEAN_SPREAD, MOL_MEAN_SPREAD, k, device=dev),
               torch.full((k,), MOL_LOG_SCALE_CENTRE, device=dev))
    with torch.no_grad():
        for g, (sd, centre) in enumerate(zip(MOL_MIX_STD, centres)):
            part, w, b = slice(g * k, (g + 1) * k), wn.post2["w"], wn.post2["b"]
            gain = sd / float(mix0[:, part].std())
            w[part] *= gain
            b[part] *= gain
            if centre is not None:
                b[part] += centre - gain * mix0[:, part].mean(0)
    packed = tfc.pack_for_kernel(wn, cfg)
    assert type(packed) is tfc.MolKernelParams

    def run(temperature):
        return tfc.generate_fused(packed, cfg, flat.clone(), prev, t_ring, cond, 1234,
                                  temperature, True)

    def held(temperature, got) -> dict:
        mix_p, x_p = _mol_teacher(packed, cfg, flat, prev, t_ring, cond, 1234, temperature,
                                  got[0])
        return _mol_compare(cfg, 1234, t_ring, temperature, (got[0], got[3]), (x_p, mix_p))

    before = {n: getattr(tfc.generate_fused, n)
              for n in ("launches", "mol_launches", "streamed_bytes")}
    rows = torch.arange(MOL_B, device=dev)
    sound = {}
    for temperature in (0.0, 1.0):
        got = sound[temperature] = run(temperature)
        x_k, mix_k = got[0], got[3]
        assert x_k.dtype == torch.float32 and bool(torch.isfinite(mix_k).all())
        assert float(x_k.abs().max()) <= 1.0
        tail = max(float((x_k[:, t] - tfc.mol_draw(mix_k[t], k, cfg.log_scale_min, 1234,
                                                   rows, t_ring + t, temperature))
                         .abs().max()) for t in range(MOL_T))
        assert tail <= MOL_TAIL_TOL, (temperature, tail)
        c = held(temperature, got)
        assert _mol_passes(c), (temperature, c)
    assert {n: getattr(tfc.generate_fused, n) - v for n, v in before.items()} == {
        "launches": 2, "mol_launches": 2, "streamed_bytes": 2 * MOL_T * plan.streamed_bytes}
    assert tfc.generate_fused.resident_layers == 18

    real_shares, real_draw = tfc.pack_shares, tfc.mol_draw

    def zeroed(layer):
        def pack_shares(pk, pl):
            share = real_shares(pk, pl)
            for r in range(pl.n_blocks):
                a = pl.post_bytes(r) + layer * pl.layer_bytes(r)
                share[r, a:a + pl.layer_bytes(r)] = 0
            return share
        return pack_shares

    def next_mean(mix, n_mix, *a):
        m = mix.clone()
        m[:, n_mix:2 * n_mix] = mix[:, n_mix:2 * n_mix].roll(1, 1)
        return real_draw(m, n_mix, *a)

    from unittest import mock

    for temperature in (0.0, 1.0):
        for layer in (plan.resident_layers, n_layers - 1):  # the first and last streamed
            with mock.patch.object(tfc, "pack_shares", zeroed(layer)):
                got = run(temperature)
            assert not _mol_passes(held(temperature, got)), (temperature, layer)
        with mock.patch.object(tfc, "mol_draw", next_mean):
            c = held(temperature, sound[temperature])
        assert not _mol_passes(c), (temperature, "next component's mean")


@pytest.mark.cuda
def test_mol_kernel_chunk_carry_and_same_bits_twice(cuda_device):
    cfg = MOL_CFGS["scalar"]
    packed, flat, prev, t0, cond = _mol_setup(cuda_device, cfg, 11, 24, 12)

    def run(ring, p, t, c):
        return tfc.generate_fused(packed, cfg, ring, p, t, c, 3, 1.0)

    whole = run(flat.clone(), prev, t0, cond)[0]
    assert torch.equal(whole, run(flat.clone(), prev, t0, cond)[0])
    a, ring, last = run(flat.clone(), prev, t0, cond[..., :10])
    b = run(ring, last, t0 + 10, cond[..., 10:])[0]
    assert torch.equal(whole, torch.cat([a, b], 1))
    with pytest.raises(ValueError, match="bf16 weights only"):
        tfc.generate_fused(packed, cfg, flat, prev, t0, cond, 3, 1.0, quantized="int8")
    with pytest.raises(ValueError, match="prev_id"):
        tfc.generate_fused(packed, cfg, flat, prev.double(), t0, cond, 3, 1.0)


# ------------------------------------------------ the fused VQ lookup

from ae_wavenet_tpu_torch.ops import vq_cuda  # noqa: E402


def _kernels_of(fn) -> list:
    """Names of the device operations (kernels, copies, fills) of one fn()
    call, after a warm-up call, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _vq_held(z, e):
    """The fused VQ lookup on (z, e) against its plain version: codes equal
    except on near-ties (``chip_smoke.vq_codes_agree``), quant the codebook
    rows bit for bit, counts exact, sums within VQ_SUM_TOL of the largest of
    float64 sums over the kernel's own codes (and, where every code agrees,
    of the plain version's), the same bits on a second launch, the same
    codes and rows without the statistics, and one device operation per
    call with and without them.  -> the kernel's codes."""
    k = e.shape[0]
    before = vq_cuda.vq_lookup_fused.launches
    got = vq_cuda.vq_lookup_fused(z, e)
    again = vq_cuda.vq_lookup_fused(z, e)
    want = vq_cuda.vq_lookup_reference(z, e)
    torch.cuda.synchronize()
    assert vq_cuda.vq_lookup_fused.launches == before + 2
    for stats in (True, False):
        ops = _kernels_of(lambda: vq_cuda.vq_lookup_fused(z, e, stats=stats))
        assert len(ops) == 1 and "vq_kernel" in ops[0], (stats, ops)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    codes = got[0].long()
    assert int(codes.min()) >= 0 and int(codes.max()) < k
    assert chip_smoke.vq_codes_agree(z, e, codes, want[0].long())
    assert torch.equal(got[1], e[codes])
    assert torch.equal(got[2], torch.bincount(codes, minlength=k).float())
    assert chip_smoke.vq_sums_err(z, codes, got[3])[1] <= chip_smoke.VQ_SUM_TOL
    if bool((codes == want[0].long()).all()):
        assert chip_smoke.max_abs_rel(got[3], want[3])[1] <= chip_smoke.VQ_SUM_TOL
    lean = vq_cuda.vq_lookup_fused(z, e, stats=False)
    assert torch.equal(lean[0], got[0]) and torch.equal(lean[1], got[1])
    assert lean[2] is None and lean[3] is None
    return codes


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(512, 128, 64), (301, 128, 64), (37, 100, 30),
                                   (5, 700, 8), (1, 512, 64), (27, 512, 64),
                                   (640, 512, 64), (4099, 512, 64),
                                   (4096, 4096, 64), (16384, 8192, 64)])
def test_vq_kernel_matches_plain_version(cuda_device, n, k, d):
    """``_vq_held`` on random latents: ragged N, K above one pass of the
    block and a D off the 16-byte path; one row and N past one chunk of the
    statistics' scan at the flagship K and D; ``scripts/bench_vq.py``'s
    largest codebooks (K = 4,096 at N = 4,096, K = 8,192 at N = 16,384:
    every warp owns several codes)."""
    gen = torch.Generator().manual_seed(n)
    z = (torch.randn(n, d, generator=gen) * 0.5).to(cuda_device)
    e = (torch.randn(k, d, generator=gen) / d ** 0.5).to(cuda_device)
    _vq_held(z, e)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["serving request", "training step"])
def test_vq_kernel_matches_plain_version_on_the_encoders_latents(cuda_device, tmp_path,
                                                                 case):
    """``_vq_held`` on a seeded ``chorowski`` model's codebook and its
    encoder's latents at the N of the serving request and of the training
    step (``chip_smoke.vq_cases``); the same check rejects a planted fault:
    |e|^2 dropped from the distances."""
    from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset

    data = str(tmp_path / "synth")
    make_synthetic_dataset(data, n_clips=2, n_speakers=2, clip_len=(12400, 14000), seed=0)
    e, cases = chip_smoke.vq_cases(cuda_device, data)
    z = cases[case]
    codes = _vq_held(z, e)
    assert not chip_smoke.vq_codes_agree(z, e, codes, (-2.0 * (z @ e.t())).argmin(1))


@pytest.mark.cuda
def test_vq_kernel_takes_the_first_index_on_ties(cuda_device):
    e = torch.tensor([[1.0, 0.0], [0.0, 1.0]], device=cuda_device).repeat(300, 1)
    z = torch.tensor([[2.0, 0.0], [0.0, 2.0], [0.5, 0.5]], device=cuda_device)
    codes, quant, counts, sums = vq_cuda.vq_lookup_fused(z, e)
    assert codes.tolist() == [0, 1, 0]
    assert torch.equal(quant, e[codes.long()])
    assert counts[:2].tolist() == [2.0, 1.0] and float(counts.sum()) == 3.0
    assert sums[0].tolist() == [2.5, 0.5]
    # without the statistics: the same codes and rows
    lean = vq_cuda.vq_lookup_fused(z, e, stats=False)
    assert torch.equal(lean[0], codes) and torch.equal(lean[1], quant)
    assert lean[2] is None and lean[3] is None


@pytest.mark.cuda
def test_vq_kernel_rejects_what_it_cannot_take(cuda_device):
    z = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        vq_cuda.vq_lookup_fused(z, torch.zeros(5, 8, device=cuda_device).double())
    with pytest.raises(ValueError, match="cpu"):
        vq_cuda.vq_lookup_fused(z, torch.zeros(5, 8))
    with pytest.raises(ValueError, match="256"):
        vq_cuda.vq_lookup_fused(torch.zeros(4, 300, device=cuda_device),
                                torch.zeros(5, 300, device=cuda_device))


@pytest.mark.cuda
def test_bottleneck_on_card_goes_through_the_vq_kernel(cuda_device):
    from ae_wavenet_tpu_torch.models import bottlenecks as tbn
    from ae_wavenet_tpu_torch.utils.config import BottleneckConfig

    cfg = BottleneckConfig(kind="vq", n_dim=16, vq_k=32, vq_use_pallas=True)
    bn = tbn.make(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    z = torch.randn(2, 16, 30, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = (vq_cuda.vq_lookup_fused.launches, vq_cuda.vq_lookup_reference.launches)
    zq = bn(z)
    zq_t, aux = bn.train_apply(z, 5, True, torch.Generator(cuda_device).manual_seed(2))
    torch.cuda.synchronize()
    assert vq_cuda.vq_lookup_fused.launches == before[0] + 2
    assert vq_cuda.vq_lookup_reference.launches == before[1]
    assert zq.shape == z.shape and bool(torch.isfinite(zq_t).all())
    assert bool(torch.isfinite(aux["perplexity"]))


# ------------------------------------------------ the gated training stack

import gated_check as gchk  # noqa: E402
from ae_wavenet_tpu_torch.ops import gated as tgt  # noqa: E402
from ae_wavenet_tpu_torch.ops import gated_cuda as tgc  # noqa: E402

# the tiny preset's widths (n_res 32, cond 32 + 8: not multiples of 64),
# dilations up to 128 (above the kernels' 64-row tile), a ragged T
GCFG = WaveNetConfig(n_blocks=1, n_block_layers=8, n_res=32, n_dil=32,
                     n_skp=32, n_post=32, n_lc_in=16, n_lc_out=32,
                     n_global_embed=8, n_speakers=10)
SEGMENTS = ["gated_pair_fused", "gated_pair_fused_near", "gated_layer_fused",
            "gated_pair_bwd", "gated_pair_bwd_near", "gated_layer_bwd",
            "gated_layer_bwd_recompute", "gated_stack_fused", "gated_stack_fused_no_save",
            "gated_group_bwd", "gated_group_bwd_3"]
# (batch, loss samples) at the ``chorowski`` widths: a short ragged T (4,100
# = 64 x 64 + 4), and the training path's shape (every block of the card at
# work, rows handed between blocks, the full split-K)
FLAGSHIP_SHAPES = {"b2x4100": (2, 4100), "b4x48k": (4, 48000)}


def _segment_case(width, name, dev):
    """(wrapper name, call(fn)) of ``segment_calls``'s case ``name`` on a
    seeded stack: GCFG at B = 3 x 150, or the ``chorowski`` widths at a
    FLAGSHIP_SHAPES shape."""
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    cfg, (batch, t_out) = ((GCFG, (3, 150)) if width == "narrow" else
                           (chorowski_config().wavenet, FLAGSHIP_SHAPES[width]))
    wn, ids, cond, spk = chip_smoke.random_stack(cfg, batch, t_out, 0, dev)
    dils, _, cond_tm, packed, xs, ys, cot = chip_smoke.segment_inputs(wn, cfg, ids, cond, spk)
    return chip_smoke.segment_calls(dils, cond_tm, packed, xs, ys, cot)[name]


def _held_against_plain(cfg, batch, t_out, name, dev):
    """Every output of kernel case ``name`` within chip_smoke.SEGMENT_REL_TOL of
    its plain version's largest value, on the same inputs; the pair
    backward with as many tiles in flight as its plan from the widths; the
    pair backward, the grouped backward and the whole-stack forward give the
    same bits on a second launch (one owner per output row, fixed-order
    sums)."""
    wn, ids, cond, spk = chip_smoke.random_stack(cfg, batch, t_out, 0, dev)
    dils, _, cond_tm, packed, xs, ys, cot = chip_smoke.segment_inputs(wn, cfg, ids,
                                                                cond, spk)
    wrapper, call = chip_smoke.segment_calls(dils, cond_tm, packed, xs, ys, cot)[name]
    fn = getattr(tgc, wrapper)
    before = fn.launches
    got = call(fn)
    if wrapper == "gated_pair_bwd":
        assert fn.tiles_in_flight == tgc.bwd_plan(cfg.n_res, cfg.n_dil, cfg.n_skp)[0]
    want = call(getattr(tgt, wrapper + "_reference"))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    if name in ("gated_pair_bwd", "gated_group_bwd", "gated_stack_fused"):
        assert all(torch.equal(a, b) for a, b in zip(got, call(fn)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(torch.isfinite(g.float()).all())
    _, rel = chip_smoke.compare_outputs(got, want)
    assert rel < chip_smoke.segment_tolerance(name), rel
    if name == "gated_stack_fused":  # and each layer on the kernel's own streams
        _, rel = chip_smoke.compare_outputs(
            got, gchk.stack_layerwise(got, dils, cond_tm, packed, xs[0]))
        assert rel < chip_smoke.SEGMENT_REL_TOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEGMENTS)
def test_gated_kernel_matches_plain(cuda_device, name):
    """Every output of each kernel within chip_smoke.SEGMENT_REL_TOL of its plain
    version's largest value, on the same inputs."""
    _held_against_plain(GCFG, 3, 150, name, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(FLAGSHIP_SHAPES))
@pytest.mark.parametrize("name", SEGMENTS)
def test_gated_kernel_matches_plain_at_flagship_width(cuda_device, name, shape):
    """The Hopper kernels at the ``chorowski`` widths (n_res 384, cond 160,
    n_dil 256, n_skp 256: the tile shapes of the main path) at each
    FLAGSHIP_SHAPES shape: the pair and single-layer kernels (the recompute
    mode's xin, 2 x 384 + 160 wide, is the largest tile, with the fewest
    ring stages beside it), the pair below one tile's reach (two tiles in
    flight at these widths), the whole stack's 20 layers and groups of 5
    and 3."""
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    _held_against_plain(chorowski_config().wavenet, *FLAGSHIP_SHAPES[shape], name,
                        cuda_device)


def _same_bits_twice(name, dev):
    """Two launches of kernel case ``name`` on the same inputs give every
    output bit for bit."""
    wn, ids, cond, spk = chip_smoke.random_stack(GCFG, 3, 150, 0, dev)
    dils, _, cond_tm, packed, xs, ys, cot = chip_smoke.segment_inputs(wn, GCFG, ids,
                                                                cond, spk)
    wrapper, call = chip_smoke.segment_calls(dils, cond_tm, packed, xs, ys, cot)[name]
    got = call(getattr(tgc, wrapper))
    again = call(getattr(tgc, wrapper))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gated_pair_bwd", "gated_layer_bwd",
                                  "gated_layer_bwd_recompute", "gated_group_bwd"])
def test_gated_backward_gives_the_same_bits_twice(cuda_device, name):
    """Fixed-order split-K sums (and in the grouped backward one owner block
    per row): a second launch on the same inputs gives every output bit for
    bit."""
    _same_bits_twice(name, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gated_stack_fused", "gated_stack_fused_no_save"])
def test_gated_whole_stack_forward_gives_the_same_bits_twice(cuda_device, name):
    """The whole-stack forward: every output row has one owner block, which
    adds the layers' skip terms in layer order, so a second launch on the
    same inputs gives every output bit for bit."""
    _same_bits_twice(name, cuda_device)


def _first_row(name, dils) -> int:
    """The first row of ``segment_calls``'s case ``name``'s tiles."""
    if name.startswith("gated_stack_fused"):
        return tgt.valid_lo(dils, 0)
    hi = max(range(len(dils) - 1), key=lambda i: (dils[i], -i))
    return tgt.valid_lo(dils, max(hi + 1 - 5, 0))  # the group of up to 5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gated_stack_fused", "gated_group_bwd"])
def test_gated_whole_stack_kernels_with_blocks_idle_in_the_last_round(cuda_device,
                                                                       name):
    """One tile more than the card holds blocks (B = 1), a single row in the
    last tile: in each layer's second round every block but block 0 is
    idle, and still meets each grid barrier."""
    kind = "stack" if name.startswith("gated_stack") else "group"
    n_cond = GCFG.n_lc_out + GCFG.n_global_embed
    dims = [1, 1, GCFG.n_res, n_cond, GCFG.n_dil, GCFG.n_skp]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    capacity = sms * tgc._per_sm(kind, dims)
    rows = tgc.TM * capacity + 1
    t_out = rows + _first_row(name, tgt.stack_dils(GCFG)) - twn.receptive_field(GCFG)
    grid, n_tiles, most = tgc.coop_plan(rows, 1, sms, capacity // sms)
    assert (grid, n_tiles, most) == (capacity, capacity + 1, 2)
    _held_against_plain(GCFG, 1, t_out, name, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gated_stack_fused", "gated_group_bwd"])
def test_gated_whole_stack_kernels_at_the_deepest_launch(cuda_device, name):
    """As many layers in one launch as ``awt_gated_max_fused_layers`` allows
    (the per-layer tables fill the kernel's parameters) against the plain
    version, and the same bits on a second launch.  The whole-stack forward
    is held layer by layer on its own streams (SEGMENT_REL_TOL) and from x0
    (DRIFT_REL_TOL).  The group's cotangents cross that many layers of bf16
    rounding points (g_out, g_y) in one launch and drift from the plain
    version's as the forward does from x0, whatever the tile core: every
    output is held at DRIFT_REL_TOL, and the top five layers' weight
    gradients, before the drift, at SEGMENT_REL_TOL."""
    from ae_wavenet_tpu_torch.ops import _build

    most = _build.load().awt_gated_max_fused_layers()
    cfg = dataclasses.replace(GCFG, n_blocks=-(-(most + 1) // GCFG.n_block_layers))
    wn, ids, cond, spk = chip_smoke.random_stack(cfg, 2, 150, 0, cuda_device)
    dils, x0, cond_tm, packed, xs, ys, cot = chip_smoke.segment_inputs(wn, cfg, ids, cond,
                                                                 spk)
    vl = lambda m: tgt.valid_lo(dils, m)  # noqa: E731
    skip_in = chip_smoke.skip0(x0, packed, 1)
    if name == "gated_stack_fused":
        dils, packed = dils[:most], packed[:most]

        def call(fn):
            skip, mids, ys_all = fn(x0, cond_tm, skip_in.clone(), packed, dils=dils,
                                    r0=vl(0), save_y=True)
            return (skip, *mids, *ys_all)
    else:
        i, k = len(dils) - 1 - most, len(dils) - 1

        def call(fn):
            c = {n: v.clone() for n, v in cot.items()}
            return fn(tuple(xs[i:k]), cond_tm, c["gxcur"], c["gxprev"], c["gskip"],
                      c["gcond"], tuple(packed[i:k]), tuple(ys[i:k]),
                      dds=tuple(dils[i:k]), prev_dd=dils[k],
                      valid_los=tuple(vl(m) for m in range(i, k)), cur_valid_lo=vl(k))
    fn = getattr(tgc, name)
    got, again = call(fn), call(fn)
    want = call(getattr(tgt, name + "_reference"))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    _, rel = chip_smoke.compare_outputs(got, want)
    assert rel < chip_smoke.DRIFT_REL_TOL, rel
    if name == "gated_stack_fused":
        _, rel = chip_smoke.compare_outputs(
            got, gchk.stack_layerwise(got, dils, cond_tm, packed, x0))
    else:  # (gxc, gxp, gcond, then dW_in, db_in, dW_out, db_out per layer, lowest first)
        _, rel = chip_smoke.compare_outputs(got[-4 * 5:], want[-4 * 5:])
    assert rel < chip_smoke.SEGMENT_REL_TOL, rel


@pytest.mark.cuda
def test_gated_hopper_kernels_refuse_widths_they_cannot_take(cuda_device):
    """A width whose tiles pass one block's shared memory (n_res 1536: xin
    and g_out alone) and one off the 16-byte rows raise ValueError; nothing
    falls back."""
    bf, dev = torch.bfloat16, cuda_device

    def operands(r, c=40, d=32, s=32, b=1, p=80):
        pk = (torch.zeros(2 * r + c, 2 * d, device=dev), torch.zeros(2 * d, device=dev),
              torch.zeros(d, r + s, device=dev), torch.zeros(r + s, device=dev))
        x = torch.zeros(b, p, r, dtype=bf, device=dev)
        return dict(x=x, cond=torch.zeros(b, p, c, dtype=bf, device=dev),
                    skip=torch.zeros(b, p, s, device=dev), pk=pk,
                    gskip=torch.zeros(b, p, s, dtype=bf, device=dev),
                    gcond=torch.zeros(b, p, c, device=dev),
                    y=torch.zeros(b, p, 2 * d, dtype=bf, device=dev))

    for r, match in ((1536, "shared memory"), (36, "multiples of 8")):
        o = operands(r)
        with pytest.raises(ValueError, match=match):
            tgc.gated_pair_fused(o["x"], o["cond"], o["skip"], o["pk"], o["pk"],
                                 dd1=1, dd2=2, r0=3)
        with pytest.raises(ValueError, match=match):
            tgc.gated_pair_bwd(o["x"], o["x"], o["cond"], o["x"], o["x"], o["gskip"],
                               o["gcond"], o["pk"], o["pk"], o["y"], o["y"], dd1=1,
                               dd2=2, prev_dd=4, valid_lo1=1, valid_lo2=3,
                               cur_valid_lo=7)


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["narrow", *sorted(FLAGSHIP_SHAPES)])
@pytest.mark.parametrize("name", sorted(gchk.planted_segment_faults()))
def test_gated_kernel_rejects_planted_fault(cuda_device, name, width):
    """A fault planted in the plain version fails the kernel's own check,
    at GCFG's widths and at the flagship's shapes."""
    segment, bad = gchk.planted_segment_faults()[name]
    wrapper, call = _segment_case(width, segment, cuda_device)
    _, rel = chip_smoke.compare_outputs(call(getattr(tgc, wrapper)), call(bad))
    assert rel >= chip_smoke.SEGMENT_REL_TOL, rel


# K1b's three-tap mode: (batch, rows, width, n_cond, cond layers, the layer
# whose slice is the addend); "published" is WaveGlow's 256 / 256 / 256 with
# a layer's 512-wide slice of the 640 -> 4,096 projection, over a ragged P
THREE_TAP = {"narrow": (3, 300, 32, 48, 2, 1), "published": (2, 4100, 256, 640, 8, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("width", sorted(THREE_TAP))
@pytest.mark.parametrize("dd", [1, 128])
@pytest.mark.parametrize("addend", [False, True])
def test_three_tap_layer_matches_plain(cuda_device, width, dd, addend):
    """K1b's non-causal three-tap mode (WaveGlow's layer) against its plain
    version: every output within SEGMENT_REL_TOL of the plain version's
    largest, and so the first and the last dd rows alone (where one tap
    reads the zero padding); one launch, ``taps`` 3; the same plain version
    with the +dd tap dropped is refused on the last dd rows' neighbours."""
    b, p, w, n_cond, layers, layer = THREE_TAP[width]
    inp = chip_smoke.three_tap_inputs(b, p, w, 1, cuda_device, addend, n_cond, layers, layer)
    before = tgc.gated_layer_fused.launches
    got = chip_smoke.three_tap_call(tgc.gated_layer_fused, inp, dd)
    torch.cuda.synchronize()
    assert tgc.gated_layer_fused.launches == before + 1
    assert tgc.gated_layer_fused.taps == 3
    want = chip_smoke.three_tap_call(tgt.gated_layer_fused_reference, inp, dd)
    for g, v in zip(got, want):
        assert g.shape == v.shape and g.dtype == v.dtype
        assert bool(torch.isfinite(g.float()).all())
    for rows in (slice(None), slice(0, dd), slice(p - dd, p)):
        _, rel = chip_smoke.compare_outputs([t[:, rows] for t in got],
                                            [t[:, rows] for t in want])
        assert rel < chip_smoke.SEGMENT_REL_TOL, (rows, rel)
    dropped = dict(inp, w_in=inp["w_in"].clone())
    dropped["w_in"][2 * w :] = 0
    bad = chip_smoke.three_tap_call(tgt.gated_layer_fused_reference, dropped, dd)
    _, rel = chip_smoke.compare_outputs([t[:, : p - dd] for t in got],
                                        [t[:, : p - dd] for t in bad])
    assert rel >= chip_smoke.SEGMENT_REL_TOL, rel


def _config_widths(name):
    """(n_res, n_cond, n_dil, n_skp) of a benchmark configuration's stack."""
    import pathlib

    from ae_wavenet_tpu_torch.utils import config as tcfg

    doc = (pathlib.Path(__file__).resolve().parent.parent / "benchmark/configs"
           / f"{name}.json").read_text()
    w = tcfg.from_json(doc).wavenet
    return w.n_res, w.n_lc_out + w.n_global_embed, w.n_dil, w.n_skp


def _pair_bwd_held(dev, widths, batch, rows, dd1, dd2, prev_dd=4, seed=0):
    """The pair backward on random operands of these widths (saved y, every
    bias), ``rows`` rows from valid_lo1 of each of ``batch`` rows, against
    its plain version at SEGMENT_REL_TOL and the same bits on a second
    launch.  -> the launch's tiles in flight."""
    r, c, d, s = widths
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)

    f32 = torch.float32

    def weights():
        return (rnd(2 * r + c, 2 * d, scale=(2 * r + c) ** -0.5, dtype=f32),
                rnd(2 * d, scale=0.3, dtype=f32), rnd(d, r + s, scale=d ** -0.5, dtype=f32),
                rnd(r + s, scale=0.3, dtype=f32))

    vl1 = 5 + dd1
    vl2, p = vl1 + dd2, vl1 + rows
    x1, x2, cond = rnd(batch, p, r), rnd(batch, p, r), rnd(batch, p, c)
    y1, y2 = rnd(batch, p, 2 * d), rnd(batch, p, 2 * d)
    pk1, pk2 = weights(), weights()
    cot = dict(gxcur=rnd(batch, p, r, scale=0.1), gxprev=rnd(batch, p, r, scale=0.1),
               gskip=rnd(batch, p, s, scale=0.1), gcond=rnd(batch, p, c, scale=0.1, dtype=f32))

    def call(fn):
        k = {n: v.clone() for n, v in cot.items()}
        return fn(x1, x2, cond, k["gxcur"], k["gxprev"], k["gskip"], k["gcond"], pk1,
                  pk2, y1, y2, dd1=dd1, dd2=dd2, prev_dd=prev_dd, valid_lo1=vl1,
                  valid_lo2=vl2, cur_valid_lo=vl2 + prev_dd)

    got = call(tgc.gated_pair_bwd)
    tiles = tgc.gated_pair_bwd.tiles_in_flight
    again = call(tgc.gated_pair_bwd)
    want = call(tgt.gated_pair_bwd_reference)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    _, rel = chip_smoke.compare_outputs(got, want)
    assert rel < chip_smoke.SEGMENT_REL_TOL, rel
    return tiles


def _tiles_per_chunk(dev, widths, batch, tiles, ragged, kind="bwd2", dd2=0):
    """Rows per batch row for which the chunks of the kernel ``kind`` (one
    wave of blocks over the card; by default the pair backward's) hold
    ``tiles`` tiles each, the last chunk's top tile ``ragged`` rows short."""
    r, c, d, s = widths
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = tgc._per_sm(kind, [batch, 1, r, c, d, s])
    per_row = sms * per_sm // batch
    rows = per_row * tiles * tgc.TM - ragged
    assert tgc._chunk(rows, batch, dd2, sms, per_sm) == (tiles * tgc.TM, per_row)
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["chorowski_vq", "mfcc_inverter"])
def test_pair_bwd_keeps_two_tiles_in_flight_at_the_training_widths(cuda_device, config):
    """The flagship's and the inverter's stack widths (n_res 384, n_skp 256,
    n_dil 256): two g_out tiles and two ring stages fit, so the pair backward
    keeps two tiles in flight, one per consumer warpgroup, and the launch
    takes that plan; held to the plain version at B = 2, 4,100 rows (a
    ragged last tile), dd2 = 128 (a two-tile halo)."""
    widths = _config_widths(config)
    assert tgc.bwd_plan(widths[0], widths[2], widths[3]) == (2, 2, 230464)
    assert _pair_bwd_held(cuda_device, widths, 2, 4100, 64, 128, prev_dd=256) == 2


@pytest.mark.cuda
def test_pair_bwd_keeps_one_tile_in_flight_at_the_mol_widths(cuda_device):
    """``wavenet_mol_24k``'s stack (n_res 512): two g_out tiles leave one
    ring stage, so the pair backward keeps one tile in flight, both consumer
    warpgroups on it, as the other backward kernels do; held to the plain
    version."""
    widths = _config_widths("wavenet_mol_24k")
    assert tgc.bwd_plan(widths[0], widths[2], widths[3])[0] == 1
    assert _pair_bwd_held(cuda_device, widths, 2, 4100, 256, 512, prev_dd=1) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dd2", [2, 32, 64, 96, 128, 256])
def test_pair_bwd_carry_between_the_tiles_in_flight(cuda_device, dd2):
    """Four tiles to each chunk (two pairs of tiles in flight), the last
    chunk's top tile ragged: layer 1 of a tile reads the prev-tap
    cotangents that layer 2 of the tile above (the other warpgroup's, for
    dd2 < 128) or of the tiles above that wrote, and those of the halo
    above the chunk."""
    widths = (32, 40, 32, 32)
    rows = _tiles_per_chunk(cuda_device, widths, 2, 4, 37)
    assert _pair_bwd_held(cuda_device, widths, 2, rows, dd2 // 2 or 1, dd2) == 2


@pytest.mark.cuda
def test_pair_bwd_with_an_odd_tile_count_and_a_ragged_last_tile(cuda_device):
    """Three tiles to each chunk: the second pair of tiles in flight has one
    tile, which warpgroup 0 runs alone; the last chunk's top tile is ragged
    (its rows the pair backward takes first)."""
    widths = (32, 40, 32, 32)
    rows = _tiles_per_chunk(cuda_device, widths, 1, 3, 28)
    assert _pair_bwd_held(cuda_device, widths, 1, rows, 16, 32) == 2


def _pair_fwd_held(dev, widths, batch, rows, dd1, dd2, seed=0):
    """The pair forward on random operands of these widths (saved y, every
    bias), ``rows`` rows from r0 of each of ``batch`` rows, against its plain
    version at SEGMENT_REL_TOL and the same bits on a second launch; with its
    epilogue staged, bit for bit the launch whose plan is forced to store
    from the registers.  -> the launch's plan (``staged_epilogue``)."""
    from unittest import mock

    r, c, d, s = widths
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)

    f32 = torch.float32

    def weights():
        return (rnd(2 * r + c, 2 * d, scale=(2 * r + c) ** -0.5, dtype=f32),
                rnd(2 * d, scale=0.3, dtype=f32), rnd(d, r + s, scale=d ** -0.5, dtype=f32),
                rnd(r + s, scale=0.3, dtype=f32))

    r0 = 5 + dd1
    p = r0 + rows
    x, cond, skip = rnd(batch, p, r), rnd(batch, p, c), rnd(batch, p, s, dtype=f32)
    pk1, pk2 = weights(), weights()

    def call(fn):
        return fn(x, cond, skip.clone(), pk1, pk2, dd1=dd1, dd2=dd2, r0=r0, save_y=True)

    got = call(tgc.gated_pair_fused)
    staged = tgc.gated_pair_fused.staged_epilogue
    again = call(tgc.gated_pair_fused)
    want = call(tgt.gated_pair_fused_reference)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    _, rel = chip_smoke.compare_outputs(got, want)
    assert rel < chip_smoke.SEGMENT_REL_TOL, rel
    if staged:
        with mock.patch.object(tgc, "fwd_plan", lambda *w: (False, 0, 0)):
            regs = call(tgc.gated_pair_fused)
        assert tgc.gated_pair_fused.staged_epilogue == 0
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, regs))
    return staged


# (n_res, n_cond, n_dil, n_skp) that the staged epilogue does not take
# (n_res 576: not a multiple of 128, and its slots and two ring stages would
# not fit beside xin): the pair forward stores from the registers
UNSTAGED_WIDTHS = (576, 80, 256, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["chorowski_vq", "mfcc_inverter", "wavenet_mol_24k",
                                    "unstaged"])
def test_gated_kernel_matches_plain_pair_forward_at_the_configurations_widths(cuda_device,
                                                                             config):
    """The three configurations' stacks (n_res 384 and 512) stage the pair
    forward's epilogue (``fwd_plan``), and widths it does not take store
    from the registers; held to the plain version at
    B = 2, 4,100 rows (a ragged last tile), dd2 = 128 (a two-tile halo), and
    staged, bit for bit the launch that stores from the registers."""
    widths = UNSTAGED_WIDTHS if config == "unstaged" else _config_widths(config)
    r, c, d, s = widths
    plan = tgc.fwd_plan(r, d, s, c)
    assert plan[0] == (config != "unstaged") and plan[1] == 2
    assert _pair_fwd_held(cuda_device, widths, 2, 4100, 64, 128) == int(plan[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dd2", [2, 32, 64, 96, 128, 512])
def test_gated_kernel_matches_plain_pair_forward_dilations(cuda_device, dd2):
    """The staged pair forward at the flagship's widths, eight tiles to each
    chunk, the last chunk's top tile ragged, B = 2: layer 2 reads rows of mid
    that layer 1 stored from the same tile (dd2 < 64), from the tiles below
    and from the halo below the chunk; each tile's skip rows pass through
    both layers' slots."""
    widths = _config_widths("chorowski_vq")
    rows = _tiles_per_chunk(cuda_device, widths, 2, 8, 37, kind="fwd2", dd2=dd2)
    assert _pair_fwd_held(cuda_device, widths, 2, rows, dd2 // 2 or 1, dd2) == 1


@pytest.mark.cuda
def test_gated_kernel_gate_near_zero_matches_plain(cuda_device):
    """Filter pre-activations planted at |v| <= 1e-5 (w_in zero, so y is the
    bias; gate 0, so sigmoid is 1/2) through K1b, and w_out routing h alone
    into skip: h = bf16(tanh(v) / 2) equals the plain version's bit for bit.
    The gate's fast tanh, 1 - 2 / (e^{2v} + 1), cancels there (relative
    error 1e-3 at 1e-5, 5e-2 at 1e-6: above bf16's half-ulp)."""
    cfg, dev, batch, p_len = GCFG, cuda_device, 2, 150
    n_res, n_dil, n_skp = cfg.n_res, cfg.n_dil, cfg.n_skp
    n_cond = cfg.n_lc_out + cfg.n_global_embed
    assert n_dil == n_skp
    gen = torch.Generator().manual_seed(4)
    mag = 10.0 ** (-7.0 + 2.0 * torch.rand(n_dil, generator=gen))
    sign = torch.where(torch.rand(n_dil, generator=gen) < 0.5, -1.0, 1.0)
    w_in = torch.zeros(2 * n_res + n_cond, 2 * n_dil)
    b_in = torch.cat([sign * mag, torch.zeros(n_dil)])
    w_out = torch.cat([torch.zeros(n_dil, n_res), torch.eye(n_dil)], 1)
    b_out = torch.zeros(n_res + n_skp)
    x = torch.randn(batch, p_len, n_res, generator=gen).to(torch.bfloat16)
    cond = torch.randn(batch, p_len, n_cond, generator=gen).to(torch.bfloat16)
    args = [t.to(dev) for t in (x, cond)]
    weights = [t.to(dev) for t in (w_in, b_in, w_out, b_out)]
    skips = []
    for fn in (tgc.gated_layer_fused, tgt.gated_layer_fused_reference):
        skip = torch.zeros(batch, p_len, n_skp, device=dev)
        fn(*args, skip, *weights, dd=1, r0=1)
        skips.append(skip[:, 1:])
    torch.cuda.synchronize()
    want = (torch.tanh(b_in[:n_dil].double()) * 0.5).to(torch.bfloat16).float()
    assert torch.equal(skips[1][0, 0].cpu(), want)
    assert torch.equal(skips[0], skips[1])


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["narrow", "flagship"])
@pytest.mark.parametrize("save_y", [True, False])
@pytest.mark.parametrize("fuse_pairs", [True, False])
@pytest.mark.parametrize("full_fusion", [False, True])
@pytest.mark.parametrize("grouped", [False, True])
def test_gated_stack_matches_plain(cuda_device, width, save_y, fuse_pairs, full_fusion,
                                   grouped):
    """The whole stack through GatedStack with the kernels against the same
    schedule with the plain versions: logits and every gradient, and faults
    planted in the plain versions rejected.  GCFG at B = 2 x 150 with
    groups of 3, and the ``chorowski`` widths at B = 2 x 4,100 with groups
    of 5."""
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    cfg, t_out, group = ((GCFG, 150, 3) if width == "narrow" else
                         (chorowski_config().wavenet, 4100, 5))
    wn, ids, cond, spk = chip_smoke.random_stack(cfg, 2, t_out, 1, cuda_device)
    probe = torch.randn(2, t_out, cfg.n_quant, device=cuda_device)
    sched = dict(full_fusion=full_fusion, bwd_group=group if grouped else 0)
    if grouped and not save_y:
        with pytest.raises(ValueError, match="gated_save_y"):
            gchk.stack_run(wn, cfg, ids, cond, spk, probe, None, save_y,
                           fuse_pairs, **sched)
        return
    n = len(cfg.dilations)  # runs of 3 layers or more go to the grouped kernel
    counted = {tgc.gated_stack_fused: int(full_fusion),
               tgc.gated_group_bwd: sum(min(group, n - i) >= 3 for i in range(0, n, group))
               if grouped else 0}
    before = {f: f.launches for f in counted}
    lg_k, g_k = gchk.stack_run(wn, cfg, ids, cond, spk, probe, None, save_y,
                               fuse_pairs, **sched)
    assert {f: f.launches - before[f] for f in counted} == counted
    lg_p, g_p = gchk.stack_run(wn, cfg, ids, cond, spk, probe, tgt.PLAIN,
                               save_y, fuse_pairs, **sched)
    lg, rel = gchk.stack_errors(lg_k, g_k, lg_p, g_p)
    assert gchk.stack_passes(lg, rel), (lg, rel)
    for name, (wn_bad, ops, kw) in gchk.planted_faults(wn, cfg).items():
        if kw["full_fusion"] != full_fusion or ("pair" in name and not fuse_pairs):
            continue  # that fault sits in a kernel this schedule does not run
        lg_f, g_f = gchk.stack_run(wn_bad, cfg, ids, cond, spk, probe, ops,
                                   save_y, fuse_pairs, **sched)
        assert not gchk.stack_passes(*gchk.stack_errors(lg_k, g_k, lg_f, g_f)), name


@pytest.mark.cuda
def test_loader_on_card_takes_the_cli_default_device(cuda_device, tmp_path):
    """``--device cuda`` (no index) reaches the loader's producer thread."""
    from ae_wavenet_tpu_torch.data.dataset import (PackedDataset, WindowSampler,
                                                   make_synthetic_dataset)
    from ae_wavenet_tpu_torch.data.loader import device_batches

    prefix = str(tmp_path / "synth")
    make_synthetic_dataset(prefix, n_clips=4, n_speakers=2, clip_len=(5000, 6000),
                           seed=0)
    sampler = WindowSampler(PackedDataset(prefix), 4000, 2, seed=1)
    got = list(device_batches(sampler, 0, 4, "cuda", block=2))
    assert [s for s, _ in got] == [0, 2]
    for s, (wav, spk) in got:
        assert wav.is_cuda and tuple(wav.shape) == (2, 2, 4000)
        assert torch.equal(wav[1].cpu(), torch.from_numpy(sampler.batch_at(s + 1)[0]))


@pytest.mark.cuda
def test_encode_on_card_matches_cpu_with_reference_precision(cuda_device):
    """With the CLIs' precision setting (utils/precision.py) the f32 encode
    on the card (MFCC, encoder, VQ, upsampler through cuDNN) stays within
    1e-4 of max |cond| of the same encode on the CPU, at the full
    ``chorowski`` width; cuDNN's TF32 default is what it guards against."""
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.utils.config import chorowski_config
    from ae_wavenet_tpu_torch.utils.precision import set_reference_precision

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    set_reference_precision()
    try:
        cfg = chorowski_config()
        model = ae.init(cfg, torch.Generator().manual_seed(1), "cpu").eval()
        wav = (torch.randn(2, 32000, generator=torch.Generator().manual_seed(2))
               * 4000).clamp(-32768, 32767).to(torch.int16)
        with torch.no_grad():
            want = ae.encode(model, cfg, wav)[0]
            got = ae.encode(model.to(cuda_device), cfg, wav.to(cuda_device))[0].cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_gated_kernels_reject_what_they_cannot_take(cuda_device):
    wn, ids, cond, spk = chip_smoke.random_stack(GCFG, 1, 40, 2, cuda_device)
    dils, x0, cond_tm, packed, *_ = chip_smoke.segment_inputs(wn, GCFG, ids, cond, spk)
    skip = torch.zeros(*x0.shape[:2], GCFG.n_skp, device=cuda_device)
    with pytest.raises(ValueError, match="x"):
        tgc.gated_layer_fused(x0.float(), cond_tm, skip, *packed[0], dd=1, r0=1)
    with pytest.raises(ValueError, match="cpu"):
        tgc.gated_layer_fused(x0, cond_tm.cpu(), skip, *packed[0], dd=1, r0=1)
    with pytest.raises(ValueError, match="two or more layers"):
        tgc.gated_stack_fused(x0, cond_tm, skip, packed[:1], dils=dils[:1], r0=1)
    with pytest.raises(ValueError, match="skip"):
        tgc.gated_stack_fused(x0, cond_tm, skip.to(torch.bfloat16), packed,
                              dils=dils, r0=1)
    cot = {k: torch.zeros_like(x0) for k in ("gxcur", "gxprev")}
    gskip = torch.zeros_like(skip, dtype=torch.bfloat16)
    gcond = torch.zeros(cond_tm.shape, device=cuda_device)
    group = dict(dds=dils[:3], prev_dd=dils[3], valid_los=(1, 3, 7), cur_valid_lo=15)
    with pytest.raises(ValueError, match="saved y"):
        tgc.gated_group_bwd((x0,) * 3, cond_tm, cot["gxcur"], cot["gxprev"], gskip,
                            gcond, packed[:3], (None,) * 3, **group)
    with pytest.raises(ValueError, match="two or more layers"):
        tgc.gated_group_bwd((x0,), cond_tm, cot["gxcur"], cot["gxprev"], gskip,
                            gcond, packed[:1], (None,), dds=dils[:1], prev_dd=2,
                            valid_los=(1,), cur_valid_lo=3)


# ----------------------------------- the MFCC inverter and the int8 quality gate

def _inverter_case(dev, tmp_path):
    """The tiny preset as an MFCC inverter (32-wide stack, 6 layers, the
    (5, 4, 4, 2) upsampler) in bf16 with the fused stack, a model on the
    card and the reference's v2 fixture."""
    from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import mfcc_inverter as tmi
    from ae_wavenet_tpu_torch.utils.config import tiny_config

    base = tiny_config()
    cfg = dataclasses.replace(
        base, model_kind="mfcc_inverter",
        wavenet=dataclasses.replace(base.wavenet, lc_upsample_strides=(5, 4, 4, 2),
                                    lc_upsample_filters=(10, 8, 8, 4),
                                    use_pallas_stack=True),
        train=dataclasses.replace(base.train, compute_dtype="bfloat16"))
    prefix = str(tmp_path / "synth")
    make_synthetic_dataset(prefix, n_clips=3, n_speakers=2, clip_len=(9000, 12000),
                           seed=0)
    return cfg, prefix, tmi.init(cfg, torch.Generator().manual_seed(0), dev)


@pytest.mark.cuda
def test_inverter_pair_kernels_match_plain_on_its_conditioning(cuda_device, tmp_path):
    """K1 and K2 on the inverter's own conditioning (the MFCC of real
    windows through its upsampler, in bf16) against their plain versions:
    logits and every gradient, one launch of each per pair."""
    from ae_wavenet_tpu_torch.audio import mfcc
    from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float, mu_encode
    from ae_wavenet_tpu_torch.data.dataset import PackedDataset, WindowSampler
    from ae_wavenet_tpu_torch.models import mfcc_inverter as tmi
    from ae_wavenet_tpu_torch.models.common import normalize_frames

    cfg, prefix, model = _inverter_case(cuda_device, tmp_path)
    spec = tmi.make_window_spec(cfg)
    wav, spk = WindowSampler(PackedDataset(prefix), spec.u_len, 2, 0).batch_at(0)
    x = int16_to_float(torch.from_numpy(wav).to(cuda_device))
    spk = torch.from_numpy(spk).long().to(cuda_device)
    with torch.no_grad():
        frames = normalize_frames(mfcc.mfcc_delta_stack(x[..., spec.fb : spec.fe],
                                                        cfg.spec), spec=cfg.spec)
        cond = twn.upsample_apply(model.wavenet, cfg.wavenet, frames, spec.up_steps,
                                  dtype=torch.bfloat16)
    ids = mu_encode(x, cfg.wavenet.n_quant)[..., spec.w0 : spec.w0 + spec.t_in]
    assert cond.shape[-1] == ids.shape[-1] == spec.t_in
    probe = torch.randn(2, spec.n_win, cfg.wavenet.n_quant, device=cuda_device)
    pairs = len(cfg.wavenet.dilations) // 2
    before = (tgc.gated_pair_fused.launches, tgc.gated_pair_bwd.launches)
    lg_k, g_k = gchk.stack_run(model.wavenet, cfg.wavenet, ids, cond, spk, probe,
                               None, True, True)
    torch.cuda.synchronize()
    assert (tgc.gated_pair_fused.launches - before[0],
            tgc.gated_pair_bwd.launches - before[1]) == (pairs, pairs)
    lg_p, g_p = gchk.stack_run(model.wavenet, cfg.wavenet, ids, cond, spk, probe,
                               tgt.PLAIN, True, True)
    lg, rel = gchk.stack_errors(lg_k, g_k, lg_p, g_p)
    assert gchk.stack_passes(lg, rel), (lg, rel)


@pytest.mark.cuda
def test_inverter_reconstruct_runs_the_sampler_kernel(cuda_device, tmp_path):
    """``mfcc_inverter.reconstruct`` at temperature 0: one launch of K4,
    whose greedy ids and logits over each row's inclusive agreeing prefix
    match the plain sampler's on the same primed state."""
    from ae_wavenet_tpu_torch.data.dataset import PackedDataset
    from ae_wavenet_tpu_torch.models import common as tcommon
    from ae_wavenet_tpu_torch.models import mfcc_inverter as tmi

    cfg, prefix, model = _inverter_case(cuda_device, tmp_path)
    ds = PackedDataset(prefix)
    wav = torch.from_numpy(np.stack([ds.clip(0, 8000), ds.clip(1, 8000)])).to(cuda_device)
    spk = torch.from_numpy(ds.speakers[:2].astype(np.int64)).to(cuda_device)
    n, wcfg = 32, cfg.wavenet
    model.eval()
    prep = tcommon.prime_for_generation(tmi.encode, model, cfg, wav, spk, n)
    args = (tfc.pack_for_kernel(model.wavenet, wcfg), wcfg,
            tfc.state_to_flat(prep.state, wcfg), prep.state.prev_id, prep.state.t,
            tfg.with_gc(model.wavenet, wcfg, prep.gen_cond, spk), 0, 0.0)
    got = tfc.generate_fused(args[0], args[1], args[2].clone(), *args[3:],
                             debug_logits=True)
    want = tfc.generate_fused_reference(args[0], args[1], args[2].clone(), *args[3:],
                                        debug_logits=True)
    assert _agreed(got, want, LOGIT_TOL) >= n
    before = tfc.generate_fused.launches
    ids, start = tmi.reconstruct(model, cfg, wav, spk, temperature=0.0, n_samples=n)
    torch.cuda.synchronize()
    assert tfc.generate_fused.launches == before + 1
    assert start == prep.start and torch.equal(ids, got[0])


@pytest.mark.cuda
def test_int8_quality_gate(cuda_device, tmp_path):
    """The reference's gate (``tests_tpu/test_quality_tpu.py``): 300 steps of
    the flagship dims on its v2 fixture, then 16,384 free-running samples in
    bf16 and int8; the int8 log-mel distance to the source within 1.20x the
    bf16 one + 0.15 (int4's is computed, with no gate).  The training runs
    on the pair kernels alone (10 K1 and 10 K2 a step, the captures'
    warm-up steps counted), each reconstruction is one sampler launch, and
    no plain version runs."""
    from ae_wavenet_tpu_torch.eval import quality

    seen = {}

    def on_trained(ch, history):
        torch.cuda.synchronize()
        seen["train"] = chip_smoke.launch_counts()
        chip_smoke.zero_launch_counts()

    chip_smoke.zero_launch_counts()
    r = quality.quantized_quality_gate(str(tmp_path), cuda_device, on_trained=on_trained)
    torch.cuda.synchronize()
    pairs = len(WaveNetConfig().dilations) // 2
    steps = chip_smoke.warm_steps(quality.GATE_STEPS)
    assert seen["train"] == chip_smoke.expect_launches(gated_pair_fused=pairs * steps,
                                               gated_pair_bwd=pairs * steps)
    assert chip_smoke.launch_counts() == chip_smoke.expect_launches(bf16=1, int8=1, int4=1)
    dists = {k: r[k] for k in ("d16", "d8", "d4", "silence")}
    assert r["n"] == 16384 and all(np.isfinite(v) for v in dists.values()), dists
    assert r["passed"], dists


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["tiny", "chorowski"])
def test_two_rank_step_on_one_card_matches_one_process(cuda_device, tmp_path, width):
    """Two ranks on the one card (gloo: NCCL refuses two ranks on one card)
    take one step of the fused stack and the VQ kernel on their halves of a
    global batch of 4 (no jitter or restarts): the tiny preset, and the
    flagship at n_win = 48,000.  Each rank launches the pair kernels once
    per pair and the VQ kernel once, the ranks end bit-identical, and the
    step passes ``worker.dp_step_check`` against one process's on the whole
    batch: loss within 1e-3 relative; the EMA counts and sums the EMA of
    the ranks' own statistics summed, bit for bit, the codebook within 1e-4
    of its largest entry; the codes and the EMA state by ``vq_step_check``
    (the encoder ran at another batch, so a latent near a tie may flip:
    each flip must be one, and the other codes must match); the latents,
    the averaged gradients and the updated parameters within 3x the bf16
    autograd step's RMS distance to the f32 step.  The same check rejects
    two planted faults: the gradients summed over the ranks, not averaged,
    and one latent on another code than its nearest.  The one process's
    steps run eagerly: ``vq_capture`` copies the latents to the host inside
    the step, which a graph capture refuses (the graph is held to the eager
    step bit for bit below)."""
    import functools
    from unittest import mock

    import torch_parallel_worker as worker
    from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as tae
    from ae_wavenet_tpu_torch.training import chassis
    from ae_wavenet_tpu_torch.utils import config as tcfg

    if width == "tiny":
        base = tcfg.tiny_config()
        bn = tcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=32)
        train = dict(compute_dtype="bfloat16")
        clips = dict(n_clips=4, n_speakers=4, clip_len=(9000, 12000), seed=0)
    else:
        base = tcfg.chorowski_config()
        bn, train = base.bottleneck, dict(n_win=48000)
        u_len = tae.make_window_spec(base, 48000).u_len
        clips = dict(n_clips=8, n_speakers=8, clip_len=(u_len + 4000, u_len + 30000),
                     seed=1)
    cfg = dataclasses.replace(
        base, bottleneck=dataclasses.replace(bn, jitter_p=0.0, vq_restart_thresh=0.0,
                                             vq_use_pallas=True),
        wavenet=dataclasses.replace(base.wavenet, use_pallas_stack=True),
        train=dataclasses.replace(base.train, batch_sz=4, log_every=1, **train))
    prefix = str(tmp_path / "synth")
    make_synthetic_dataset(prefix, **clips)
    ranks = worker.run_ranks(worker.card_dp_step, 2, 2, tcfg.to_json(cfg), prefix,
                             timeout=240.0)

    def one_process(c):
        ch = chassis.Chassis(c, prefix, device=cuda_device, log_stream=io.StringIO())
        seen = []
        chip_smoke.zero_launch_counts()
        with worker.vq_capture(seen), mock.patch.object(
                chassis, "train_step", functools.partial(chassis.train_step, eager=True)):
            loss = ch.train(1)[-1]["loss"]
        torch.cuda.synchronize()
        assert len(seen) == 1
        return loss, {**worker.step_state(ch), "z": seen[0][0], "codes": seen[0][1],
                      "counts": chip_smoke.launch_counts()}

    pairs = len(cfg.wavenet.dilations) // 2
    loss, single = one_process(cfg)
    assert single["counts"] == chip_smoke.expect_launches(gated_pair_fused=pairs,
                                                  gated_pair_bwd=pairs, vq_lookup_fused=1)
    plain = dataclasses.replace(
        cfg, wavenet=dataclasses.replace(cfg.wavenet, use_pallas_stack=False),
        bottleneck=dataclasses.replace(cfg.bottleneck, vq_use_pallas=False))
    with chip_smoke.f32_numerics():
        _, ref32 = one_process(dataclasses.replace(plain, train=dataclasses.replace(
            plain.train, compute_dtype="float32")))
    _, ref16 = one_process(dataclasses.replace(plain, train=dataclasses.replace(
        plain.train, compute_dtype="bfloat16")))
    for r in ranks:
        assert r["backend"] == "gloo"
        assert r["dp"]["launches"] == r["fault"]["launches"] == [pairs, pairs, 1]
        for w in ("params", "grads", "buffers"):
            for k, v in r["dp"][w].items():
                assert torch.equal(v, ranks[0]["dp"][w][k]), (w, k)

    def check(tag, **swap):
        dp = [{**r[tag], **swap} if i == 0 else r[tag] for i, r in enumerate(ranks)]
        return worker.dp_step_check(dp, single, ref32, ref16, ranks[0][tag]["loss"], loss,
                                    cfg.bottleneck)

    fails, vq = check("dp")
    assert not fails, (fails, vq)
    assert check("fault")[0]
    codes = ranks[0]["dp"]["codes"].clone()
    codes[0] = (codes[0] + 1) % cfg.bottleneck.vq_k
    assert check("dp", codes=codes)[0]


# ------------------------------------------------------------- the instruments

@pytest.mark.cuda
def test_quality_quantized_on_the_card_matches_the_cpu(cuda_device, tmp_path,
                                                       monkeypatch, capsys):
    """``scripts/quality_quantized`` at the 32-wide stack, greedy: on the
    card one launch each of the bf16, int8 and int4 kernels, on the CPU
    their plain versions; each mode's ids agree over at least MIN_PREFIX
    steps, the source's distance to silence within 1e-4, and where a mode's
    ids agree throughout its distance within 1e-4 too."""
    import json

    from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as tae
    from ae_wavenet_tpu_torch.scripts import quality_quantized
    from ae_wavenet_tpu_torch.training import checkpoint as tckpt
    from ae_wavenet_tpu_torch.training import weights
    from ae_wavenet_tpu_torch.utils.config import tiny_config

    cfg = tiny_config()
    model = tae.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        model.wavenet.post2["w"].mul_(50.0)  # informative logits
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    weights.save_export(tckpt.checkpoint_path(ckpt, 0), model, cfg, 0)
    data = str(tmp_path / "synth")
    make_synthetic_dataset(data, n_clips=2, n_speakers=2, clip_len=(9000, 11000), seed=0)
    ids: list = []
    reconstruct = tae.reconstruct

    def recording(*a, **k):
        out = reconstruct(*a, **k)
        ids.append(out[0].cpu())
        return out

    monkeypatch.setattr(tae, "reconstruct", recording)
    counters = ("launches", "launches_int8", "launches_int4")
    recs = {}
    for device in ("cuda", "cpu"):
        before = [getattr(tfc.generate_fused, c) for c in counters]
        plain = tfc.generate_fused_reference.launches
        capsys.readouterr()
        assert quality_quantized.main(["--ckpt-dir", ckpt, "--data", data, "--clips", "0",
                                       "--n-samples", "400", "--temperature", "0",
                                       "--device", device]) == 0
        torch.cuda.synchronize()
        recs[device] = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
        ran = [getattr(tfc.generate_fused, c) - b for c, b in zip(counters, before)]
        assert ran == ([1, 1, 1] if device == "cuda" else [0, 0, 0])
        assert tfc.generate_fused_reference.launches - plain == (device == "cpu") * 3
    card, cpu = ids[:3], ids[3:]
    for mode, g, w, rg, rw in zip(("bf16", "int8", "int4"), card, cpu,
                                  recs["cuda"][1:4], recs["cpu"][1:4]):
        diff = torch.nonzero(g[0] != w[0])
        agree = g.shape[-1] if len(diff) == 0 else int(diff[0])
        assert agree >= MIN_PREFIX, (mode, agree)
        assert rg["mode"] == rw["mode"] == mode and rg["n_scored"] == rw["n_scored"]
        sil = abs(rg["spectral_l2_vs_silence"] - rw["spectral_l2_vs_silence"])
        assert sil <= 1e-4 * rw["spectral_l2_vs_silence"], mode
        if agree == g.shape[-1]:
            assert abs(rg["spectral_l2"] - rw["spectral_l2"]) <= 1e-4 * rw["spectral_l2"]


# ------------------------------------------------------------------ the bench

BENCH_GATED = ("gated_pair_fused", "gated_layer_fused", "gated_stack_fused",
               "gated_pair_bwd", "gated_layer_bwd", "gated_group_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,per_step", [
    ("pairs", {"gated_pair_fused": 4, "gated_pair_bwd": 4}),
    ("whole_stack", {"gated_stack_fused": 1, "gated_group_bwd": 2})])
def test_bench_on_card_goes_through_the_gated_kernels(cuda_device, schedule, per_step):
    """``bench.measure`` at a narrow stack (GCFG's widths, 8 layers; the
    tiny encoder) on the card, B = 1 x 2,000, 2 iterations, K = 2: a
    complete record with the e2e headline, MFU where the card's peak is
    known, and in each of the run's 15 steps, and in the warm-up step of
    each of its two captures (the compute-only loop's and the e2e
    chassis's), every gated kernel launched as the schedule gives it (the
    whole stack: BENCH_FULL_FUSION=1 with groups of 4) and no plain version
    at all."""
    from ae_wavenet_tpu_torch.training import chassis
    from ae_wavenet_tpu_torch import bench
    from ae_wavenet_tpu_torch.utils.config import tiny_config

    base = bench.bench_config({} if schedule == "pairs" else
                              {"BENCH_FULL_FUSION": "1", "BENCH_BWD_GROUP": "4"})
    cfg = dataclasses.replace(
        base, encoder=tiny_config().encoder,
        bottleneck=dataclasses.replace(base.bottleneck, n_dim=16, vq_k=32),
        wavenet=dataclasses.replace(GCFG, use_pallas_stack=True,
                                    gated_full_fusion=base.wavenet.gated_full_fusion,
                                    gated_bwd_group=base.wavenet.gated_bwd_group),
        train=dataclasses.replace(base.train, batch_sz=1, n_win=2000))
    wrappers = [getattr(tgc, n) for n in BENCH_GATED]
    plain = [getattr(tgt, n + "_reference") for n in BENCH_GATED]
    before = [f.launches for f in wrappers + plain]
    rec = bench.measure(cfg, cuda_device, iters=2, k=2)
    torch.cuda.synchronize()
    ran = [f.launches - b for f, b in zip(wrappers + plain, before)]
    steps = bench.WARMUP + 2 + 2 * 2 + bench.e2e_steps(2, 2)
    assert steps == 15
    steps += 2 * chassis.WARMUP_STEPS
    assert ran[:len(wrappers)] == [per_step.get(n, 0) * steps for n in BENCH_GATED]
    assert ran[len(wrappers):] == [0] * len(plain)
    assert rec["headline"] == "e2e" and rec["steps_per_call"] == 2
    for key in ("value", "compute_only_value", "e2e_fraction", "model_tflops_per_step"):
        assert np.isfinite(rec[key]) and rec[key] > 0, (key, rec)
    peak = bench.peak_of(cuda_device)
    assert (rec["mfu"] is None) == (peak is None)
    assert rec["mfu"] is None or 0 <= rec["mfu"] <= 1.05


# ------------------ the one-pass prime, and the f32 rollout as a CUDA graph

def _graph_case(dev, cfg, batch, n, seed=0):
    """Seeded weights with informative logits, rf + 1 context ids, and
    cond for the context and ``n`` rollout steps."""
    gen = torch.Generator().manual_seed(seed)
    wn = twn.WaveNet(cfg, gen)
    with torch.no_grad():
        wn.post2["w"].mul_(50.0)
    rf = sum(cfg.dilations)
    ctx = torch.randint(0, cfg.n_quant, (batch, rf + 1), generator=gen).to(dev)
    cond = (torch.randn(batch, cfg.n_lc_out, rf + n, generator=gen) * 0.3).to(dev)
    spk = torch.randint(0, cfg.n_speakers, (batch,), generator=gen).to(dev)
    return wn.to(dev), ctx, cond, spk


def _graph_counts():
    return (tfg.prime.passes, tfg.prime.positions,
            tfg.generate.graph_replays, tfg.generate.eager_steps)


def _zero_graph_counts():
    tfg.prime.passes = tfg.prime.positions = 0
    tfg.generate.graph_replays = tfg.generate.eager_steps = 0


def _copy(st):
    return tfg.GenState(tuple(b.clone() for b in st.bufs), st.prev_id.clone(), st.t)


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", [("scalar", 1), ("vector", 11),
                                        ("chorowski", 1)])
def test_one_pass_prime_matches_the_step_loop(cuda_device, name, batch):
    """The one pass against the old step loop (``fastgen_oracle``), both on
    the card: every ring within f32 reduction order (rtol = atol = 1e-5),
    the last ids and the phase equal; one pass counted over B x rf
    positions, and no rollout step."""
    cfg = CFGS.get(name, WaveNetConfig())  # WaveNetConfig(): the chorowski decoder
    rf = sum(cfg.dilations)
    wn, ctx, cond, spk = _graph_case(cuda_device, cfg, batch, 0)
    _zero_graph_counts()
    got = tfg.prime(wn, cfg, tfg.init_state(cfg, batch, device=cuda_device), ctx, cond,
                    spk)
    torch.cuda.synchronize()
    assert _graph_counts() == (1, batch * rf, 0, 0)
    want = oracle.old_prime(wn, cfg, tfg.init_state(cfg, batch, device=cuda_device), ctx,
                            cond, spk)
    assert got.t == want.t == rf and torch.equal(got.prev_id, want.prev_id)
    for a, b in zip(got.bufs, want.bufs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 64])
def test_one_pass_prime_is_within_f32_of_the_exact_rings(cuda_device, batch):
    """At the chorowski widths, the one pass against the step loop in
    float64: every ring within rtol = atol = 1e-5 of the exact one, the
    last ids and the phase equal.  (At B = 64 the pass and the f32 step
    loop, two f32 orders, may differ by more than that in a few of the
    6.3 M ring values; the exact rings hold each to its own rounding.)  One
    pass counted over B x rf positions, and no rollout step."""
    cfg = WaveNetConfig()
    rf = sum(cfg.dilations)
    wn, ctx, cond, spk = _graph_case(cuda_device, cfg, batch, 0)
    _zero_graph_counts()
    got = tfg.prime(wn, cfg, tfg.init_state(cfg, batch, device=cuda_device), ctx, cond,
                    spk)
    assert _graph_counts() == (1, batch * rf, 0, 0)
    exact = oracle.exact_prime(wn, cfg, ctx, cond, spk)
    assert got.t == exact.t == rf and torch.equal(got.prev_id, exact.prev_id)
    for a, b in zip(got.bufs, exact.bufs):
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", [("vector", 11), ("wavenet_mol_24k", 1)])
def test_one_pass_prime_of_samples_is_within_f32_of_the_step_loop(cuda_device, name, batch):
    """A mixture output's prime (samples through the rank-1 input map)
    against the f32 step loop, both on the card: every ring within rtol =
    atol = 1e-5 at the tiny width.  At ``wavenet_mol_24k``'s 30 layers of
    512 the pass and the f32 loop are each held to the loop in float64,
    within 1e-5 of the rings' largest magnitude (about 5 there): an f32
    sum's error scales with the values summed, and over 30 layers of
    512-wide sums the two f32 orders read 1.0e-5 and 2.6e-5 from the exact
    rings.  The last samples and the phase equal."""
    import pathlib

    from ae_wavenet_tpu_torch.utils import config as tcfg

    if name in MOL_CFGS:
        cfg = MOL_CFGS[name]
    else:
        cfg = tcfg.from_json((pathlib.Path(__file__).resolve().parent.parent
                              / "benchmark/configs/wavenet_mol_24k.json").read_text()).wavenet
    gen = torch.Generator().manual_seed(4)
    wn = twn.WaveNet(cfg, gen).to(cuda_device)
    rf = sum(cfg.dilations)
    ctx = (torch.rand(batch, rf + 1, generator=gen) * 1.2 - 0.6).to(cuda_device)
    cond = (torch.randn(batch, cfg.n_lc_out, rf, generator=gen) * 0.3).to(cuda_device)
    got = tfg.prime(wn, cfg, tfg.init_state(cfg, batch, device=cuda_device), ctx, cond)
    loop = oracle.old_prime(wn, cfg, tfg.init_state(cfg, batch, device=cuda_device), ctx,
                            cond)
    assert got.t == loop.t == rf and torch.equal(got.prev_id, loop.prev_id)
    if name in MOL_CFGS:
        for a, b in zip(got.bufs, loop.bufs):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        return
    exact = oracle.exact_prime(wn, cfg, ctx, cond)
    top = max(float(e.abs().max()) for e in exact.bufs)
    for bufs in (got.bufs, loop.bufs):
        err = max(float((b.double() - e).abs().max()) for b, e in zip(bufs, exact.bufs))
        assert err <= 1e-5 * max(1.0, top), (err, top)


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,temperature,dtype,on", [
    ("vector", 5, 0.0, torch.float32, "cpu"), ("vector", 5, 1.0, torch.float32, "cpu"),
    ("vector", 5, 1.0, torch.float32, "cuda"), ("vector", 5, 1.0, torch.bfloat16, "cuda")]
    + [("chorowski", b, t, torch.float32, "cpu") for b in (1, 64) for t in (0.0, 1.0)])
def test_graph_generate_matches_eager(cuda_device, name, batch, temperature, dtype, on):
    """From one primed state with one seeded generator (on the host, as the
    quality eval's, or on the card, as bench_gen's): the same ids, and the
    logits, rings and last ids bit for bit; the replay counter moves by the
    rollout's steps, and no eager step runs on the graph's side.  48 steps
    at the tiny width; 256 at the ``chorowski`` decoder's, at the batches of
    the CLI's request and of the batched request."""
    n, cfg = (48, CFGS[name]) if name in CFGS else (256, WaveNetConfig())
    wn, ctx, cond, spk = _graph_case(cuda_device, cfg, batch, n, seed=1)
    state = tfg.prime(wn, cfg, tfg.init_state(cfg, batch, device=cuda_device), ctx, cond,
                      spk)
    rf = sum(cfg.dilations)
    runs = []
    for eager in (False, True):
        _zero_graph_counts()
        runs.append(tfg.generate(wn, cfg, _copy(state), cond[..., rf:],
                                 torch.Generator(device=on).manual_seed(3), gc_ids=spk,
                                 temperature=temperature, return_logits=True,
                                 dtype=dtype, eager=eager))
        torch.cuda.synchronize()
        assert _graph_counts() == ((0, 0, 0, n) if eager else (0, 0, n, 0))
    (ids_g, st_g, lg_g), (ids_e, st_e, lg_e) = runs
    assert ids_g.shape == (batch, n) and torch.equal(ids_g, ids_e)
    assert torch.equal(lg_g, lg_e)
    assert st_g.t == st_e.t == rf + n and torch.equal(st_g.prev_id, st_e.prev_id)
    for a, b in zip(st_g.bufs, st_e.bufs):
        assert torch.equal(a, b)
    if temperature:
        assert len(set(ids_g.flatten().tolist())) > 8


@pytest.mark.cuda
def test_graph_capture_failure_raises(cuda_device, monkeypatch):
    """A host synchronisation planted in the rollout's step, refused while
    the stream captures: generate raises, no step runs in the eager loop
    and none is replayed; the caller's stream is its own again, and the
    next rollout captures and replays as before."""
    cfg = CFGS["scalar"]
    rf, n = sum(cfg.dilations), 8
    wn, ctx, cond, spk = _graph_case(cuda_device, cfg, 2, n)
    state = tfg.prime(wn, cfg, tfg.init_state(cfg, 2, device=cuda_device), ctx, cond,
                      spk)
    cell = tfg._cell

    def planted(*a, **kw):
        out = cell(*a, **kw)
        a[2].ctr.sum().item()  # a copy to the host and a wait
        return out

    stream = torch.cuda.current_stream()
    monkeypatch.setattr(tfg, "_cell", planted)
    _zero_graph_counts()
    with pytest.raises(RuntimeError):
        tfg.generate(wn, cfg, _copy(state), cond[..., rf:], temperature=0.0)
    assert _graph_counts() == (0, 0, 0, 0)
    assert torch.cuda.current_stream() == stream
    monkeypatch.undo()
    _, st = tfg.generate(wn, cfg, _copy(state), cond[..., rf:], temperature=0.0)
    torch.cuda.synchronize()
    assert _graph_counts() == (0, 0, n, 0) and st.t == rf + n


# -------------------------------------- the training step as a CUDA graph

from ae_wavenet_tpu_torch.models import registry as treg  # noqa: E402
from ae_wavenet_tpu_torch.training import chassis as tch  # noqa: E402

STEP_SCHEDULES = {"pairs": {},
                  "single_layer": dict(gated_fuse_pairs=False, gated_save_y=False),
                  "whole_stack": dict(gated_full_fusion=True, gated_bwd_group=4)}
STEP_KERNELS = (*BENCH_GATED, "gated_layer_bwd_recompute", "vq_lookup_fused")
TRAIN_STEP = tch.train_step  # its counters, where a test wraps it


def _step_cfg(kind: str, schedule: str):
    """GCFG's 8 layers in bf16 on the kernels under ``schedule``, the tiny
    encoder, B = 2 x 2,000; a VQ bottleneck on the fused lookup (K9) with
    restarts, jitter and its warm-up ramp, a VAE with its KL ramp, or the
    MFCC inverter.  Or the flagship (``chorowski``) at the training path's
    B = 4 x 48,000, groups of 5 on the whole stack, the fused VQ lookup on
    the pairs."""
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, chorowski_config,
                                                   tiny_config)

    if kind == "flagship":
        base = chorowski_config()
        sched = {**STEP_SCHEDULES[schedule],
                 **({"gated_bwd_group": 5} if schedule == "whole_stack" else {})}
        return dataclasses.replace(
            base, wavenet=dataclasses.replace(base.wavenet, use_pallas_stack=True, **sched),
            bottleneck=dataclasses.replace(base.bottleneck,
                                           vq_use_pallas=schedule == "pairs"),
            train=dataclasses.replace(base.train, batch_sz=4, n_win=48000))
    base = tiny_config()
    cfg = dataclasses.replace(
        base, wavenet=dataclasses.replace(GCFG, use_pallas_stack=True,
                                          **STEP_SCHEDULES[schedule]),
        train=dataclasses.replace(base.train, batch_sz=2, n_win=2000,
                                  compute_dtype="bfloat16", log_every=1))
    if kind == "vq":
        return dataclasses.replace(cfg, bottleneck=BottleneckConfig(
            kind="vq", n_dim=16, vq_k=32, vq_restart_thresh=0.5, jitter_p=0.3,
            vq_use_pallas=True, vq_warmup_steps=4), train=dataclasses.replace(
                cfg.train, aux_frame_weight=1.0))
    if kind == "vae":
        return dataclasses.replace(cfg, bottleneck=BottleneckConfig(
            kind="vae", n_dim=16, kl_anneal_steps=10))
    return dataclasses.replace(
        cfg, model_kind="mfcc_inverter",
        wavenet=dataclasses.replace(cfg.wavenet, lc_upsample_strides=(5, 4, 4, 2),
                                    lc_upsample_filters=(10, 8, 8, 4)))


def _step_twins(cfg, dev, n_batches: int, k: int = 1):
    """Two (model, optimizer) pairs from one seed, the window spec, and
    ``n_batches`` seeded batches on the card ([k, B, ...] blocks for k > 1)."""
    fam = treg.get(cfg.model_kind)
    spec = fam.make_window_spec(cfg)
    pairs = []
    for _ in range(2):
        model = fam.init(cfg, torch.Generator().manual_seed(0), dev)
        pairs.append((model, tch.Adam(model.named_parameters(), cfg.train)))
    rng = np.random.default_rng(0)
    lead = (k,) if k > 1 else ()
    b = cfg.train.batch_sz
    batches = [(torch.from_numpy(rng.integers(-8000, 8000, (*lead, b, spec.u_len),
                                              dtype=np.int16)).to(dev),
                torch.from_numpy(rng.integers(0, cfg.wavenet.n_speakers,
                                              (*lead, b))).to(dev))
               for _ in range(n_batches)]
    return spec, pairs, batches


def _train_state(model, opt) -> dict:
    """Every parameter, buffer, moment, count and gradient of a training
    state."""
    return {**{f"model.{k}": v for k, v in model.state_dict().items()},
            **opt.named_state(), **{f"grad.{k}": p.grad for k, p in opt.params.items()}}


def _same_bits(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _step_counts() -> dict:
    return {"replays": TRAIN_STEP.graph_replays, "eager": TRAIN_STEP.eager_steps,
            "captures": TRAIN_STEP.captures,
            **{n: getattr(tgc, n.removesuffix("_recompute")).launches_recompute
               if n.endswith("_recompute") else
               getattr(vq_cuda if n.startswith("vq") else tgc, n).launches
               for n in STEP_KERNELS},
            "plain": sum(getattr(tgt, n + "_reference").launches for n in BENCH_GATED)
            + vq_cuda.vq_lookup_reference.launches}


def _moved(before: dict) -> dict:
    now = _step_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", sorted(STEP_SCHEDULES))
@pytest.mark.parametrize("kind", ["vq", "vae", "inverter", "flagship"])
def test_train_step_graph_matches_eager_bit_for_bit(cuda_device, kind, schedule):
    """3 steps replayed from one capture against the same 3 steps called
    eagerly (``eager=True``) from the same init and batches: every metric
    of every step, then every parameter, gradient, buffer, moment and count
    bit for bit.  The graph's run counts 3 replays, 1 capture and no eager
    step, and launches each kernel (3 + WARMUP_STEPS) / 3 times as often as
    the eager run; no plain version runs; K9's barrier is left at zero."""
    cfg = _step_cfg(kind, schedule)
    spec, ((mg, og), (me, oe)), batches = _step_twins(cfg, cuda_device, 3)
    runs = []
    for model, opt, eager in ((mg, og, False), (me, oe, True)):
        before = _step_counts()
        metrics = [tch.train_step(model, opt, cfg, spec, w, s, i, eager=eager)
                   for i, (w, s) in enumerate(batches)]
        torch.cuda.synchronize()
        runs.append((metrics, _moved(before)))
    (m_g, n_g), (m_e, n_e) = runs
    for a, b in zip(m_g, m_e):
        _same_bits(a, b)
    _same_bits(_train_state(mg, og), _train_state(me, oe))
    assert {k: n_g.pop(k) for k in ("replays", "captures")} == {"replays": 3,
                                                                "captures": 1}
    assert n_e.pop("eager") == 3 and "eager" not in n_g and "plain" not in n_e
    w = tch.WARMUP_STEPS
    assert n_g and {k: v * 3 for k, v in n_g.items()} == {
        k: v * (3 + w) for k, v in n_e.items()}
    assert ("vq_lookup_fused" in n_g) == cfg.bottleneck.vq_use_pallas
    assert chip_smoke.barriers_at_zero()


@pytest.mark.cuda
def test_train_step_k_steps_a_call_are_k_replays(cuda_device):
    """Two calls of K = 4 on [4, B, ...] blocks, with a learning-rate
    boundary at step 6: 8 replays of two captures (the first call's rate,
    then the second rate, inside the second call), bit for bit the same
    calls run eagerly (the last step's metrics, the state after them)."""
    cfg = _step_cfg("vq", "pairs")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr_boundaries=(6,), lr_values=(3e-4, 1e-4)))
    spec, ((mg, og), (me, oe)), batches = _step_twins(cfg, cuda_device, 2, k=4)
    before = _step_counts()
    got = [tch.train_step(mg, og, cfg, spec, w, s, 4 * i, 4)
           for i, (w, s) in enumerate(batches)]
    moved = _moved(before)
    want = [tch.train_step(me, oe, cfg, spec, w, s, 4 * i, 4, eager=True)
            for i, (w, s) in enumerate(batches)]
    torch.cuda.synchronize()
    assert (moved["replays"], moved["captures"], moved.get("eager", 0)) == (8, 2, 0)
    for a, b in zip(got, want):
        _same_bits(a, b)
    _same_bits(_train_state(mg, og), _train_state(me, oe))
    assert og.count == oe.count == og.sched_count == 8


@pytest.mark.cuda
def test_train_step_resume_recaptures_and_matches_eager(cuda_device, tmp_path,
                                                        monkeypatch):
    """``Chassis`` on the card: 2 steps, a save, 2 more (one capture, 4
    replays, no eager step).  A fresh chassis resumed at the save trains
    the 2 steps through a graph of its own, and another resumed one trains
    them eagerly: both end bit for bit where the first did."""
    import functools

    from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset

    cfg = _step_cfg("vq", "pairs")
    u_len = treg.get(cfg.model_kind).make_window_spec(cfg).u_len
    data = str(tmp_path / "synth")
    make_synthetic_dataset(data, n_clips=4, n_speakers=4,
                           clip_len=(u_len + 1000, u_len + 3000), seed=0)
    ckpt = str(tmp_path / "ck")

    def chassis():
        return tch.Chassis(cfg, data, ckpt_dir=ckpt, device=cuda_device,
                           log_stream=io.StringIO())

    before = _step_counts()
    a = chassis()
    a.train(2)
    a.save()
    hist_a = a.train(2)
    moved = _moved(before)
    assert (moved["replays"], moved["captures"], moved.get("eager", 0)) == (4, 1, 0)
    ends = []
    for eager in (False, True):
        if eager:
            monkeypatch.setattr(tch, "train_step",
                                functools.partial(tch.train_step, eager=True))
        before = _step_counts()
        b = chassis()
        assert b.resume(2) == 2
        hist = b.train(2)
        moved = _moved(before)
        assert moved.get("eager", 0) == (2 if eager else 0)
        assert moved.get("captures", 0) == (0 if eager else 1)
        assert hist == [{**h, "samples_per_sec": g["samples_per_sec"]}
                        for h, g in zip(hist_a, hist)]
        ends.append(b)
    for b in ends:
        _same_bits({k: v for k, v in _train_state(b.model, b.opt).items()
                    if not k.startswith("grad.")},
                   {k: v for k, v in _train_state(a.model, a.opt).items()
                    if not k.startswith("grad.")})
    for ch in (a, *ends):
        ch.close()


@pytest.mark.cuda
def test_train_step_capture_failure_raises(cuda_device, monkeypatch):
    """A host synchronisation planted in the loss, refused while the stream
    captures: the call raises, nothing is replayed or run eagerly, the
    training state and the optimizer's counts are as before the call, the
    caller's stream is its own again; without the fault the next call
    captures, replays and matches an eager twin."""
    cfg = _step_cfg("vq", "pairs")
    spec, ((mg, og), (me, oe)), batches = _step_twins(cfg, cuda_device, 1)
    fam = treg.get(cfg.model_kind)
    loss_fn = fam.loss_fn

    def planted(*a, **kw):
        total, metrics = loss_fn(*a, **kw)
        total.detach().sum().item()  # a copy to the host and a wait
        return total, metrics

    start = {k: v.clone() for k, v in _train_state(mg, og).items() if v is not None}
    stream = torch.cuda.current_stream()
    monkeypatch.setattr(fam, "loss_fn", planted)
    before = _step_counts()
    w, s = batches[0]
    with pytest.raises(RuntimeError):
        tch.train_step(mg, og, cfg, spec, w, s, 0)
    moved = _moved(before)
    assert not {"replays", "eager", "captures"} & set(moved)
    assert torch.cuda.current_stream() == stream and og.count == 0
    _same_bits({k: v for k, v in _train_state(mg, og).items() if k in start}, start)
    monkeypatch.undo()
    got = tch.train_step(mg, og, cfg, spec, w, s, 0)
    want = tch.train_step(me, oe, cfg, spec, w, s, 0, eager=True)
    _same_bits(got, want)
    _same_bits(_train_state(mg, og), _train_state(me, oe))
