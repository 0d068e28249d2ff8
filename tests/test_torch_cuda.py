"""The CUDA kernels against their plain versions, on the card: the sampler
(bf16, int8 and int4 weights), the fused VQ lookup, the gated training
stack, the MFCC inverter's path through them, and the int8 quality gate.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  The file
imports no jax, so on a machine with the card and without JAX it runs
without the JAX suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
    scale = float(want[3].abs().max())
    agree = 0
    for r in range(batch):
        diff = torch.nonzero(got[0][r] != want[0][r])
        t_div = n if len(diff) == 0 else int(diff[0])
        agree += t_div
        hi = min(t_div + 1, n)
        rel = float((got[3][:hi, r] - want[3][:hi, r]).abs().max()) / scale
        assert rel < LOGIT_TOL, (r, t_div, rel)
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
# at the ``chorowski`` widths (chip_smoke.py LOGIT_REL_TOL and
# Q_LOGIT_REL_TOL; tests_tpu/test_pallas_tpu.py:236 for bf16): f32 sums of
# 928-wide products in another order, through 20 layers or more
FLAGSHIP_TOL = {None: 0.05, "int8": 0.01, "int4": 0.01}


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
    scale = float(want[3].abs().max())
    agree = 0
    for r in range(batch):
        diff = torch.nonzero(got[0][r] != want[0][r])
        t_div = n if len(diff) == 0 else int(diff[0])
        agree += t_div
        hi = min(t_div + 1, n)
        rel = float((got[3][:hi, r] - want[3][:hi, r]).abs().max()) / scale
        assert rel < Q_LOGIT_TOL, (r, t_div, rel)
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
    tol = tol or (LOGIT_TOL if mode is None else Q_LOGIT_TOL)
    scale = float(want[3].abs().max())
    assert bool(torch.isfinite(got[3]).all())
    agree = 0
    for r in range(batch):
        diff = torch.nonzero(got[0][r] != want[0][r])
        t_div = n if len(diff) == 0 else int(diff[0])
        agree += t_div
        hi = min(t_div + 1, n)
        rel = float((got[3][:hi, r] - want[3][:hi, r]).abs().max()) / scale
        assert rel < tol, (r, t_div, rel)
    assert agree >= n * batch // 2
    return got


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
                   tol=FLAGSHIP_TOL[mode])


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


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(512, 128, 64), (301, 128, 64), (37, 100, 30),
                                   (5, 700, 8), (1, 512, 64), (27, 512, 64),
                                   (640, 512, 64), (4099, 512, 64)])
def test_vq_kernel_matches_plain_version(cuda_device, n, k, d):
    """Codes equal except on near-ties (under 1% of rows, each with a
    relative distance gap under 1e-5), quant the codebook rows bit for bit,
    counts exact, sums within 1e-4, and the same bits on a second launch;
    ragged N, K above one pass of the block and a D off the 16-byte path;
    one row, the serving request's 27 and the training step's 640 latents
    at the flagship K and D, and N past one chunk of the statistics' scan;
    one device operation per call, with and without the statistics."""
    gen = torch.Generator().manual_seed(n)
    z = (torch.randn(n, d, generator=gen) * 0.5).to(cuda_device)
    e = (torch.randn(k, d, generator=gen) / d ** 0.5).to(cuda_device)
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
    differ = torch.nonzero(codes != want[0].long())[:, 0]
    assert len(differ) <= n // 100
    d2 = e.square().sum(1)[None] - 2.0 * z.double() @ e.double().t()
    for r in differ.tolist():
        gap = abs(float(d2[r, codes[r]] - d2[r, want[0][r].long()]))
        assert gap <= 1e-5 * float(d2[r].abs().max()), (r, gap)
    assert torch.equal(got[1], e[codes])
    assert torch.equal(got[2], torch.bincount(codes, minlength=k).float())
    same = codes == want[0].long()
    if bool(same.all()):
        assert float((got[3] - want[3]).abs().max()) <= 1e-4 * float(
            want[3].abs().max())


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

from ae_wavenet_tpu_torch.ops import gated as tgt  # noqa: E402
from ae_wavenet_tpu_torch.ops import gated_check as gchk  # noqa: E402
from ae_wavenet_tpu_torch.ops import gated_cuda as tgc  # noqa: E402

# the tiny preset's widths (n_res 32, cond 32 + 8: not multiples of 64),
# dilations up to 128 (above the kernels' 64-row tile), a ragged T
GCFG = WaveNetConfig(n_blocks=1, n_block_layers=8, n_res=32, n_dil=32,
                     n_skp=32, n_post=32, n_lc_in=16, n_lc_out=32,
                     n_global_embed=8, n_speakers=10)
SEGMENTS = ["gated_pair_fused", "gated_layer_fused", "gated_pair_bwd",
            "gated_layer_bwd", "gated_layer_bwd_recompute", "gated_stack_fused",
            "gated_stack_fused_no_save", "gated_group_bwd", "gated_group_bwd_3"]


def _held_against_plain(cfg, batch, t_out, name, dev):
    """Every output of kernel case ``name`` within gchk.SEGMENT_REL_TOL of
    its plain version's largest value, on the same inputs."""
    wn, ids, cond, spk = gchk.random_stack(cfg, batch, t_out, 0, dev)
    dils, _, cond_tm, packed, xs, ys, cot = gchk.segment_inputs(wn, cfg, ids,
                                                                cond, spk)
    wrapper, call = gchk.segment_calls(dils, cond_tm, packed, xs, ys, cot)[name]
    fn = getattr(tgc, wrapper)
    before = fn.launches
    got = call(fn)
    want = call(getattr(tgt, wrapper + "_reference"))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(torch.isfinite(g.float()).all())
    _, rel = gchk.compare_outputs(got, want)
    assert rel < gchk.segment_tolerance(name), rel
    if name == "gated_stack_fused":  # and each layer on the kernel's own streams
        _, rel = gchk.compare_outputs(
            got, gchk.stack_layerwise(got, dils, cond_tm, packed, xs[0]))
        assert rel < gchk.SEGMENT_REL_TOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEGMENTS)
def test_gated_kernel_matches_plain(cuda_device, name):
    """Every output of each kernel within gchk.SEGMENT_REL_TOL of its plain
    version's largest value, on the same inputs."""
    _held_against_plain(GCFG, 3, 150, name, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gated_pair_fused", "gated_layer_fused",
                                  "gated_pair_bwd", "gated_layer_bwd",
                                  "gated_layer_bwd_recompute",
                                  "gated_stack_fused", "gated_stack_fused_no_save",
                                  "gated_group_bwd", "gated_group_bwd_3"])
def test_gated_kernel_matches_plain_at_flagship_width(cuda_device, name):
    """The Hopper kernels at the ``chorowski`` widths (n_res 384, cond 160,
    n_dil 256, n_skp 256: the tile shapes of the main path) on a short ragged
    T (4,100 = 64 x 64 + 4 loss samples), B = 2: the pair and single-layer
    kernels (the recompute mode's xin, 2 x 384 + 160 wide, is the largest
    tile, with the fewest ring stages beside it), the whole stack's 20 layers
    and groups of 5 and 3."""
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    _held_against_plain(chorowski_config().wavenet, 2, 4100, name, cuda_device)


def _same_bits_twice(name, dev):
    """Two launches of kernel case ``name`` on the same inputs give every
    output bit for bit."""
    wn, ids, cond, spk = gchk.random_stack(GCFG, 3, 150, 0, dev)
    dils, _, cond_tm, packed, xs, ys, cot = gchk.segment_inputs(wn, GCFG, ids,
                                                                cond, spk)
    wrapper, call = gchk.segment_calls(dils, cond_tm, packed, xs, ys, cot)[name]
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
    wn, ids, cond, spk = gchk.random_stack(cfg, 2, 150, 0, cuda_device)
    dils, x0, cond_tm, packed, xs, ys, cot = gchk.segment_inputs(wn, cfg, ids, cond,
                                                                 spk)
    vl = lambda m: tgt.valid_lo(dils, m)  # noqa: E731
    skip0 = gchk._skip0(x0, packed, 1)
    if name == "gated_stack_fused":
        dils, packed = dils[:most], packed[:most]

        def call(fn):
            skip, mids, ys_all = fn(x0, cond_tm, skip0.clone(), packed, dils=dils,
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
    _, rel = gchk.compare_outputs(got, want)
    assert rel < gchk.DRIFT_REL_TOL, rel
    if name == "gated_stack_fused":
        _, rel = gchk.compare_outputs(
            got, gchk.stack_layerwise(got, dils, cond_tm, packed, x0))
    else:  # (gxc, gxp, gcond, then dW_in, db_in, dW_out, db_out per layer, lowest first)
        _, rel = gchk.compare_outputs(got[-4 * 5:], want[-4 * 5:])
    assert rel < gchk.SEGMENT_REL_TOL, rel


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
@pytest.mark.parametrize("name", sorted(gchk.planted_segment_faults()))
def test_gated_kernel_rejects_planted_fault(cuda_device, name):
    """A fault planted in the plain version fails the kernel's own check."""
    segment, bad = gchk.planted_segment_faults()[name]
    wn, ids, cond, spk = gchk.random_stack(GCFG, 3, 150, 0, cuda_device)
    dils, _, cond_tm, packed, xs, ys, cot = gchk.segment_inputs(wn, GCFG, ids,
                                                                cond, spk)
    wrapper, call = gchk.segment_calls(dils, cond_tm, packed, xs, ys, cot)[segment]
    _, rel = gchk.compare_outputs(call(getattr(tgc, wrapper)), call(bad))
    assert rel >= gchk.SEGMENT_REL_TOL, rel


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
@pytest.mark.parametrize("save_y", [True, False])
@pytest.mark.parametrize("fuse_pairs", [True, False])
@pytest.mark.parametrize("full_fusion", [False, True])
@pytest.mark.parametrize("bwd_group", [0, 3])
def test_gated_stack_matches_plain(cuda_device, save_y, fuse_pairs, full_fusion,
                                   bwd_group):
    """The whole stack through GatedStack with the kernels against the same
    schedule with the plain versions: logits and every gradient."""
    wn, ids, cond, spk = gchk.random_stack(GCFG, 2, 150, 1, cuda_device)
    probe = torch.randn(2, 150, GCFG.n_quant, device=cuda_device)
    sched = dict(full_fusion=full_fusion, bwd_group=bwd_group)
    if bwd_group and not save_y:
        with pytest.raises(ValueError, match="gated_save_y"):
            gchk.stack_run(wn, GCFG, ids, cond, spk, probe, None, save_y,
                           fuse_pairs, **sched)
        return
    counted = {tgc.gated_stack_fused: int(full_fusion),
               tgc.gated_group_bwd: 2 if bwd_group else 0}  # (0,1,2) (3,4,5) (6,7)
    before = {f: f.launches for f in counted}
    lg_k, g_k = gchk.stack_run(wn, GCFG, ids, cond, spk, probe, None, save_y,
                               fuse_pairs, **sched)
    assert {f: f.launches - before[f] for f in counted} == counted
    lg_p, g_p = gchk.stack_run(wn, GCFG, ids, cond, spk, probe, tgt.PLAIN,
                               save_y, fuse_pairs, **sched)
    lg, rel = gchk.stack_errors(lg_k, g_k, lg_p, g_p)
    assert gchk.stack_passes(lg, rel), (lg, rel)
    for name, (wn_bad, ops, kw) in gchk.planted_faults(wn, GCFG).items():
        if kw["full_fusion"] != full_fusion or ("pair" in name and not fuse_pairs):
            continue  # that fault sits in a kernel this schedule does not run
        lg_f, g_f = gchk.stack_run(wn_bad, GCFG, ids, cond, spk, probe, ops,
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
    wn, ids, cond, spk = gchk.random_stack(GCFG, 1, 40, 2, cuda_device)
    dils, x0, cond_tm, packed, *_ = gchk.segment_inputs(wn, GCFG, ids, cond, spk)
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
    scale = float(want[3].abs().max())
    agree = 0
    for r in range(2):
        diff = torch.nonzero(got[0][r] != want[0][r])
        t_div = n if len(diff) == 0 else int(diff[0])
        agree += t_div
        hi = min(t_div + 1, n)
        rel = float((got[3][:hi, r] - want[3][:hi, r]).abs().max()) / scale
        assert rel < LOGIT_TOL, (r, t_div, rel)
    assert agree >= n
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
    bf16 one + 0.15 (int4's is computed, with no gate)."""
    from ae_wavenet_tpu_torch.eval.quality import quantized_quality_gate

    r = quantized_quality_gate(str(tmp_path), cuda_device)
    dists = {k: r[k] for k in ("d16", "d8", "d4", "silence")}
    assert r["n"] == 16384 and all(np.isfinite(v) for v in dists.values()), dists
    assert r["passed"], dists
