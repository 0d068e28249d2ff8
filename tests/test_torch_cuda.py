"""The CUDA kernels against their plain versions, on the card: the sampler
and the gated training stack.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  The file
imports no jax, so on a machine with the card and without JAX it runs
without the JAX suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from ae_wavenet_tpu_torch.models import wavenet as twn
from ae_wavenet_tpu_torch.ops import fastgen as tfg
from ae_wavenet_tpu_torch.ops import fastgen_cuda as tfc
from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

# "scalar": widths that are not multiples of 8 columns per block slice
# (the kernel's scalar-load path); "vector": multiples of 64 (its 16-byte
# load path, as at the flagship width)
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


def _setup(dev, batch, n, seed=0, cfg=CFG):
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
    return tfc.pack_for_kernel(wn, cfg), tfc.state_to_flat(state, cfg), state, gcond


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
            "gated_layer_bwd", "gated_layer_bwd_recompute"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEGMENTS)
def test_gated_kernel_matches_plain(cuda_device, name):
    """Every output of each kernel within gchk.SEGMENT_REL_TOL of its plain
    version's largest value, on the same inputs."""
    wn, ids, cond, spk = gchk.random_stack(GCFG, 3, 150, 0, cuda_device)
    dils, _, cond_tm, packed, xs, ys, cot = gchk.segment_inputs(wn, GCFG, ids,
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
    assert rel < gchk.SEGMENT_REL_TOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("save_y", [True, False])
@pytest.mark.parametrize("fuse_pairs", [True, False])
def test_gated_stack_matches_plain(cuda_device, save_y, fuse_pairs):
    """The whole stack through GatedStack with the kernels against the same
    schedule with the plain versions: logits and every gradient."""
    wn, ids, cond, spk = gchk.random_stack(GCFG, 2, 150, 1, cuda_device)
    probe = torch.randn(2, 150, GCFG.n_quant, device=cuda_device)
    lg_k, g_k = gchk.stack_run(wn, GCFG, ids, cond, spk, probe, None, save_y,
                               fuse_pairs)
    lg_p, g_p = gchk.stack_run(wn, GCFG, ids, cond, spk, probe, tgt.PLAIN,
                               save_y, fuse_pairs)
    lg, rel = gchk.stack_errors(lg_k, g_k, lg_p, g_p)
    assert gchk.stack_passes(lg, rel), (lg, rel)
    for name, (wn_bad, ops) in gchk.planted_faults(wn, GCFG).items():
        if "prev tap" in name and not fuse_pairs:
            continue  # that fault sits in the pair kernel's plain version
        lg_f, g_f = gchk.stack_run(wn_bad, GCFG, ids, cond, spk, probe, ops,
                                   save_y, fuse_pairs)
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
        model = ae.init(cfg, torch.Generator().manual_seed(1)).eval()
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
