"""The CUDA sampler kernel against its plain version, on the card.

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
