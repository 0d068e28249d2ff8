"""The port's mu-law codec and MFCC frontend against the JAX package (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ae_wavenet_tpu.audio import mfcc as jmfcc
from ae_wavenet_tpu.audio import mulaw as jmulaw
from ae_wavenet_tpu.models import common as jcommon
from ae_wavenet_tpu_torch.audio import mfcc as tmfcc
from ae_wavenet_tpu_torch.audio import mulaw as tmulaw
from ae_wavenet_tpu_torch.models import common as tcommon
from ae_wavenet_tpu_torch.utils import config as tcfg


def test_mu_encode_all_int16_values():
    """Ids of every int16 value equal JAX's.  Both round half to even; the
    only allowed differences are at a .5 rounding boundary, where one ulp
    of log1p (the two libraries' log1p may differ by one) flips the
    rounding: |frac - 0.5| < 1e-4 in float64."""
    x = np.arange(-32768, 32768, dtype=np.int16)
    want = np.asarray(jmulaw.mu_encode(jmulaw.int16_to_float(jnp.asarray(x))))
    got = tmulaw.mu_encode(tmulaw.int16_to_float(torch.from_numpy(x))).numpy()
    diff = np.nonzero(want != got)[0]
    f = x.astype(np.float64) / 32768.0
    y = np.sign(f) * np.log1p(255.0 * np.abs(f)) / np.log1p(255.0)
    pos = (y + 1.0) * 127.5
    near_half = np.abs(pos - np.floor(pos) - 0.5) < 1e-4
    assert np.all(near_half[diff]), x[diff[~near_half[diff]]]
    assert np.all(np.abs(want[diff] - got[diff]) == 1)
    assert len(diff) <= 8, len(diff)


def test_mu_decode_all_ids():
    q = np.arange(256, dtype=np.int32)
    want = np.asarray(jmulaw.mu_decode(jnp.asarray(q)))
    got = tmulaw.mu_decode(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # exact round trip on the decodable set, as the reference's contract
    assert np.array_equal(tmulaw.mu_encode(torch.from_numpy(got)).numpy(), q)


def _wav(seed=0, batch=2, n=4000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t) * (1 + 0.5 * np.sin(7 * t))
    return (tone[None] + 0.05 * rng.normal(size=(batch, n))).astype(np.float32)


SPECS = {
    "default": tcfg.SpecConfig(),
    "fmax": tcfg.SpecConfig(n_mels=32, n_mfcc=10, mel_fmax=6000.0, delta_wing=1),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_mfcc_delta_stack_matches_jax(name):
    """f32 on both sides; the matmuls sum in another order and the log
    amplifies relative error of small mel energies, so the tolerance is
    atol 2e-3 on values of magnitude ~10-100 (relative 1e-4)."""
    spec_t = SPECS[name]
    spec_j = jmfcc.SpecConfig(**dataclasses.asdict(spec_t))
    wav = _wav()
    want = np.asarray(jmfcc.mfcc_delta_stack(jnp.asarray(wav), spec_j))
    got = tmfcc.mfcc_delta_stack(torch.from_numpy(wav), spec_t).numpy()
    assert got.shape == want.shape == (2, spec_t.n_out_channels, want.shape[-1])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("n_ref", [None, 11])
def test_normalize_frames_window(n_ref):
    frames = np.random.default_rng(1).normal(3.0, 2.0, (2, 39, 23)).astype(np.float32)
    want = np.asarray(jcommon.normalize_frames(jnp.asarray(frames), n_ref=n_ref))
    got = tcommon.normalize_frames(torch.from_numpy(frames), n_ref=n_ref).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_normalize_frames_dataset_stats():
    rng = np.random.default_rng(2)
    spec_t = tcfg.SpecConfig(norm="dataset",
                             stats_mean=tuple(rng.normal(size=39).tolist()),
                             stats_var=tuple(rng.uniform(0.5, 2, 39).tolist()))
    spec_j = jmfcc.SpecConfig(**dataclasses.asdict(spec_t))
    frames = rng.normal(size=(2, 39, 17)).astype(np.float32)
    want = np.asarray(jcommon.normalize_frames(jnp.asarray(frames), spec=spec_j))
    got = tcommon.normalize_frames(torch.from_numpy(frames), spec=spec_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
