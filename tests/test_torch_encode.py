"""The port's encode path against the JAX package (CPU, f32): conv
primitives, encoder, bottlenecks, upsampler and ``autoencoder.encode``.

Weights come from the JAX init and cross by their dotted names
(``flatten_named`` -> ``weights.from_named``)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ae_wavenet_tpu.geometry.vconv import Range
from ae_wavenet_tpu.models import autoencoder as jae
from ae_wavenet_tpu.models import bottlenecks as jbn
from ae_wavenet_tpu.models import encoder as jenc
from ae_wavenet_tpu.models import wavenet as jwn
from ae_wavenet_tpu.ops import conv1d as jconv
from ae_wavenet_tpu.training.torch_compat import flatten_named
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu_torch.geometry import vconv as tv
from ae_wavenet_tpu_torch.models import autoencoder as tae
from ae_wavenet_tpu_torch.models import wavenet as twn
from ae_wavenet_tpu_torch.ops import conv1d as tconv
from ae_wavenet_tpu_torch.training.weights import from_named
from ae_wavenet_tpu_torch.utils import config as tcfg

# f32 on both sides; XLA and torch sum convolutions in other orders
RTOL, ATOL = 1e-4, 1e-5


def _cfg(kind="vq", groups=1):
    base = jcfg.tiny_config()
    return dataclasses.replace(
        base,
        bottleneck=jcfg.BottleneckConfig(kind=kind, n_dim=16, vq_k=64,
                                         vq_groups=groups),
        train=dataclasses.replace(base.train, aux_frame_weight=1.0),
    )


@functools.lru_cache(maxsize=None)
def _models(cfg, seed=0):
    """JAX init and the port model holding the same weights (cached: the
    JAX init dominates this file's run time)."""
    params, bn = jae.init(jax.random.PRNGKey(seed), cfg)
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    model = from_named(flatten_named({"params": params, "bn_state": bn}), port_cfg)
    return params, bn, model, port_cfg


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 3)])
def test_conv1d_matches_jax(stride, dilation):
    """Delta probes (one unit impulse per input position) fix the output
    lattice and tap order; a random input checks the sums."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(7, 5, 3)).astype(np.float32)
    for j in range(12):
        x = np.zeros((1, 5, 12), np.float32)
        x[0, 2, j] = 1.0
        want = jconv.conv1d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                            dilation=dilation)
        got = tconv.conv1d(_t(x), _t(w), stride=stride, dilation=dilation)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.normal(size=(2, 5, 40)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    want = jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        stride=stride, dilation=dilation)
    got = tconv.conv1d(_t(x), _t(w), _t(b), stride=stride, dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("f,stride", [(10, 5), (8, 4), (5, 2), (3, 1)])
def test_tconv1d_delta_probes(f, stride):
    """A unit impulse at each input position picks out the taps: the output
    lattice and tap order must equal the reference's (phase-decomposed
    when f % stride == 0, zero-stuffed otherwise)."""
    rng = np.random.default_rng(1)
    t_in = 6
    w = rng.normal(size=(3, 2, f)).astype(np.float32)
    for j in range(t_in):
        x = np.zeros((1, 2, t_in), np.float32)
        x[0, 1, j] = 1.0
        want = np.asarray(jconv.tconv1d(jnp.asarray(x), jnp.asarray(w), stride=stride))
        got = tconv.tconv1d(_t(x), _t(w), stride=stride).numpy()
        assert got.shape == want.shape == (1, 3, (t_in - 1) * stride + 1 - (f - 1))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    x = rng.normal(size=(2, 2, t_in)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    want = jconv.tconv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride)
    got = tconv.tconv1d(_t(x), _t(w), _t(b), stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_encoder_matches_jax():
    cfg = _cfg()
    params, _, model, _ = _models(cfg)
    x = np.random.default_rng(2).normal(size=(2, 39, 40)).astype(np.float32)
    want = np.asarray(jenc.apply(params["encoder"], cfg.encoder, jnp.asarray(x)))
    with torch.no_grad():
        got = model.encoder(_t(x)).numpy()
    assert got.shape == want.shape == (2, 16, jenc.geometry(cfg.encoder).out_len(40))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("kind,groups", [("ae", 1), ("zero", 1), ("vae", 1),
                                         ("vq", 1), ("vq", 4)])
def test_bottleneck_eval_matches_jax(kind, groups):
    """Eval path.  VQ codes must be identical; the reference allows up to
    1% to differ only where two codes tie in distance, which these inputs
    (drawn from the data cloud around the codebook) do not produce."""
    cfg = _cfg(kind, groups)
    params, bn, model, _ = _models(cfg)
    z = np.random.default_rng(3).normal(size=(2, 16, 30)).astype(np.float32) * 0.3
    want, _, _ = jbn.apply(params["bottleneck"], bn, cfg.bottleneck, jnp.asarray(z),
                           jax.random.PRNGKey(0), jnp.int32(0), train=False)
    with torch.no_grad():
        got = model.bottleneck(_t(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    if kind == "vq":
        # reference codes: the codebook row each reference output equals
        e = np.asarray(bn["codebook"]).reshape(groups, 64, 16 // groups)
        zg = np.asarray(want).transpose(0, 2, 1).reshape(-1, groups, 16 // groups)
        d2 = ((zg.transpose(1, 0, 2)[:, :, None, :] - e[:, None]) ** 2).sum(-1)
        want_codes = d2.argmin(-1)
        got_codes = model.bottleneck.codes(_t(z)).numpy()
        assert np.array_equal(got_codes, want_codes)
        assert len(np.unique(got_codes)) > 4  # not a collapsed probe


@pytest.mark.parametrize("planned", [False, True])
def test_upsample_matches_jax(planned):
    cfg = _cfg()
    params, _, model, port_cfg = _models(cfg)
    z = np.random.default_rng(4).normal(size=(2, 16, 9)).astype(np.float32)
    steps = port_steps = None
    if planned:  # each side runs its own package's plan
        up = jwn.upsample_geometry(cfg.wavenet)
        steps = up.plan(Range(0, up.out_len(9)))
        port_up = twn.upsample_geometry(port_cfg.wavenet)
        port_steps = port_up.plan(tv.Range(0, port_up.out_len(9)))
    want = np.asarray(jwn.upsample_apply(params["wavenet"], cfg.wavenet,
                                         jnp.asarray(z), steps))
    with torch.no_grad():
        got = twn.upsample_apply(model.wavenet, port_cfg.wavenet, _t(z),
                                 port_steps).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("preset", ["tiny", "chorowski"])
def test_geometry_and_window_spec_match_jax(preset):
    """Integer geometry, so exact: the dilated stack, receptive field, the
    cond chain and the window layout whose frame count encode normalizes
    over."""
    cfg = jcfg.PRESETS[preset]()
    port_cfg = tcfg.from_json(jcfg.to_json(cfg))
    asdict = dataclasses.asdict  # the two packages' geometry classes differ
    assert (asdict(twn.dilated_geometry(port_cfg.wavenet))
            == asdict(jwn.dilated_geometry(cfg.wavenet)))
    assert twn.receptive_field(port_cfg.wavenet) == jwn.receptive_field(cfg.wavenet)
    assert asdict(tae.cond_chain(port_cfg)) == asdict(jae.cond_chain(cfg))
    for n_win in (None, 4000):
        assert (dataclasses.asdict(tae.make_window_spec(port_cfg, n_win))
                == dataclasses.asdict(jae.make_window_spec(cfg, n_win)))


@pytest.mark.parametrize("kind", ["vq", "ae"])
def test_autoencoder_encode_matches_jax(kind):
    cfg = _cfg(kind)
    params, bn, model, port_cfg = _models(cfg)
    wav = (np.random.default_rng(5).normal(size=(2, 8000)) * 3000).astype(np.int16)
    want, want_off = jae.encode(params, bn, cfg, jnp.asarray(wav), jax.random.PRNGKey(0))
    got, got_off = tae.encode(model, port_cfg, _t(wav))
    assert got_off == want_off
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
