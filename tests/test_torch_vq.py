"""The fused VQ lookup's plain version and the bottleneck that uses it,
against the JAX package: ``vq_lookup_reference`` (the plain version of
csrc/vq.cu) against the Pallas kernel in interpret mode, as
tests/test_vq_pallas.py runs it, and ``VQBottleneck`` with
``vq_use_pallas=True`` against ``_apply_vq`` with the flag, JAX's own draws
fed to the port.  The CUDA kernel runs only on the card:
tests/test_torch_cuda.py and ``chip_smoke.py``."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ae_wavenet_tpu.models import bottlenecks as jbn
from ae_wavenet_tpu.ops import vq_pallas as jvq
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu_torch.models import bottlenecks as tbn
from ae_wavenet_tpu_torch.ops import vq_cuda
from ae_wavenet_tpu_torch.utils import config as tcfg


# the shapes of tests/test_vq_pallas.py, a ragged N below one tile, and one
# row and the serving request's 27 latents at the flagship K and D
@pytest.mark.parametrize("n,k,d,tile", [(512, 128, 64, 256), (300, 128, 64, 256),
                                        (37, 100, 24, 8), (1, 512, 64, 8),
                                        (27, 512, 64, 8)])
def test_reference_matches_pallas(n, k, d, tile):
    rng = np.random.default_rng(0)
    z = rng.normal(size=(n, d)).astype(np.float32)
    e = rng.normal(size=(k, d)).astype(np.float32)
    want = jvq.vq_lookup_fused(jnp.asarray(z), jnp.asarray(e), tile_n=tile,
                               interpret=True)
    before = vq_cuda.vq_lookup_reference.launches
    codes, quant, counts, sums = vq_cuda.vq_lookup_fused(torch.from_numpy(z),
                                                         torch.from_numpy(e))
    assert vq_cuda.vq_lookup_reference.launches == before + 1  # CPU: plain version
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(quant.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    assert torch.equal(quant, torch.from_numpy(e)[codes.long()])
    np.testing.assert_allclose(counts.numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-4)
    assert float(counts.sum()) == n
    np.testing.assert_allclose(sums.numpy(), np.asarray(want[3]), rtol=1e-4, atol=1e-4)


def test_reference_takes_the_first_index_on_ties():
    e = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    z = torch.tensor([[2.0, 0.0], [0.0, 2.0], [0.5, 0.5]])
    codes, quant, counts, _ = vq_cuda.vq_lookup_reference(z, e)
    assert codes.tolist() == [0, 1, 0]
    assert torch.equal(quant, e[codes.long()])
    assert counts.tolist() == [2.0, 1.0, 0.0, 0.0]


def test_wrapper_refuses_what_it_cannot_take():
    z, e = torch.zeros(4, 8), torch.zeros(5, 6)
    with pytest.raises(ValueError, match="need"):
        vq_cuda.vq_lookup_fused(z, e)
    with pytest.raises(ValueError, match="at least one row"):
        vq_cuda.vq_lookup_fused(torch.zeros(0, 6), e)


def _port_bn(cfg):
    return tcfg.from_json(jcfg.to_json(jcfg.RunConfig(bottleneck=cfg))).bottleneck


BN = jcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=32, vq_restart_thresh=0.995,
                           vq_warmup_steps=10, vq_use_pallas=True)


@pytest.mark.parametrize("train", [True, False])
def test_bottleneck_with_fused_lookup_matches_jax(train, monkeypatch):
    """``train_apply`` with ``vq_use_pallas``: the new codebook, counts and
    sums, the straight-through value and every term within 1e-5 of
    ``_apply_vq`` with the flag (Pallas in interpret mode), JAX's jitter
    uniforms and restart indices fed to the port; and the same result as the
    port's unfused path."""
    _, state = jbn.init(jax.random.PRNGKey(1), BN)
    z = (np.random.default_rng(2).normal(size=(2, 16, 40)) * 0.5).astype(np.float32)
    rng, step = jax.random.PRNGKey(3), 4
    # the reference imports its kernel at call time: run it in interpret mode
    monkeypatch.setattr(jvq, "vq_lookup_fused",
                        functools.partial(jvq.vq_lookup_fused, interpret=True))
    zq_j, state_j, aux_j = jbn.apply({}, state, BN, jnp.asarray(z), rng,
                                     jnp.int32(step), train)
    draws = {"jitter_u": torch.tensor(np.asarray(jax.random.uniform(rng, (2, 1, 40)))),
             "restart_idx": torch.tensor(np.asarray(jax.random.randint(
                 jax.random.fold_in(rng, 1), (1, BN.vq_k), 0, 80))).long()}
    loaded = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    port = tbn.make(_port_bn(BN))
    port.load_state_dict(loaded)
    before = vq_cuda.vq_lookup_reference.launches
    zq_t, aux_t = port.train_apply(torch.from_numpy(z), step, train, draws=draws)
    assert vq_cuda.vq_lookup_reference.launches == before + 1
    np.testing.assert_allclose(zq_t.numpy(), np.asarray(zq_j), atol=1e-5)
    for k, v in state_j.items():
        np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(aux_t["restarts"]) == float(aux_j["restarts"])
    assert (float(aux_t["restarts"]) > 0) == train
    np.testing.assert_allclose(aux_t.pop("zq_pre_jitter").numpy(),
                               np.asarray(aux_j.pop("zq_pre_jitter")), atol=1e-5)
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    plain = tbn.make(dataclasses.replace(_port_bn(BN), vq_use_pallas=False))
    plain.load_state_dict(loaded)
    zq_p, _ = plain.train_apply(torch.from_numpy(z), step, train, draws=draws)
    np.testing.assert_allclose(zq_t.numpy(), zq_p.numpy(), atol=1e-6)
    for k in state_j:
        np.testing.assert_allclose(getattr(port, k).numpy(), getattr(plain, k).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_eval_paths_with_fused_lookup_match_the_unfused():
    """``forward`` and ``codes`` (the serving path's halves) through the
    fused lookup against the port's unfused path and the JAX eval apply."""
    _, state = jbn.init(jax.random.PRNGKey(5), BN)
    z = (np.random.default_rng(6).normal(size=(3, 16, 25)) * 0.5).astype(np.float32)
    loaded = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    fused, plain = tbn.make(_port_bn(BN)), tbn.make(
        dataclasses.replace(_port_bn(BN), vq_use_pallas=False))
    fused.load_state_dict(loaded)
    plain.load_state_dict(loaded)
    zt = torch.from_numpy(z)
    assert torch.equal(fused.codes(zt), plain.codes(zt))
    assert tuple(fused.codes(zt).shape) == (1, 75)
    np.testing.assert_allclose(fused(zt).numpy(), plain(zt).numpy(), atol=1e-6)
    zq_j, _, _ = jbn.apply({}, state, dataclasses.replace(BN, vq_use_pallas=False),
                           jnp.asarray(z), jax.random.PRNGKey(0), jnp.int32(0), False)
    np.testing.assert_allclose(fused(zt).numpy(), np.asarray(zq_j), atol=1e-5)


def test_gradient_flows_straight_through_the_fused_lookup():
    port = tbn.make(_port_bn(BN))
    z = torch.randn(2, 16, 12, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    zq, aux = port.train_apply(z, 20, True, torch.Generator().manual_seed(1))
    (zq.sum() + aux["bn_loss"]).backward()
    assert z.grad is not None and bool(torch.isfinite(z.grad).all())
    assert float(z.grad.abs().sum()) > 0


def test_lookup_without_stats_returns_the_same_codes_and_rows():
    """A caller that drops the EMA counts and sums (``codes``, ``forward``)
    gets the same codes and rows, and None for the two it does not read."""
    gen = torch.Generator().manual_seed(3)
    z, e = torch.randn(50, 6, generator=gen), torch.randn(9, 6, generator=gen)
    full = vq_cuda.vq_lookup_fused(z, e)
    lean = vq_cuda.vq_lookup_fused(z, e, stats=False)
    assert torch.equal(full[0], lean[0]) and torch.equal(full[1], lean[1])
    assert lean[2] is None and lean[3] is None
