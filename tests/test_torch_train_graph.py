"""The training step restated so that every input is a tensor
(``training/chassis._StepProgram``), on the CPU, against the JAX package
and against the draws and scalars it replaced.

On the card the restated step is captured once as a CUDA graph and
replayed K times a call (``tests/test_torch_cuda.py`` holds the graph to
this same step called eagerly, bit for bit); here the same step runs in
its Python loop.  What the graph would freeze is checked here:

* the draws (VQ restarts and jitter, the VAE's normals) are made up front
  from the step's generator with the calls, order and shapes the loss
  would make them in: the same bits, and the generator left in the same
  state; the inverter draws nothing;
* the warm-up ramps read the step as a device tensor: the same bits as
  from the host's int;
* Adam's bias corrections come from a host table read on the device, its
  learning rates from the host: 5 updates with a piecewise LR and the clip
  on within 1e-6 of optax, as ``tests/test_torch_train.py``'s one-step
  test;
* a load copies into the moments' storages (a graph reads them by address)
  and drops the cached step programs;
* 6 steps at K = 1 and K = 3 against the JAX chassis's 6 single steps
  from the same exported weights, draw-free (jitter 0, no restarts) with
  the VQ warm-up ramp on: recon CE and loss within 1e-3 at every log
  point, the tolerance of the resumed-steps test in
  ``tests/test_torch_train.py``.

Tiny widths, one torch thread; about 25 s, most of it the JAX step's
compile.
"""

import dataclasses
import io
import os
import shutil

import numpy as np
import pytest
import torch

from ae_wavenet_tpu.data.preprocess import make_synthetic_dataset
from ae_wavenet_tpu.training import chassis as jch
from ae_wavenet_tpu.training import torch_compat
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu_torch.models import bottlenecks as tbn
from ae_wavenet_tpu_torch.models import registry
from ae_wavenet_tpu_torch.training import chassis as tch
from ae_wavenet_tpu_torch.training import checkpoint as tckpt
from ae_wavenet_tpu_torch.utils import config as tcfg

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_prefix(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("data") / "synth")
    make_synthetic_dataset(prefix, n_clips=8, n_speakers=4, clip_len=(9000, 14000),
                           seed=0)
    return prefix


def _port_cfg(cfg):
    return tcfg.from_json(jcfg.to_json(cfg))


def _kind(name: str) -> tcfg.RunConfig:
    """The tiny config with a VQ bottleneck that restarts and jitters, a
    VAE, or the MFCC inverter (no bottleneck)."""
    base = tcfg.tiny_config()
    if name == "vq":
        return dataclasses.replace(base, bottleneck=tcfg.BottleneckConfig(
            kind="vq", n_dim=16, vq_k=32, vq_restart_thresh=0.5, jitter_p=0.3))
    if name == "vae":
        return dataclasses.replace(base, bottleneck=tcfg.BottleneckConfig(
            kind="vae", n_dim=16, kl_anneal_steps=10))
    return dataclasses.replace(
        base, model_kind="mfcc_inverter",
        wavenet=dataclasses.replace(base.wavenet, lc_upsample_strides=(5, 4, 4, 2),
                                    lc_upsample_filters=(10, 8, 8, 4)))


def _batch(cfg, spec, seed=0):
    rng = np.random.default_rng(seed)
    b = cfg.train.batch_sz
    wav = torch.from_numpy(rng.integers(-8000, 8000, (b, spec.u_len), dtype=np.int16))
    spk = torch.from_numpy(rng.integers(0, cfg.wavenet.n_speakers, (b,)))
    return wav, spk


@pytest.mark.parametrize("name,keys", [("vq", ["restart_idx", "jitter_u"]),
                                       ("vae", ["eps"]), ("inverter", [])])
def test_upfront_draws_equal_the_loss_fns_own(monkeypatch, name, keys):
    """The family's ``draws`` from one step generator against what the loss
    draws from an equally seeded one: the same names in the same order,
    the same bits, the generators left in the same state, and the loss fed
    the up-front draws equal to the loss that drew them."""
    cfg = _kind(name)
    fam = registry.get(cfg.model_kind)
    spec = fam.make_window_spec(cfg)
    model = fam.init(cfg, torch.Generator().manual_seed(1), "cpu")
    wav, spk = _batch(cfg, spec)
    seen: dict = {}
    draw = tbn._draw

    def recorded(draws, key, make):
        seen[key] = draw(draws, key, make)
        return seen[key]

    monkeypatch.setattr(tbn, "_draw", recorded)
    gen_loss = tch.step_generator(cfg.train.seed, 7, "cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    own, m_own = fam.loss_fn(model, cfg, spec, wav, spk, 7, True, gen_loss)
    model.load_state_dict(state)  # the VQ step moved the codebook
    gen_up = tch.step_generator(cfg.train.seed, 7, "cpu")
    up = fam.draws(model, cfg, spec, wav.shape[0], gen_up, "cpu")
    assert list(seen) == keys and list(up) == keys
    for k in keys:
        assert up[k].dtype == seen[k].dtype and torch.equal(up[k], seen[k]), k
    assert torch.equal(gen_up.get_state(), gen_loss.get_state())
    monkeypatch.undo()
    fed, m_fed = fam.loss_fn(model, cfg, spec, wav, spk, 7, True, None, up)
    assert torch.equal(fed, own)
    for k in m_own:
        assert torch.equal(m_fed[k], m_own[k]), k


def test_ramp_takes_the_step_as_a_device_tensor():
    """``_ramp`` of the step as an f32 0-d tensor (a row of the step
    program's table) against the host's int, bit for bit, below, at and
    past the ramp's end."""
    for n in (0, 3, 20000):
        for step in (0, 1, 2, 3, 7, 12345, 20000, 99999):
            got = tbn._ramp(torch.tensor(float(step)), n, "cpu")
            assert torch.equal(got, tbn._ramp(step, n, "cpu")), (n, step)


def test_restated_adam_matches_optax_over_5_steps():
    """The bias corrections of 5 updates made at once (the K-step call's
    table) and their learning rates, then 5 updates reading one row each,
    with a piecewise LR and the global clip: parameters within 1e-6 of
    optax after each update, and the state under optax's names with
    optax's values."""
    cfg = jcfg.RunConfig(train=dataclasses.replace(
        jcfg.TrainConfig(learning_rate=2e-3), grad_clip=0.5, lr_boundaries=(2, 4),
        lr_values=(2e-3, 1e-3, 5e-4)))
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    opt = jch.make_optimizer(cfg)
    pj = jax.tree.map(jnp.asarray, p0)
    sj = opt.init(pj)
    pt = {"a": torch.tensor(p0["a"]), "b.c": torch.tensor(p0["b"]["c"])}
    adam = tch.Adam(pt.items(), _port_cfg(cfg).train)
    table, rates = adam.corrections(5, "cpu"), adam.rates(5)
    assert table.shape == (5, 2) and adam.count == adam.sched_count == 0
    assert rates == [2e-3, 2e-3, 1e-3, 1e-3, 5e-4]
    for i in range(5):
        g = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
        u, sj = opt.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = jax.tree.map(lambda p, d: p + d, pj, u)
        adam.update({"a": torch.tensor(g["a"]), "b.c": torch.tensor(g["b"]["c"])},
                    table[i], rates[i])
        np.testing.assert_allclose(pt["a"].numpy(), np.asarray(pj["a"]), atol=1e-6)
        np.testing.assert_allclose(pt["b.c"].numpy(), np.asarray(pj["b"]["c"]),
                                   atol=1e-6)
    adam.advance(5)
    want = torch_compat.flatten_named({"opt_state": sj})
    got = adam.named_state()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_load_named_keeps_every_storage(data_prefix, tmp_path):
    """A resume copies the optimizer's moments and the model's tensors into
    their own storages (a captured step reads them by address), with the
    saved values, and drops the cached step programs."""
    cfg = dataclasses.replace(tcfg.tiny_config(), train=dataclasses.replace(
        tcfg.tiny_config().train, log_every=1))
    a = tch.Chassis(cfg, data_prefix, ckpt_dir=str(tmp_path), device="cpu",
                    log_stream=io.StringIO())
    a.train(2)
    a.save()
    b = tch.Chassis(cfg, data_prefix, ckpt_dir=str(tmp_path), device="cpu",
                    log_stream=io.StringIO())
    b.train(1)
    assert len(b.opt.programs) == 1
    ptrs = {k: t.data_ptr() for k, t in {**b.opt.mu, **{f"nu.{k}": v for k, v in
                                                        b.opt.nu.items()},
                                         **b.model.state_dict()}.items()}
    assert b.resume() == 2 and b.opt.count == 2 and not b.opt.programs
    after = {k: t.data_ptr() for k, t in {**b.opt.mu, **{f"nu.{k}": v for k, v in
                                                         b.opt.nu.items()},
                                          **b.model.state_dict()}.items()}
    assert after == ptrs
    for k, v in a.opt.named_state().items():
        assert torch.equal(b.opt.named_state()[k], v), k


def test_train_step_runs_the_program_eagerly_on_the_cpu(data_prefix):
    """On the CPU every call is K eager steps of one cached program per
    batch shape and K; nothing is captured or replayed; the Adam counts
    move by K a call."""
    cfg = tcfg.tiny_config()
    fam = registry.get(cfg.model_kind)
    spec = fam.make_window_spec(cfg)
    model = fam.init(cfg, torch.Generator().manual_seed(1), "cpu")
    opt = tch.Adam(model.named_parameters(), cfg.train)
    wav, spk = _batch(cfg, spec)
    before = (tch.train_step.eager_steps, tch.train_step.graph_replays,
              tch.train_step.captures)
    m = tch.train_step(model, opt, cfg, spec, wav, spk, 0)
    m3 = tch.train_step(model, opt, cfg, spec, torch.stack([wav] * 3),
                        torch.stack([spk] * 3), 1, 3)
    tch.prepare_step(model, opt, cfg, spec, wav, spk, 4)
    m1 = tch.train_step(model, opt, cfg, spec, wav, spk, 4)
    assert (tch.train_step.eager_steps - before[0], tch.train_step.graph_replays
            - before[1], tch.train_step.captures - before[2]) == (5, 0, 0)
    assert len(opt.programs) == 2 and opt.count == 5
    assert set(m) == set(m3) == set(m1) >= {"loss", "recon_ce", "grad_norm"}
    assert all(v.dim() == 0 and torch.isfinite(v) for v in m1.values())


def _six_step_cfg(k: int):
    """Draw-free VQ (jitter 0, no restarts) with its commitment ramp over 4
    steps (the step tensor moves the loss), the aux head on, 6 steps."""
    base = jcfg.tiny_config()
    return dataclasses.replace(
        base,
        bottleneck=jcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=64, jitter_p=0.0,
                                         vq_restart_thresh=0.0, vq_warmup_steps=4),
        train=dataclasses.replace(base.train, n_steps=6, log_every=1,
                                  steps_per_call=k, aux_frame_weight=1.0))


@pytest.fixture(scope="module")
def jax_six_steps(data_prefix, tmp_path_factory):
    """The JAX chassis's 6 steps from its init, logged after each, and the
    init exported for the port."""
    cfg = _six_step_cfg(1)
    ja = jch.Chassis(cfg, data_prefix, log_stream=io.StringIO())
    tree = {"params": ja.params, "opt_state": ja.opt_state, "bn_state": ja.bn_state}
    ckpt = tmp_path_factory.mktemp("ck")
    path = tckpt.checkpoint_path(str(ckpt), 0)
    torch_compat.export_torch(path, 0, tree, cfg)
    want = ja.train(6)
    ja.close()
    return path, want


@pytest.mark.parametrize("k", [1, 3])
def test_restated_step_matches_jax_over_6_steps(data_prefix, tmp_path, jax_six_steps, k):
    """6 steps, K a call, of the port's chassis from the JAX init (exported,
    resumed at step 0) on the JAX chassis's windows, against its steps at
    the port's log points (every K steps)."""
    path, want = jax_six_steps
    ckpt = str(tmp_path / "ck")
    os.makedirs(ckpt)
    shutil.copy(path, tckpt.checkpoint_path(ckpt, 0))
    port = tch.Chassis(_port_cfg(_six_step_cfg(k)), data_prefix, ckpt_dir=ckpt,
                       device="cpu", log_stream=io.StringIO())
    assert port.resume() == 0
    got = port.train(6)
    assert [h["step"] for h in got] == list(range(k, 7, k))
    assert [h["step"] for h in want] == list(range(1, 7))
    for key in ("recon_ce", "loss"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [want[h["step"] - 1][key] for h in got],
                                   atol=1e-3, rtol=0, err_msg=key)
    assert port.opt.count == 6
