"""The port's training path against the JAX package, on the CPU: the
precision setting of the CLIs, the bottlenecks' training halves, the loss,
the optimizer step, the sampler, checkpoints and resume.

Inputs are made with numpy from a seed (or drawn by the JAX package) and
fed to both packages; the bottlenecks' random draws (jitter uniforms,
restart indices, VAE normals) are JAX's own, handed to the port.
Tolerances: bottleneck state and terms within 1e-5 (f32, the same
operations); loss at ``tiny_config`` in f32: recon CE within 1e-4 and
total within 1e-3 (``tests/test_parity_torch.py:53,89-90``); the bf16
slice through the fused stack: CE within 1e-2 and gradients within 0.05
of the largest (bf16 rounding order); one optimizer step: parameters
within 1e-6; the sampler: equal.
"""

import dataclasses
import functools
import io
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ae_wavenet_tpu.data import dataset as jds
from ae_wavenet_tpu.models import autoencoder as jae
from ae_wavenet_tpu.models import bottlenecks as jbn
from ae_wavenet_tpu.training import chassis as jch
from ae_wavenet_tpu.training import torch_compat
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu_torch.cli import generate as tgen
from ae_wavenet_tpu_torch.cli import train as ttrain
from ae_wavenet_tpu_torch.data import dataset as tds
from ae_wavenet_tpu_torch.data.loader import device_batches
from ae_wavenet_tpu_torch.models import autoencoder as tae
from ae_wavenet_tpu_torch.models import bottlenecks as tbn
from ae_wavenet_tpu_torch.models import encoder as tenc
from ae_wavenet_tpu_torch.ops import gated
from ae_wavenet_tpu_torch.training import chassis as tch
from ae_wavenet_tpu_torch.training import checkpoint as tckpt
from ae_wavenet_tpu_torch.training import weights
from ae_wavenet_tpu_torch.utils import config as tcfg


@pytest.fixture(scope="module")
def data_prefix(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("data") / "synth")
    tds.make_synthetic_dataset(prefix, n_clips=8, n_speakers=4,
                               clip_len=(9000, 14000), seed=0)
    return prefix


def _port_cfg(cfg):
    return tcfg.from_json(jcfg.to_json(cfg))


# ------------------------------------------------------------ precision

def test_cli_setup_turns_tf32_off(data_prefix):
    """Both CLIs set the reference's f32 numerics before anything else."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    with pytest.raises(SystemExit):
        tgen.main(["--help"])
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    ttrain.setup(["new", "--preset", "tiny", "--data", data_prefix, "--device", "cpu"])
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_train_cli_new_then_resume_through_fused_stack(data_prefix, tmp_path, capsys):
    """The train CLI at the tiny preset with the fused stack in bf16 at an
    odd depth (pairs and a lone layer): every plain kernel runs for the CPU
    tensors, and resume continues the step count from the checkpoint."""
    common = ["--data", data_prefix, "--ckpt-dir", str(tmp_path), "--device", "cpu",
              "--log-every", "1"]
    plain = [gated.gated_pair_fused_reference, gated.gated_layer_fused_reference,
             gated.gated_pair_bwd_reference, gated.gated_layer_bwd_reference]
    before = [f.launches for f in plain]
    assert ttrain.main(["new", "--preset", "tiny", "--pallas-stack", "--compute-dtype",
                        "bfloat16", "--n-block-layers", "5", "--n-steps", "3",
                        *common]) == 0
    assert ttrain.main(["resume", "--n-steps", "2", *common]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"step"')]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["recon_ce"]) and np.isfinite(r["grad_norm"]) for r in recs)
    assert all(f.launches > n for f, n in zip(plain, before))


@pytest.mark.parametrize("flag", [["--gated-full-fusion"], ["--gated-bwd-group", "3"],
                                  ["--vq-use-pallas"], ["--ckpt-keep", "3"]])
def test_cli_refuses_unported_kernels(data_prefix, flag, tmp_path, capsys):
    """Every flag this test once saw refused is ported since: it reaches the
    config, and the two schedule flags and retention run."""
    argv = ["new", "--preset", "chorowski", "--pallas-stack", "--data", data_prefix,
            "--device", "cpu", *flag]
    cfg = ttrain.setup(argv)[1]
    if flag == ["--vq-use-pallas"]:
        assert cfg.bottleneck.vq_use_pallas is True
        return
    assert (cfg.wavenet.gated_full_fusion, cfg.wavenet.gated_bwd_group,
            cfg.train.ckpt_keep) == (flag[0] == "--gated-full-fusion",
                                     3 if flag[0] == "--gated-bwd-group" else 0,
                                     3 if flag[0] == "--ckpt-keep" else 0)
    common = ["--data", data_prefix, "--ckpt-dir", str(tmp_path), "--device", "cpu",
              "--log-every", "1"]
    if flag[0] == "--ckpt-keep":  # retention: the newest N and LATEST's stay
        assert ttrain.main(["new", "--preset", "tiny", "--n-steps", "8",
                            "--ckpt-every", "1", *flag, *common]) == 0
        assert tckpt.complete_steps(str(tmp_path)) == {6, 7, 8}
        assert tckpt.latest_step(str(tmp_path)) == 8
        return
    plain = {"--gated-full-fusion": gated.gated_stack_fused_reference,
             "--gated-bwd-group": gated.gated_group_bwd_reference}[flag[0]]
    before = plain.launches
    assert ttrain.main(["new", "--preset", "tiny", "--pallas-stack", "--compute-dtype",
                        "bfloat16", "--n-block-layers", "5", "--gated-full-fusion",
                        "--gated-bwd-group", "3", "--n-steps", "3", *common]) == 0
    assert ttrain.main(["resume", "--n-steps", "2", *common]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"step"')]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["recon_ce"]) for r in recs)
    assert plain.launches == before + 5  # 5 layers: one group of 3 and a pair


@pytest.mark.parametrize("flags,match", [
    (["--gated-bwd-group", "3", "--no-gated-save-y"], "gated_bwd_group=3.*gated_save_y"),
    (["--gated-full-fusion", "--n-blocks", "1", "--n-block-layers", "1"],
     "gated_full_fusion.*two or more layers"),
])
def test_cli_raises_on_a_schedule_that_does_not_apply(data_prefix, flags, match):
    """The reference warns and falls back to the pair or per-layer schedule
    (``gated_pallas.py:1350-1361``); the port raises, naming both flags."""
    with pytest.raises(ValueError, match=match):
        ttrain.setup(["new", "--preset", "chorowski", "--pallas-stack", "--data",
                      data_prefix, "--device", "cpu", *flags])


def test_library_entry_points_default_to_the_card(data_prefix, monkeypatch):
    """``Chassis(cfg, data)`` and ``autoencoder.init(cfg)`` with no device run
    on the card, and say so clearly when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg(jcfg.tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tch.Chassis(cfg, data_prefix, log_stream=io.StringIO())
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tae.init(cfg)
    model = tae.init(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_train_cli_with_the_fused_vq_lookup(data_prefix, tmp_path, capsys):
    """``--vq-use-pallas`` on the CPU: the fused lookup's plain version runs
    once per step (and its kernel never), and the first step's loss equals
    the same-seed run without the flag within 1e-4."""
    from ae_wavenet_tpu_torch.ops import vq_cuda

    def run(name, *flags):
        argv = ["new", "--preset", "tiny", "--bottleneck", "vq", "--vq-k", "32",
                "--n-steps", "3", "--log-every", "1", "--data", data_prefix,
                "--ckpt-dir", str(tmp_path / name), "--device", "cpu", *flags]
        assert ttrain.main(argv) == 0
        return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"step"')]

    before = (vq_cuda.vq_lookup_reference.launches, vq_cuda.vq_lookup_fused.launches)
    fused = run("fused", "--vq-use-pallas")
    assert vq_cuda.vq_lookup_reference.launches == before[0] + 3
    assert vq_cuda.vq_lookup_fused.launches == before[1]
    plain = run("plain")
    assert vq_cuda.vq_lookup_reference.launches == before[0] + 3
    assert [r["step"] for r in fused] == [1, 2, 3]
    assert abs(fused[0]["loss"] - plain[0]["loss"]) < 1e-4
    assert all(np.isfinite(r["recon_ce"]) and np.isfinite(r["perplexity"])
               for r in fused)
    cfg = tckpt.load_config(str(tmp_path / "fused"), 3)[1]
    assert cfg.bottleneck.vq_use_pallas is True


# ------------------------------------------------- bottleneck training

def _jax_draws(cfg, rng, z_shape):
    """The draws the JAX bottleneck takes from ``rng``."""
    b, d, t = z_shape
    if cfg.kind == "vae":
        return {"eps": torch.tensor(np.asarray(
            jax.random.normal(rng, (b, d, t), jnp.float32)))}
    if cfg.kind != "vq":
        return {}
    g = max(1, cfg.vq_groups)
    return {"jitter_u": torch.from_numpy(np.asarray(jax.random.uniform(rng, (b, 1, t)))),
            "restart_idx": torch.from_numpy(np.asarray(jax.random.randint(
                jax.random.fold_in(rng, 1), (g, cfg.vq_k), 0, b * t))).long()}


BN_CASES = {
    # restart threshold above the decayed count of every unused code
    "vq": jcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=32, vq_restart_thresh=0.995,
                                vq_warmup_steps=10),
    "vq_g2": jcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=32, vq_groups=2,
                                   vq_restart_thresh=0.995),
    "vae": jcfg.BottleneckConfig(kind="vae", n_dim=16, free_nats=0.05,
                                 kl_anneal_steps=10),
}


@pytest.mark.parametrize("name", sorted(BN_CASES))
def test_bottleneck_training_halves_match(name):
    """EMA state, restarts, perplexity, commitment, jitter, the VAE draw and
    KL terms within 1e-5, with JAX's own draws fed to the port."""
    cfg = BN_CASES[name]
    params, state = jbn.init(jax.random.PRNGKey(1), cfg)
    z = (np.random.default_rng(2).normal(size=(2, 16, 40)) * 0.5).astype(np.float32)
    rng, step = jax.random.PRNGKey(3), 4
    zq_j, state_j, aux_j = jax.jit(jbn.apply, static_argnums=(2, 6))(
        params, state, cfg, jnp.asarray(z), rng, jnp.int32(step), True)
    port = tbn.make(_port_cfg(jcfg.RunConfig(bottleneck=cfg)).bottleneck)
    named = {**{k: v for k, v in params.items()}, **{k: v for k, v in state.items()}}
    port.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in named.items()})
    zq_t, aux_t = port.train_apply(torch.from_numpy(z), step, True,
                                   draws=_jax_draws(cfg, rng, z.shape))
    np.testing.assert_allclose(zq_t.detach().numpy(), np.asarray(zq_j), atol=1e-5)
    for k, v in state_j.items():
        np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    if cfg.kind == "vq":
        assert float(aux_t["restarts"]) == float(aux_j["restarts"]) > 0
        np.testing.assert_allclose(aux_t.pop("zq_pre_jitter").numpy(),
                                   np.asarray(aux_j.pop("zq_pre_jitter")), atol=1e-5)
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


# --------------------------------------------------------------- the loss

def _tiny(kind):
    base = jcfg.tiny_config()
    bn = {"ae": jcfg.BottleneckConfig(kind="ae", n_dim=16),
          "vq": jcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=64),
          "vae": jcfg.BottleneckConfig(kind="vae", n_dim=16, free_nats=0.1,
                                       kl_anneal_steps=10)}[kind]
    return dataclasses.replace(base, bottleneck=bn, train=dataclasses.replace(
        base.train, aux_frame_weight=0.0 if kind == "ae" else 1.0))


def _loss_both(cfg, data_prefix, step=3, grads=False):
    """JAX loss_fn (and its grads) and the port's on the same batch, with
    JAX's draws fed to the port."""
    params, bn = jae.init(jax.random.PRNGKey(0), cfg)
    spec = jae.make_window_spec(cfg)
    wav, spk = jds.WindowSampler(jds.PackedDataset(data_prefix), spec.u_len,
                                 cfg.train.batch_sz, 0).batch_at(0)
    rng = jax.random.PRNGKey(9)
    f = functools.partial(jae.loss_fn, cfg=cfg, spec=spec, wav_i16=jnp.asarray(wav),
                          spk=jnp.asarray(spk), rng=rng, step=jnp.int32(step))
    if grads:
        (total_j, (_, m_j)), g_j = jax.jit(jax.value_and_grad(
            lambda p, b: f(p, b), has_aux=True))(params, bn)
    else:
        total_j, (_, m_j) = jax.jit(lambda p, b: f(p, b))(params, bn)
        g_j = None
    pcfg = _port_cfg(cfg)
    model = weights.from_named(torch_compat.flatten_named(
        {"params": params, "bn_state": bn}), pcfg)
    draws = _jax_draws(cfg.bottleneck, jax.random.split(rng)[1],
                       (cfg.train.batch_sz, cfg.bottleneck.n_dim,
                        _latent_len(pcfg)))
    total_t, m_t = tae.loss_fn(model, pcfg, tae.make_window_spec(pcfg),
                               torch.from_numpy(wav), torch.from_numpy(spk).long(),
                               step, True, draws=draws)
    return total_j, m_j, g_j, total_t, m_t, model


def _latent_len(cfg):
    return tenc.geometry(cfg.encoder).out_len(tae.make_window_spec(cfg).n_frames)


@pytest.mark.parametrize("kind", ["ae", "vq", "vae"])
def test_loss_fn_matches_jax_f32(kind, data_prefix):
    total_j, m_j, _, total_t, m_t, _ = _loss_both(_tiny(kind), data_prefix)
    assert abs(float(m_t["recon_ce"]) - float(m_j["recon_ce"])) < 1e-4
    assert abs(float(total_t) - float(total_j)) < 1e-3
    assert set(m_t) == set(m_j)


def test_bf16_slice_through_fused_stack_matches_jax(data_prefix):
    """The whole slice in bf16 with use_pallas_stack at a 128-wide decoder:
    the port's loss and gradients (fused schedule, plain kernels) against
    JAX's (its XLA stack on the CPU)."""
    base = _tiny("vq")
    cfg = dataclasses.replace(
        base,
        bottleneck=jcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=64,
                                         vq_restart_thresh=0.995),
        wavenet=jcfg.WaveNetConfig(n_blocks=1, n_block_layers=5, n_res=128,
                                   n_dil=128, n_skp=128, n_post=128, n_lc_in=16,
                                   n_lc_out=64, n_speakers=10, n_global_embed=16,
                                   use_pallas_stack=True),
        train=dataclasses.replace(base.train, compute_dtype="bfloat16"))
    total_j, m_j, g_j, total_t, m_t, model = _loss_both(cfg, data_prefix, grads=True)
    assert abs(float(m_t["recon_ce"]) - float(m_j["recon_ce"])) < 1e-2
    total_t.backward()
    ref = torch_compat.flatten_named({"params": g_j})
    mine = {"params." + k: p.grad.numpy() for k, p in model.named_parameters()
            if p.grad is not None}
    assert set(mine) <= set(ref)
    keys = sorted(ref)
    fr = np.concatenate([np.ravel(ref[k]) for k in keys])
    fm = np.concatenate([np.ravel(mine[k]) if k in mine else np.zeros(ref[k].size)
                         for k in keys])
    assert np.isfinite(fm).all()
    assert np.abs(fm - fr).max() / np.abs(fr).max() < 0.05


# ---------------------------------------------------------- the optimizer

OPT_CASES = {"adam": {}, "clip": {"grad_clip": 0.5}, "adamw": {"weight_decay": 0.1},
             "boundary": {"lr_boundaries": (1,), "lr_values": (1e-3, 3e-4),
                          "grad_clip": 0.5, "weight_decay": 0.1}}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_adam_steps_match_optax(name):
    """Three steps on the same grads: parameters within 1e-6 after each, and
    the state under optax's names with optax's values."""
    cfg = jcfg.RunConfig(train=dataclasses.replace(jcfg.TrainConfig(learning_rate=2e-3),
                                                   **OPT_CASES[name]))
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    opt = jch.make_optimizer(cfg)
    pj = jax.tree.map(jnp.asarray, p0)
    sj = opt.init(pj)
    pt = {"a": torch.tensor(p0["a"]), "b.c": torch.tensor(p0["b"]["c"])}
    adam = tch.Adam(pt.items(), _port_cfg(cfg).train)
    for _ in range(3):
        g = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
        u, sj = opt.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = jax.tree.map(lambda p, d: p + d, pj, u)
        adam.step({"a": torch.tensor(g["a"]), "b.c": torch.tensor(g["b"]["c"])})
        np.testing.assert_allclose(pt["a"].numpy(), np.asarray(pj["a"]), atol=1e-6)
        np.testing.assert_allclose(pt["b.c"].numpy(), np.asarray(pj["b"]["c"]), atol=1e-6)
    want = torch_compat.flatten_named({"opt_state": sj})
    got = adam.named_state()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# ------------------------------------------------------- data and resume

def test_window_sampler_matches_reference(data_prefix):
    ref = jds.WindowSampler(jds.PackedDataset(data_prefix), 4000, 3, seed=7,
                            clip_indices=[0, 2, 3, 5, 7])
    port = tds.WindowSampler(tds.PackedDataset(data_prefix), 4000, 3, seed=7,
                             clip_indices=[0, 2, 3, 5, 7])
    for step in (0, 1, 17, 1 << 30):
        (wr, kr), (wp, kp) = ref.batch_at(step), port.batch_at(step)
        np.testing.assert_array_equal(wp, wr)
        np.testing.assert_array_equal(kp, kr)
        assert wp.dtype == np.int16


def test_loader_blocks_ragged_tail_and_early_stop(data_prefix):
    s = tds.WindowSampler(tds.PackedDataset(data_prefix), 4000, 2, seed=1)
    with pytest.raises(ValueError, match="multiple"):
        next(device_batches(s, 0, 5, "cpu", block=2))
    got = []
    for step, (wav, spk) in device_batches(s, 4, 6, "cpu", block=2):
        got.append(step)
        assert tuple(wav.shape) == (2, 2, 4000) and spk.dtype == torch.int64
        np.testing.assert_array_equal(wav[1].numpy(), s.batch_at(step + 1)[0])
        break  # an early stop must not hang the producer
    assert got == [4]


def _tiny_run(**train):
    cfg = jcfg.tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def test_resume_reproduces_the_stream(data_prefix, tmp_path):
    """As tests/test_train_e2e.py:59: 4 steps, save, 4 more; a fresh chassis
    resumed from the save runs the same 4 steps."""
    cfg = _port_cfg(_tiny_run(n_steps=8, log_every=1))
    a = tch.Chassis(cfg, data_prefix, ckpt_dir=str(tmp_path), device="cpu",
                    log_stream=io.StringIO())
    a.train(4)
    a.save()
    hist_a = a.train(4)
    b = tch.Chassis(cfg, data_prefix, ckpt_dir=str(tmp_path), device="cpu",
                    log_stream=io.StringIO())
    assert b.resume(4) == 4
    hist_b = b.train(4)
    np.testing.assert_allclose([h["recon_ce"] for h in hist_b],
                               [h["recon_ce"] for h in hist_a], rtol=1e-5, atol=1e-6)


def test_chassis_holdout_ckpt_every_and_sigterm(data_prefix, tmp_path):
    """Holdout split and evaluate(), a save at every ckpt_every, and a
    SIGTERM during training that saves, stops and resumes."""
    cfg = _port_cfg(_tiny_run(n_steps=500, log_every=1, ckpt_every=2,
                              holdout_every=4))
    ch = tch.Chassis(cfg, data_prefix, ckpt_dir=str(tmp_path), device="cpu",
                    log_stream=io.StringIO())
    assert set(ch.sampler.eligible) <= {1, 2, 3, 5, 6, 7}
    ch.train(4)
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002.pt",
                                            "step_00000004.pt"]
    ev = ch.evaluate(n_batches=2)
    assert ev["split"] == "holdout" and np.isfinite(ev["recon_ce"])
    draw = ch.sampler.batch_at

    def batch_at(step):  # the signal arrives while step 6 is being staged
        if step == 6:
            os.kill(os.getpid(), signal.SIGTERM)
        return draw(step)

    ch.sampler.batch_at = batch_at
    log = io.StringIO()
    ch.logger.stream = log
    ch.train(496)
    assert ch.preempted and 4 < ch.step < 500
    assert "preempted_at" in log.getvalue()
    again = tch.Chassis(cfg, data_prefix, ckpt_dir=str(tmp_path), device="cpu",
                        log_stream=io.StringIO())
    assert again.resume() == ch.step


def test_jax_checkpoint_resumes_in_port_and_back(data_prefix, tmp_path):
    """A JAX run exported with ``export_torch`` (optimizer state included)
    resumes in the port and continues JAX's loss stream; the port's save
    imports into the JAX package."""
    cfg = _tiny_run(n_steps=5, log_every=1, grad_clip=1.0)
    ja = jch.Chassis(cfg, data_prefix, log_stream=io.StringIO())
    ja.train(3)
    tree = {"params": ja.params, "opt_state": ja.opt_state, "bn_state": ja.bn_state}
    torch_compat.export_torch(tckpt.checkpoint_path(str(tmp_path), 3), 3, tree, cfg)
    want = [h["recon_ce"] for h in ja.train(2)]
    ja.close()
    port = tch.Chassis(_port_cfg(cfg), data_prefix, ckpt_dir=str(tmp_path),
                       device="cpu", log_stream=io.StringIO())
    assert port.resume() == 3 and port.opt.count == 3
    got = [h["recon_ce"] for h in port.train(2)]
    np.testing.assert_allclose(got, want, atol=1e-3)
    path = port.save()
    step, back, _ = torch_compat.import_torch(path, tree)
    assert step == 5
    np.testing.assert_allclose(
        np.asarray(back["opt_state"][1][0].count), port.opt.count)
    for k, v in torch_compat.flatten_named({"params": back["params"]}).items():
        np.testing.assert_array_equal(
            v, port.model.state_dict()[k.removeprefix("params.")].numpy())
