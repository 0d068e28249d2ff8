"""The MFCC inverter (``models/mfcc_inverter.py``) and the model registry
against the JAX package, on the CPU.

Parameters come from the JAX init and cross by their dotted names; windows
come from the reference's v2 fixture (``data/preprocess``, the same bytes
in both packages).  Tolerances: the window spec and ``c_off`` equal;
encode's cond within 1e-5 of its largest value; recon CE of the f32 path
within 1e-4 (``tests/test_parity_torch.py:118-140``); the bf16 fused
stack's logits
within 0.02 of JAX's bf16 stack (``tests/test_gated_pallas.py:48``) and
its gradients at an RMS distance to JAX's f32 gradients under 3x JAX's
own bf16 distance (``:100``); temperature-0 reconstruction: ids equal
over each row's inclusive greedy prefix, logits there within 0.05 of max
|logits| (``tests_tpu/test_pallas_tpu.py:236``).
"""

import dataclasses
import functools
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ae_wavenet_tpu.models import common as jcommon
from ae_wavenet_tpu.models import mfcc_inverter as jmi
from ae_wavenet_tpu.models import registry as jreg
from ae_wavenet_tpu.ops import fastgen as jfg
from ae_wavenet_tpu.ops import fastgen_pallas as jfp
from ae_wavenet_tpu.training import torch_compat
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu.utils.wavio import read_wav
from ae_wavenet_tpu_torch.cli import eval as teval
from ae_wavenet_tpu_torch.cli import generate as tgen
from ae_wavenet_tpu_torch.cli import train as ttrain
from ae_wavenet_tpu_torch.data import dataset as tds
from ae_wavenet_tpu_torch.data import preprocess as tpre
from ae_wavenet_tpu_torch.eval.quality import QUALITY_KEYS
from ae_wavenet_tpu_torch.models import autoencoder as tae
from ae_wavenet_tpu_torch.models import common as tcommon
from ae_wavenet_tpu_torch.models import mfcc_inverter as tmi
from ae_wavenet_tpu_torch.models import registry as treg
from ae_wavenet_tpu_torch.ops import fastgen as tfg
from ae_wavenet_tpu_torch.ops import fastgen_cuda as tfc
from ae_wavenet_tpu_torch.training import chassis as tch
from ae_wavenet_tpu_torch.training import checkpoint as tckpt
from ae_wavenet_tpu_torch.training import weights
from ae_wavenet_tpu_torch.utils import config as tcfg

STRIDES, FILTERS = (5, 4, 4, 2), (10, 8, 8, 4)


@pytest.fixture(scope="module")
def data_prefix(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("inv") / "synth")
    tpre.make_synthetic_dataset(prefix, n_clips=6, n_speakers=4,
                                clip_len=(9000, 14000), seed=0)
    return prefix


def _inverter(cfg):
    return dataclasses.replace(
        cfg, model_kind="mfcc_inverter",
        wavenet=dataclasses.replace(cfg.wavenet, lc_upsample_strides=STRIDES,
                                    lc_upsample_filters=FILTERS))


def _tiny():
    return _inverter(jcfg.tiny_config())


def _wide_bf16():
    """A 128-wide decoder with the fused stack in bf16 (an odd depth)."""
    base = jcfg.tiny_config()
    return _inverter(dataclasses.replace(
        base,
        wavenet=jcfg.WaveNetConfig(n_blocks=1, n_block_layers=5, n_res=128, n_dil=128,
                                   n_skp=128, n_post=128, n_lc_out=64, n_speakers=10,
                                   n_global_embed=16, use_pallas_stack=True),
        train=dataclasses.replace(base.train, compute_dtype="bfloat16")))


def _port_cfg(cfg):
    return tcfg.from_json(jcfg.to_json(cfg))


def _models(cfg, seed=1, bias=0.0):
    """JAX params and the port's model holding them (biases perturbed by
    ``bias``, so a dropped bias shows)."""
    params, bn = jmi.init(jax.random.PRNGKey(seed), cfg)
    if bias:
        rng = np.random.default_rng(seed)
        for layer in params["wavenet"]["layers"]:
            for tap in layer.values():
                tap["b"] = jnp.asarray(rng.normal(size=tap["b"].shape) * bias,
                                       jnp.float32)
    assert bn == {}
    named = torch_compat.flatten_named({"params": params})
    return params, weights.from_named(named, _port_cfg(cfg))


def _batch(cfg, data_prefix, step=0):
    spec = jmi.make_window_spec(cfg)
    ds = tds.PackedDataset(data_prefix)
    return tds.WindowSampler(ds, spec.u_len, cfg.train.batch_sz, 0).batch_at(step)


@pytest.mark.parametrize("preset,n_win", [("tiny", None), ("chorowski", None),
                                          ("chorowski", 8000), ("chorowski", 48000)])
def test_window_spec_matches_jax(preset, n_win):
    """Every field of the window spec, the upsample plan's trims among them,
    and the conditioning chain's c_off."""
    cfg = _inverter(jcfg.PRESETS[preset]())
    want, got = jmi.make_window_spec(cfg, n_win), tmi.make_window_spec(_port_cfg(cfg),
                                                                      n_win)
    for f in dataclasses.fields(want):
        if f.name == "up_steps":
            assert len(got.up_steps) == len(want.up_steps) == len(STRIDES)
            for a, b in zip(got.up_steps, want.up_steps):
                assert (a.trim_l, a.keep, a.in_want.as_tuple(), a.out_want.as_tuple()) \
                    == (b.trim_l, b.keep, b.in_want.as_tuple(), b.out_want.as_tuple())
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.tgt_b == want.tgt_b
    from ae_wavenet_tpu.geometry.vconv import Range as JRange
    from ae_wavenet_tpu_torch.geometry.vconv import Range as TRange

    rj = jmi.cond_chain(cfg).in_range(JRange(0, 1))
    rt = tmi.cond_chain(_port_cfg(cfg)).in_range(TRange(0, 1))
    assert (rt.b, rt.e) == (rj.b, rj.e)


def test_encode_matches_jax(data_prefix):
    """Whole-utterance cond within 1e-5 of its largest value, the same
    c_off, and the frame statistics over the inverter's own n_frames (not
    the autoencoder's)."""
    cfg = _tiny()
    params, model = _models(cfg)
    ds = tds.PackedDataset(data_prefix)
    wav = np.stack([ds.clip(0, 9000), ds.clip(1, 9000)])
    cond_j, off_j = jax.jit(jmi.encode, static_argnums=(2, 4))(
        params, {}, cfg, jnp.asarray(wav), None)
    pcfg = _port_cfg(cfg)
    cond_t, off_t = tmi.encode(model, pcfg, torch.from_numpy(wav))
    assert off_t == off_j
    assert tuple(cond_t.shape) == cond_j.shape
    # f32 MFCCs of either package differ by ~7e-7 of their scale, which
    # the normalization and the upsampler carry into cond
    cond_j = np.asarray(cond_j)
    assert np.abs(cond_t.numpy() - cond_j).max() < 1e-5 * np.abs(cond_j).max()
    ae_cfg = _port_cfg(jcfg.tiny_config())
    assert tmi.make_window_spec(pcfg).n_frames != tae.make_window_spec(ae_cfg).n_frames


@pytest.mark.parametrize("norm", ["window", "dataset"])
def test_recon_ce_f32_matches_jax(data_prefix, norm):
    """The f32 loss on the same parameters and windows, under both frame
    normalizations (the dataset statistics from the reference's function)."""
    from ae_wavenet_tpu.data.preprocess import dataset_frame_stats

    cfg = _tiny()
    if norm == "dataset":
        mean, var = dataset_frame_stats(data_prefix, cfg.spec)
        cfg = dataclasses.replace(cfg, spec=dataclasses.replace(
            cfg.spec, norm="dataset", stats_mean=mean, stats_var=var))
    params, model = _models(cfg)
    wav, spk = _batch(cfg, data_prefix)
    _, (_, m_j) = jax.jit(jmi.loss_fn, static_argnums=(2, 3))(
        params, {}, cfg, jmi.make_window_spec(cfg), jnp.asarray(wav),
        jnp.asarray(spk), jax.random.PRNGKey(9), jnp.int32(0))
    pcfg = _port_cfg(cfg)
    total, m_t = tmi.loss_fn(model, pcfg, tmi.make_window_spec(pcfg),
                             torch.from_numpy(wav), torch.from_numpy(spk).long(), 0)
    assert set(m_t) == set(m_j) == {"loss", "recon_ce"}
    assert abs(float(m_t["recon_ce"].detach()) - float(m_j["recon_ce"])) < 1e-4
    assert total is m_t["loss"]


@functools.lru_cache(maxsize=None)
def _bf16_case(data_prefix):
    """JAX's logits (bf16) and gradients (bf16 and f32) of the inverter's
    loss at the 128-wide config; the port's model holding its parameters."""
    cfg = _wide_bf16()
    params, model = _models(cfg, bias=0.3)
    wav, spk = _batch(cfg, data_prefix)
    spec = jmi.make_window_spec(cfg)
    args = (jnp.asarray(wav), jnp.asarray(spk), jax.random.PRNGKey(9), jnp.int32(0))
    logits_j = np.asarray(jax.jit(jmi.forward, static_argnums=(2, 3, 8))(
        params, {}, cfg, spec, *args, True)[0], np.float32)
    grads = {}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                               compute_dtype=dt))
        g = jax.jit(jax.grad(lambda p: jmi.loss_fn(p, {}, c, spec, *args)[0]))(params)
        grads[dt] = torch_compat.flatten_named({"params": g})
    return cfg, model, wav, spk, logits_j, grads


def test_bf16_fused_logits_match_jax(data_prefix):
    cfg, model, wav, spk, logits_j, _ = _bf16_case(data_prefix)
    pcfg = _port_cfg(cfg)
    with torch.no_grad():
        logits_t, _, _ = tmi.forward(model, pcfg, tmi.make_window_spec(pcfg),
                                     torch.from_numpy(wav), torch.from_numpy(spk).long())
    assert tuple(logits_t.shape) == logits_j.shape
    d = np.abs(logits_t.float().numpy() - logits_j).max()
    assert d < 0.02, d


def test_bf16_fused_grads_match_jax(data_prefix):
    cfg, model, wav, spk, _, grads = _bf16_case(data_prefix)
    pcfg = _port_cfg(cfg)
    model.zero_grad(set_to_none=True)
    total, _ = tmi.loss_fn(model, pcfg, tmi.make_window_spec(pcfg),
                           torch.from_numpy(wav), torch.from_numpy(spk).long())
    total.backward()
    mine = {"params." + k: p.grad.numpy() for k, p in model.named_parameters()
            if p.grad is not None}
    keys = sorted(grads["float32"])
    assert set(mine) <= set(keys)
    flat = lambda g: np.concatenate(  # noqa: E731
        [np.ravel(g[k]) if k in g else np.zeros(grads["float32"][k].size) for k in keys])
    fp, fx, f32 = flat(mine), flat(grads["bfloat16"]), flat(grads["float32"])
    assert np.isfinite(fp).all()
    rms = lambda a: float(np.sqrt(((a - f32) ** 2).mean()))  # noqa: E731
    assert rms(fp) < 3.0 * rms(fx) + 1e-8, (rms(fp), rms(fx))


def test_reconstruct_matches_jax_greedy(data_prefix):
    """Port reconstruct(temperature=0) against JAX's encode, prime and the
    Pallas sampler in interpret mode: the same start, ids equal over each
    row's inclusive greedy prefix, logits there within 0.05."""
    cfg = _tiny()
    params, model = _models(cfg, seed=2)
    pcfg = _port_cfg(cfg)
    ds = tds.PackedDataset(data_prefix)
    wav = np.stack([ds.clip(2, 8000), ds.clip(3, 8000)])
    spk = ds.speakers[2:4].astype(np.int32)
    n = 24
    prep = jcommon.prime_for_generation(jmi.encode, params, {}, cfg, jnp.asarray(wav),
                                        jnp.asarray(spk), jax.random.PRNGKey(0), n)
    cond_gc = jfg._with_gc(params["wavenet"], cfg.wavenet, prep.gen_cond,
                           jnp.asarray(spk))
    want_ids, _, _, want_lg = jfp.generate_fused(
        jfp.pack_for_pallas(params["wavenet"], cfg.wavenet), cfg.wavenet,
        jfp.state_to_flat(prep.state, cfg.wavenet), prep.state.prev_id, prep.state.t,
        cond_gc, jnp.int32(0), temperature=0.0, debug_logits=True, interpret=True)
    want_ids, want_lg = np.asarray(want_ids), np.asarray(want_lg)

    wav_t, spk_t = torch.from_numpy(wav), torch.from_numpy(spk).long()
    ids, start = tmi.reconstruct(model, pcfg, wav_t, spk_t, temperature=0.0, n_samples=n)
    assert start == prep.start
    assert tuple(ids.shape) == want_ids.shape == (2, n)
    tprep = tcommon.prime_for_generation(tmi.encode, model, pcfg, wav_t, spk_t, n)
    _, _, _, lg = tfc.generate_fused(
        tfc.pack_for_kernel(model.wavenet, pcfg.wavenet), pcfg.wavenet,
        tfc.state_to_flat(tprep.state, pcfg.wavenet), tprep.state.prev_id,
        tprep.state.t, tfg.with_gc(model.wavenet, pcfg.wavenet, tprep.gen_cond, spk_t),
        0, temperature=0.0, debug_logits=True)
    scale = np.abs(want_lg).max()
    agree = 0
    for r in range(2):
        diff = np.nonzero(ids[r].numpy() != want_ids[r])[0]
        t_div = int(diff[0]) if len(diff) else n
        agree += t_div
        hi = min(t_div + 1, n)
        rel = np.abs(lg[:hi, r].numpy() - want_lg[:hi, r]).max() / scale
        assert rel < 0.05, (r, t_div, rel)
    assert agree >= n


def test_weights_cross_by_dotted_names_both_ways(tmp_path):
    """JAX params -> the port (``params.wavenet.*`` only, no ``bn_state``)
    -> an export file -> the JAX package's import, every tensor equal."""
    cfg = _tiny()
    params, model = _models(cfg, seed=3)
    ref = torch_compat.flatten_named({"params": params})
    state = weights.export_state(model)
    assert set(state) == set(ref)
    assert all(k.startswith("params.wavenet.") for k in state)
    path = str(tmp_path / "inv.pt")
    weights.save_export(path, model, _port_cfg(cfg), 5)
    step, back, cfg_back = torch_compat.import_torch(path, {"params": params})
    assert step == 5 and jcfg.from_json(jcfg.to_json(cfg_back)) == cfg
    for k, v in torch_compat.flatten_named({"params": back["params"]}).items():
        np.testing.assert_array_equal(v, np.asarray(ref[k]))
    step, loaded, pcfg = weights.load_export(path)
    assert isinstance(loaded, tmi.MfccInverter) and pcfg.model_kind == "mfcc_inverter"
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref["params." + k]))


def test_chassis_trains_saves_resumes_and_vocodes(data_prefix, tmp_path, capsys):
    """``Chassis(..., device="cpu")`` on the inverter: 6 steps with falling
    loss, a save, ``resume`` in a new chassis, then the generate CLI and the
    eval CLI (with ``--quality``) on the checkpoint with ``--device cpu``."""
    cfg = dataclasses.replace(_port_cfg(_tiny()), train=dataclasses.replace(
        tcfg.tiny_config().train, learning_rate=2e-3, log_every=1))
    ckpt = str(tmp_path / "ckpt")
    ch = tch.Chassis(cfg, data_prefix, ckpt_dir=ckpt, device="cpu",
                     log_stream=io.StringIO())
    assert isinstance(ch.model, tmi.MfccInverter)
    hist = ch.train(6)
    loss = [h["loss"] for h in hist]
    assert all(np.isfinite(loss)) and set(hist[0]) >= {"loss", "recon_ce", "grad_norm"}
    assert loss[-1] < loss[0], loss
    path = ch.save()
    ch.close()
    again = tch.Chassis(cfg, data_prefix, ckpt_dir=ckpt, device="cpu",
                        log_stream=io.StringIO())
    assert again.resume() == 6
    for k, v in again.model.state_dict().items():
        torch.testing.assert_close(v, ch.model.state_dict()[k], rtol=0, atol=0)
    assert "eval_recon_ce" not in again.evaluate(n_batches=1)
    out = str(tmp_path / "out.wav")
    assert tgen.main(["--ckpt", path, "--data", data_prefix, "--clip", "1",
                      "--n-samples", "50", "--device", "cpu", "--out", out]) == 0
    assert "mfcc_inverter" in capsys.readouterr().out
    x, sr = read_wav(out)
    assert sr == 16000 and len(x) == 50
    assert teval.main(["--ckpt-dir", ckpt, "--data", data_prefix, "--n-batches", "1",
                       "--quality", "--quality-samples", "500", "--device", "cpu"]) == 0
    ev, q = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert ev["step"] == 6 and set(ev) >= {"eval_loss", "eval_recon_ce"}
    assert "eval_perplexity" not in ev
    assert q["n_scored"] == 500 and all(np.isfinite(q[k]) for k in QUALITY_KEYS)


def test_train_cli_new_and_resume_keep_the_inverter(data_prefix, tmp_path, capsys):
    """``new --model mfcc_inverter`` sets the (5, 4, 4, 2) upsampler;
    ``resume`` takes it from the checkpoint."""
    common = ["--data", data_prefix, "--ckpt-dir", str(tmp_path), "--device", "cpu",
              "--log-every", "1"]
    assert ttrain.main(["new", "--preset", "tiny", "--model", "mfcc_inverter",
                        "--n-steps", "2", *common]) == 0
    assert ttrain.main(["resume", "--n-steps", "1", *common]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"step"')]
    assert [r["step"] for r in recs] == [1, 2, 3]
    cfg = tckpt.load_config(str(tmp_path), 3)[1]
    assert cfg.model_kind == "mfcc_inverter"
    assert (cfg.wavenet.lc_upsample_strides, cfg.wavenet.lc_upsample_filters) == (
        STRIDES, FILTERS)


def test_registry_matches_jax_and_refuses_unknown_kinds():
    assert set(treg._REGISTRY) == set(jreg._REGISTRY)
    assert treg.get("mfcc_inverter") is tmi and treg.get("autoencoder") is tae
    for mod in treg._REGISTRY.values():
        for fn in ("init", "loss_fn", "make_window_spec", "encode", "reconstruct"):
            assert callable(getattr(mod, fn)), (mod.__name__, fn)
    with pytest.raises(ValueError, match=r"unknown model_kind 'vocoder'.*"
                                         r"\['autoencoder', 'mfcc_inverter'\]"):
        treg.get("vocoder")
