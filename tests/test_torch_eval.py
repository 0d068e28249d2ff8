"""The port's quality eval and its CLI against the JAX package, on the CPU.

``log_mel_frames``/``log_mel_distance`` against the reference's numpy
versions on the same arrays; ``free_running_report`` at temperature 0 (a
greedy rollout draws nothing, so both packages walk the same trajectory)
on the same weights, carried across by ``training/weights``, and the same
clip: every key of ``QUALITY_KEYS`` within 1e-3 relative; the eval CLI
after a tiny training run."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ae_wavenet_tpu.audio import mfcc as jmfcc
from ae_wavenet_tpu.eval import quality as jq
from ae_wavenet_tpu.models import autoencoder as jae
from ae_wavenet_tpu.training import torch_compat
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu_torch.audio import mfcc as tmfcc
from ae_wavenet_tpu_torch.cli import eval as teval
from ae_wavenet_tpu_torch.cli import train as ttrain
from ae_wavenet_tpu_torch.data import dataset as tds
from ae_wavenet_tpu_torch.eval import quality as tq
from ae_wavenet_tpu_torch.training import weights
from ae_wavenet_tpu_torch.utils import config as tcfg


def _wav(seed=0, batch=1, n=8000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (6000 * np.sin(2 * np.pi * 180 * t)[None]
            * (1 + 0.3 * rng.normal(size=(batch, 1)))
            + 800 * rng.normal(size=(batch, n))).astype(np.int16)


def test_log_mel_frames_and_distance_match_reference():
    spec = jcfg.tiny_config().spec
    pspec = tcfg.from_json(jcfg.to_json(jcfg.tiny_config())).spec
    x = (_wav(1, 2, 3000) / 32768.0).astype(np.float32)
    y = (_wav(2, 2, 2800) / 32768.0).astype(np.float32)
    want = jmfcc.log_mel_frames_np(x, spec)
    got = tmfcc.log_mel_frames(torch.from_numpy(x), pspec)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    d_want = jq.log_mel_distance(x, y, spec)
    d_got = tq.log_mel_distance(torch.from_numpy(x), y, pspec)
    assert abs(d_got - d_want) <= 1e-4 * d_want
    with pytest.raises(ValueError, match="samples"):
        tq.log_mel_distance(x[..., :10], y, pspec)


def _models(seed=0):
    base = jcfg.tiny_config()
    cfg = dataclasses.replace(
        base, bottleneck=jcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=64),
        train=dataclasses.replace(base.train, aux_frame_weight=1.0))
    params, bn = jae.init(jax.random.PRNGKey(seed), cfg)
    # informative predictive distributions: greedy ids with real margins
    params["wavenet"]["post2"]["w"] = params["wavenet"]["post2"]["w"] * 100.0
    pcfg = tcfg.from_json(jcfg.to_json(cfg))
    model = weights.from_named(
        torch_compat.flatten_named({"params": params, "bn_state": bn}), pcfg)
    return cfg, params, bn, pcfg, model


def test_free_running_report_matches_jax_greedy():
    cfg, params, bn, pcfg, model = _models()
    wav, spk = _wav(0, 2), np.array([1, 3], np.int32)
    n = 600
    want = jq.free_running_report(params, bn, cfg, jnp.asarray(wav), jnp.asarray(spk),
                                  jax.random.PRNGKey(0), n_samples=n,
                                  temperature=0.0, nll_buckets=4)
    got = tq.free_running_report(model, pcfg, torch.from_numpy(wav),
                                 torch.from_numpy(spk).long(), n_samples=n,
                                 temperature=0.0, nll_buckets=4)
    assert got["start"] == want["start"] and got["n_scored"] == want["n_scored"] == n
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))
    for k in tq.QUALITY_KEYS:
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (k, got[k], want[k])
    np.testing.assert_allclose(got["free_nll_curve"], want["free_nll_curve"], rtol=1e-3)
    assert tq.QUALITY_KEYS == jq.QUALITY_KEYS


def test_divergence_report_sweeps_from_one_primed_state():
    """Every temperature starts from the same primed queues (the eager
    sampler writes them in place, so the sweep rolls a copy): the greedy
    entry equals a stand-alone greedy report."""
    _, _, _, pcfg, model = _models(seed=1)
    wav, spk = torch.from_numpy(_wav(3)), torch.tensor([2])
    gen = torch.Generator().manual_seed(0)
    rep = tq.divergence_report(model, pcfg, wav, spk, gen, n_samples=500,
                               temperatures=(1.0, 0.0), nll_buckets=2)
    assert set(rep["temperatures"]) == {"1", "greedy"} and rep["n_scored"] == 500
    alone = tq.free_running_report(model, pcfg, wav, spk, n_samples=500,
                                   temperature=0.0, nll_buckets=2)
    for k, v in rep["temperatures"]["greedy"].items():
        assert v == alone[k], k
    assert rep["teacher_nll"] == alone["teacher_nll"]
    assert all(np.isfinite(v) for v in rep["temperatures"]["1"]["free_nll_curve"])


def test_eval_cli_after_a_tiny_training_run(tmp_path, capsys):
    """``cli/eval.py --device cpu --quality`` on a checkpoint the train CLI
    wrote: two JSON records with the reference's keys, every metric finite,
    and the same records appended to ``--json``."""
    data = str(tmp_path / "synth")
    tds.make_synthetic_dataset(data, n_clips=4, n_speakers=2, clip_len=(9000, 11000),
                               seed=0)
    ckpt = str(tmp_path / "ckpt")
    assert ttrain.main(["new", "--preset", "tiny", "--bottleneck", "vq", "--vq-k", "32",
                        "--data", data, "--ckpt-dir", ckpt, "--device", "cpu",
                        "--n-steps", "2"]) == 0
    capsys.readouterr()
    out = str(tmp_path / "records.jsonl")
    assert teval.main(["--ckpt-dir", ckpt, "--data", data, "--device", "cpu",
                       "--n-batches", "2", "--quality", "--quality-clips", "1",
                       "--quality-samples", "500", "--json", out]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert len(recs) == 2
    ev, q = recs
    assert {"step", "holdout", "n_batches", "eval_loss", "eval_recon_ce",
            "eval_bn_loss", "eval_commitment", "eval_perplexity"} <= set(ev)
    assert ev["step"] == 2 and ev["n_batches"] == 2 and ev["holdout"] is False
    assert list(q) == ["step", "clip", *tq.QUALITY_KEYS, "n_scored"]
    assert q["clip"] == 1 and q["n_scored"] == 500
    assert all(np.isfinite(v) for r in recs for v in r.values()
               if isinstance(v, float))
    with open(out) as f:
        assert [json.loads(ln) for ln in f] == recs
    with pytest.raises(SystemExit, match="no checkpoints"):
        teval.main(["--ckpt-dir", str(tmp_path / "none"), "--data", data,
                    "--device", "cpu"])
