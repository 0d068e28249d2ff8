"""The port's instruments (``ae_wavenet_tpu_torch/scripts``) against the JAX
package's ``scripts/``, at the tiny width on the CPU: the VQ cloud
statistics on the same weights and batch, ``eval_quality`` on one JAX
checkpoint exported to the port, each instrument's records against the
reference's records under ``docs/`` key for key, twins on identical
batches, and the record tables' text."""

import dataclasses
import hashlib
import io
import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ae_wavenet_tpu.audio.mfcc import mfcc_delta_stack as jmfcc_delta_stack
from ae_wavenet_tpu.audio.mulaw import int16_to_float as jint16_to_float
from ae_wavenet_tpu.models import encoder as jenc
from ae_wavenet_tpu.models.common import normalize_frames as jnormalize_frames
from ae_wavenet_tpu.training import torch_compat
from ae_wavenet_tpu.training.chassis import Chassis as JChassis
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu_torch.data import dataset as tds
from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
from ae_wavenet_tpu_torch.scripts import (compare_runs, diag_vae, diag_vq, eval_quality,
                                          gain_ab, gain_scaling, long_run,
                                          quality_quantized)
from ae_wavenet_tpu_torch.training import chassis as tchassis
from ae_wavenet_tpu_torch.training import checkpoint as tckpt
from ae_wavenet_tpu_torch.training import weights
from ae_wavenet_tpu_torch.utils import config as tcfg
from scripts import compare_runs as jcompare_runs
from scripts import diag_vq as jdiag_vq
from scripts import eval_quality as jeval_quality
from scripts import gain_scaling as jgain_scaling

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")
REL = 1e-4         # f32 statistics of one batch, summed in another order
TIE_REL_GAP = 1e-4  # a differing code must be this near a tie (of the row's largest d2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny widths gain nothing from more, and the
    suite's workers share the host's cores (oversubscribed, this file's
    steps ran two orders of magnitude slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _printed(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


# ------------------------------------------------- one JAX model, both sides

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, one_thread):
    """A JAX ``Chassis`` at the tiny width with a VQ bottleneck (every 5th
    clip held out) on the reference's fixture, its checkpoint at step 0, and
    the port's ``Chassis`` on the same config holding the same weights."""
    tmp = tmp_path_factory.mktemp("scripts_jax")
    prefix = str(tmp / "synth")
    make_synthetic_dataset(prefix, n_clips=8, n_speakers=4, clip_len=(14000, 20000),
                           seed=11)
    base = jcfg.tiny_config()
    cfg = dataclasses.replace(
        base, bottleneck=jcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=64),
        train=dataclasses.replace(base.train, aux_frame_weight=1.0, holdout_every=5))
    jch = JChassis(cfg, prefix, ckpt_dir=str(tmp / "jax_ckpt"), log_stream=io.StringIO())
    jch.save()
    pdir = tmp / "port_ckpt"
    pdir.mkdir()
    tree = {"params": jch.params, "opt_state": jch.opt_state, "bn_state": jch.bn_state}
    torch_compat.export_torch(tckpt.checkpoint_path(str(pdir), 0), 0, tree, cfg)
    tch = tchassis.Chassis(tcfg.from_json(jcfg.to_json(cfg)), prefix, device="cpu",
                           log_stream=io.StringIO())
    weights.load_into(tch.model, torch_compat.flatten_named(
        {"params": jch.params, "bn_state": jch.bn_state}))
    return {"jch": jch, "tch": tch, "prefix": prefix, "jdir": str(tmp / "jax_ckpt"),
            "pdir": str(pdir)}


def _jax_latents(jch, batch) -> np.ndarray:
    """The reference's ``cloud_stats`` latents (its first lines, verbatim)."""
    cfg, spec = jch.cfg, jch.spec
    wav = jint16_to_float(jnp.asarray(batch[0]))
    frames = jmfcc_delta_stack(wav[..., spec.fb : spec.fe], cfg.spec)
    frames = jnormalize_frames(frames, spec=cfg.spec)
    z = jenc.apply(jch.params["encoder"], cfg.encoder, frames)
    b, d, t = z.shape
    return np.asarray(jnp.reshape(jnp.transpose(z, (0, 2, 1)), (b * t, d)), np.float32)


def test_cloud_stats_match_jax(jax_run):
    """``diag_vq.cloud_stats`` on the same weights and ``batch_at(0)``: the
    frame statistics within REL, the codebook's exact, the nearest codes
    equal except near-ties on under 1% of frames."""
    jch, tch = jax_run["jch"], jax_run["tch"]
    batch = jch.sampler.batch_at(0)
    tbatch = tch.sampler.batch_at(0)
    np.testing.assert_array_equal(tbatch[0], batch[0])
    want = jdiag_vq.cloud_stats(jch, batch)
    got = diag_vq.cloud_stats(tch, tbatch)
    assert list(got) == list(want)
    assert got["n_frames"] == want["n_frames"]
    for k in ("frame_norm_mean", "cloud_rms_spread", "per_dim_std_mean",
              "nearest_d2_mean"):
        assert _rel(got[k], want[k]) < REL, (k, got[k], want[k])
    for k in ("codebook_rms_spread", "ema_counts_max", "ema_counts_gt_thresh"):
        assert got[k] == want[k], k
    e = np.asarray(jch.bn_state["codebook"], np.float32)
    _, codes_j = diag_vq.nearest(_jax_latents(jch, batch), e)
    d2, codes_t = diag_vq.nearest(diag_vq.latents(tch, tbatch), e)
    differ = np.nonzero(codes_t != codes_j)[0]
    assert len(differ) < 0.01 * len(codes_t), len(differ)
    for r in differ:
        gap = abs(d2[r, codes_t[r]] - d2[r, codes_j[r]])
        assert gap <= TIE_REL_GAP * d2[r].max(), (r, gap)
    if len(differ) == 0:
        assert (got["batch_perplexity"], got["batch_codes_used"]) == \
            (want["batch_perplexity"], want["batch_codes_used"])


def _keys(rec, prefix=""):
    """Every key of a record, nested keys as 'outer.inner'."""
    out = set()
    for k, v in rec.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("divergence", [False, True], ids=["report", "divergence"])
def test_eval_quality_matches_jax_on_an_exported_checkpoint(jax_run, capsys,
                                                            divergence):
    """The JAX script on its checkpoint and the port's on the same weights
    exported with ``torch_compat.export_torch``: the same records, key for
    key; ``teacher_nll`` and ``spectral_l2_vs_silence`` within REL."""
    common = ["--data", jax_run["prefix"], "--clips", "0,5", "--n-samples", "400",
              "--max-input", "12000"]
    if divergence:
        common += ["--divergence", "--temperatures", "0.0", "--nll-buckets", "4"]
    capsys.readouterr()
    assert jeval_quality.main(["--ckpt-dir", jax_run["jdir"], *common]) == 0
    want = _printed(capsys.readouterr().out)
    assert eval_quality.main(["--ckpt-dir", jax_run["pdir"], *common,
                              "--device", "cpu"]) == 0
    got = _printed(capsys.readouterr().out)
    assert [_keys(r) for r in got] == [_keys(r) for r in want]
    for g, w in zip(got[:-1], want[:-1]):
        assert (g["step"], g["clip"]) == (w["step"], w["clip"])
        g, w = (g["divergence"], w["divergence"]) if divergence else (g, w)
        assert g["n_scored"] == w["n_scored"] == 400
        for k in ("teacher_nll", "spectral_l2_vs_silence"):
            assert _rel(g[k], w[k]) < REL, (k, g[k], w[k])
    assert got[-1]["summary"]["clips"] == 2


# ------------------------------------- each instrument's records, key for key

def _kind(rec: dict) -> str:
    """The kind of a record, as the reference's records under docs/ have it."""
    for key in ("run_config", "quality_holdout", "eval_split", "samples_per_sec",
                "done", "summary", "gain_ab", "quality_quantized", "mode"):
        if key in rec:
            return key
    return rec.get("kind", "?")


def _held_to(got: list[dict], reference: str) -> None:
    """Every kind of record in the reference's file is in ``got``, and each
    of got's records of that kind has every key (nested too) that the
    reference's records of that kind have."""
    want: dict = {}
    for r in _records(os.path.join(DOCS, reference)):
        want.setdefault(_kind(r), set()).update(_keys(r))
    have: dict = {}
    for r in got:
        have.setdefault(_kind(r), []).append(_keys(r))
    assert set(want) <= set(have), (sorted(want), sorted(have))
    for kind, keys in want.items():
        for k in have[kind]:
            assert keys <= k, (kind, sorted(keys - k))


@pytest.fixture(scope="module")
def tiny_long_run(tmp_path_factory, one_thread):
    """``long_run --tiny`` for 16 steps: an eval, a save and a probe every 8."""
    work = str(tmp_path_factory.mktemp("long_run"))
    out = os.path.join(work, "run.jsonl")
    assert long_run.main(["--tiny", "--device", "cpu", "--workdir", work, "--out", out,
                          "--steps", "16", "--eval-every", "8", "--ckpt-every", "8",
                          "--log-every", "4", "--quality-every", "8",
                          "--quality-samples", "400"]) == 0
    return work, _records(out)


def test_long_run_records_match_the_reference(tiny_long_run):
    work, recs = tiny_long_run
    _held_to(recs, "long_run_r5_vqg1_1024.jsonl")
    assert [r["step"] for r in recs if "quality_holdout" in r] == [8, 16]
    assert [r["step"] for r in recs if "eval_split" in r] == [8, 16]
    assert recs[-1] == {**recs[-1], "step": 16, "done": True, "preempted": False}
    assert recs[-1]["median_samples_per_sec"] > 0
    assert all(r["probe_s"] >= 0 for r in recs if "quality_holdout" in r)
    assert tckpt.best_info(os.path.join(work, "ckpt"))[0] in (8, 16)
    for r in recs:
        for v in (r.get("quality_holdout") or r).values():
            assert not isinstance(v, float) or np.isfinite(v), r


def test_long_run_resume_on_other_data_raises(tiny_long_run):
    work, _ = tiny_long_run
    with pytest.raises(SystemExit, match="data mismatch"):
        long_run.main(["--tiny", "--device", "cpu", "--workdir", work, "--resume",
                       "--fixture", "v3", "--steps", "24"])


def test_long_run_checks_quality_every_before_training(tmp_path):
    with pytest.raises(SystemExit, match="multiples of --steps-per-call"):
        long_run.main(["--tiny", "--device", "cpu", "--workdir", str(tmp_path),
                       "--steps", "16", "--quality-every", "6"])
    assert not os.path.exists(os.path.join(tmp_path, "ckpt"))


def test_quality_quantized_records_match_the_reference(tiny_long_run, capsys):
    work, _ = tiny_long_run
    out = os.path.join(work, "qq.jsonl")
    assert quality_quantized.main([
        "--ckpt-dir", os.path.join(work, "ckpt"), "--step", "best",
        "--data", os.path.join(work, "synth32"), "--clips", "0", "--n-samples", "400",
        "--json", out, "--device", "cpu"]) == 0
    recs = _records(out)
    assert _printed(capsys.readouterr().out) == recs
    _held_to(recs, "quality_quantized_r5.jsonl")
    assert [r["mode"] for r in recs if "mode" in r] == ["bf16", "int8", "int4"]
    assert all(np.isfinite(r["spectral_l2"]) for r in recs if "mode" in r)


def test_diag_vae_records_match_the_reference(tmp_path):
    out = str(tmp_path / "vae.jsonl")
    assert diag_vae.main(["--preset", "tiny", "--steps", "20", "--device", "cpu",
                          "--workdir", str(tmp_path), "--json", out]) == 0
    recs = _records(out)
    _held_to(recs, "vae_run_r4.jsonl")
    assert [r.get("kind") for r in recs] == ["vae", "zero", "ae", None]
    assert len(recs[0]["kl_trend"]) == len(recs[0]["active_trend"]) == 2


def test_gain_ab_records_match_the_reference(tmp_path):
    out = str(tmp_path / "gain.jsonl")
    assert gain_ab.main(["--tiny", "--steps", "8", "--device", "cpu", "--workdir",
                         str(tmp_path), "--out", out, "--eval-batches", "2"]) == 0
    recs = _records(out)
    _held_to(recs, "gain_v3_r5.jsonl")
    s = recs[-1]["summary"]
    assert set(s["gain_vs_zero_nats"]) == {"ae", "vq"}
    assert s["vq_gain_ceiling_nats"] == round(50 * np.log(512) / 16000, 4)


# ------------------------------------------------------------------- twins

def _tiny_twin(kind, a):
    base = tcfg.tiny_config()
    return dataclasses.replace(
        base, bottleneck=tcfg.BottleneckConfig(kind=kind, n_dim=16, vq_k=32),
        train=dataclasses.replace(base.train, n_steps=a.steps, holdout_every=5,
                                  aux_frame_weight=a.aux_weight))


@pytest.mark.parametrize("script", ["gain_ab", "diag_vae", "diag_vq"])
def test_twins_see_identical_batches(script, tmp_path, monkeypatch, capsys):
    """Every twin of a run draws the same windows at the same steps, for
    training and for its holdout eval (``diag_vq`` at the tiny width)."""
    runs: list[set] = []
    batch_at = tds.WindowSampler.batch_at
    init = tchassis.Chassis.__init__

    def recording_batch_at(self, step):
        wav, spk = batch_at(self, step)
        runs[-1].add((len(self.eligible), step, hashlib.sha1(wav.tobytes()).hexdigest(),
                      tuple(spk.tolist())))
        return wav, spk

    def new_run(self, *args, **kwargs):
        runs.append(set())
        init(self, *args, **kwargs)

    monkeypatch.setattr(tds.WindowSampler, "batch_at", recording_batch_at)
    monkeypatch.setattr(tchassis.Chassis, "__init__", new_run)
    common = ["--device", "cpu", "--workdir", str(tmp_path)]
    if script == "gain_ab":
        assert gain_ab.main([*common, "--tiny", "--steps", "4", "--eval-batches", "2",
                             "--bottlenecks", "zero,ae,vq,vae"]) == 0
        n_twins = 4
    elif script == "diag_vae":
        assert diag_vae.main([*common, "--preset", "tiny", "--steps", "4"]) == 0
        n_twins = 3
    else:
        monkeypatch.setattr(diag_vq, "twin_config", _tiny_twin)
        assert diag_vq.main([*common, "--steps", "4", "--aux-weight", "1.0"]) == 0
        n_twins = 3
        recs = _printed(capsys.readouterr().out)
        clouds = [r for r in recs if "at" in r]
        assert [r["at"] for r in clouds] == ["init", "step4"]
        assert {"batch_perplexity", "ema_counts_gt_thresh"} <= set(clouds[0])
        assert {"conditioning_gain_nats", "vq_gap_to_continuous"} <= set(recs[-1])
    assert len(runs) == n_twins and runs[0]
    steps = {r[1] for r in runs[0] if r[1] < 1 << 29}
    assert steps == set(range(4)), steps
    assert all(r == runs[0] for r in runs[1:])


# ------------------------------------------------------------------ tables

TABLES = {
    "compare_three": (compare_runs, jcompare_runs, [
        "vq=" + os.path.join(DOCS, "long_run_r5_vq256.jsonl"),
        "zero=" + os.path.join(DOCS, "long_run_r5_zero256.jsonl"),
        "vae=" + os.path.join(DOCS, "long_run_r5_vae256.jsonl")]),
    "compare_max_step": (compare_runs, jcompare_runs, [
        "--max-step", "2000", os.path.join(DOCS, "long_run_r5_vq256.jsonl"),
        "zero=" + os.path.join(DOCS, "long_run_r5_zero256.jsonl")]),
    "scaling": (gain_scaling, jgain_scaling, [
        "256=" + ",".join(os.path.join(DOCS, f"long_run_r5_{k}256.jsonl")
                          for k in ("zero", "vq", "vae"))]),
    "scaling_floor": (gain_scaling, jgain_scaling, [
        "--max-step", "4000", "--late-floor", "2000",
        "256=" + ",".join(os.path.join(DOCS, f"long_run_r5_{k}256.jsonl")
                          for k in ("zero", "vq", "vae"))]),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_tables_print_what_the_jax_copies_print(name, monkeypatch, capsys):
    port, ref, argv = TABLES[name]
    monkeypatch.setattr(sys, "argv", ["table", *argv])
    capsys.readouterr()
    ref.main()
    want = capsys.readouterr().out
    assert port.main(argv) == 0
    assert capsys.readouterr().out == want and want.count("\n") >= 3


SCRIPTS = ("long_run", "eval_quality", "quality_quantized", "diag_vq", "diag_vae",
           "gain_ab", "compare_runs", "gain_scaling")


def _options(path: str) -> set:
    with open(path) as f:
        return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', f.read()))


FLAG_CASES = {name: (f"scripts/{name}.py", f"ae_wavenet_tpu_torch/scripts/{name}.py",
                     set() if name in ("compare_runs", "gain_scaling") else {"--device"})
              for name in SCRIPTS}
FLAG_CASES["generate"] = ("ae_wavenet_tpu/cli/generate.py",
                          "ae_wavenet_tpu_torch/cli/generate.py", {"--ckpt", "--device"})


@pytest.mark.parametrize("name", sorted(FLAG_CASES))
def test_instrument_takes_the_jax_scripts_flags(name):
    """Every flag of the JAX entry point, and only the port's own beside
    them (``--device`` where it computes; generate's ``--ckpt``)."""
    root = os.path.dirname(DOCS)
    ref, port, extra = FLAG_CASES[name]
    want, got = _options(os.path.join(root, ref)), _options(os.path.join(root, port))
    assert want and want <= got, sorted(want - got)
    assert got - want == extra, sorted(got - want)


def test_instruments_take_the_cpu_only_when_asked(tmp_path):
    """No ``--device``: the card, which this machine does not have."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gain_ab.main(["--tiny", "--steps", "4", "--workdir", str(tmp_path)])
