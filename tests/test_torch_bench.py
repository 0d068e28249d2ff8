"""The port's bench (``ae_wavenet_tpu_torch/bench.py``) against the JAX
package's root ``bench.py``, on the CPU: the config it builds from the
environment, field for field; the FLOP count of its record; the record's
keys, read from ``bench.py``'s source; a tiny run through both segments
(the fused stack's plain versions, launched as the path gives them); and
the reference's quirks it does not copy (the e2e fallback, the skip line
without a backend, the division by the visible devices)."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

import bench as jbench
from chip_smoke import bench_keys
from ae_wavenet_tpu.models import autoencoder as jae
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu.utils import flops as jflops
from ae_wavenet_tpu_torch import bench
from ae_wavenet_tpu_torch.ops import gated
from ae_wavenet_tpu_torch.training import chassis
from ae_wavenet_tpu_torch.utils import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("BENCH_BATCH", "BENCH_NWIN", "BENCH_ITERS", "BENCH_AUX_WEIGHT",
         "BENCH_PALLAS_STACK", "BENCH_FULL_FUSION", "BENCH_BWD_GROUP",
         "BENCH_STEPS_PER_CALL", "BENCH_E2E")
ENVS = {
    "defaults": {},
    "plain_stack": {"BENCH_PALLAS_STACK": "0"},
    "whole_stack": {"BENCH_FULL_FUSION": "1", "BENCH_BWD_GROUP": "5"},
    "no_aux": {"BENCH_AUX_WEIGHT": "0"},
    "b8_w24000": {"BENCH_BATCH": "8", "BENCH_NWIN": "24000"},
}
BENCH_CONFIG = bench.bench_config
ITERS, K = 2, 2  # the tiny run: 3 + 2 compute-only steps, 4 + 6 e2e steps


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny widths gain nothing from more, and the
    suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def env(monkeypatch):
    """No bench knob set but those a test sets."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


class _Caught(Exception):
    pass


def _jax_bench_config(monkeypatch, environ: dict):
    """The ``RunConfig`` that the JAX ``bench.main`` builds under
    ``environ`` (bench.py:116-146), caught where it asks for its window
    spec, past the backend probe."""
    for k, v in environ.items():
        monkeypatch.setenv(k, v)

    def caught(cfg, *a, **kw):
        raise _Caught(cfg)

    with monkeypatch.context() as m, pytest.raises(_Caught) as e:
        m.setattr(jbench, "_probe_with_retry", lambda: True)
        m.setattr(jae, "make_window_spec", caught)
        jbench.main()
    return e.value.args[0]


def _tiny(cfg: tcfg.RunConfig) -> tcfg.RunConfig:
    """``cfg`` at the tiny preset's widths (every schedule field, the
    bottleneck's kind, the aux head and bf16 kept) and B = 2 x 320."""
    t = tcfg.tiny_config()
    wn = dataclasses.replace(
        t.wavenet, use_pallas_stack=cfg.wavenet.use_pallas_stack,
        gated_full_fusion=cfg.wavenet.gated_full_fusion,
        gated_bwd_group=cfg.wavenet.gated_bwd_group)
    bn = dataclasses.replace(cfg.bottleneck, n_dim=16, vq_k=32)
    train = dataclasses.replace(cfg.train, batch_sz=2, n_win=320)
    return dataclasses.replace(cfg, encoder=t.encoder, bottleneck=bn, wavenet=wn,
                               train=train)


def _lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("name", sorted(ENVS))
def test_config_is_the_jax_bench_config(env, name):
    """Field for field (their JSON forms) the config ``bench.py`` builds
    from the same environment."""
    want = _jax_bench_config(env, ENVS[name])
    got = bench.bench_config({**os.environ, **ENVS[name]})
    assert tcfg.to_json(got) == jcfg.to_json(want)


@pytest.mark.parametrize("name", ["defaults", "b8_w24000", "no_aux"])
def test_model_tflops_per_step_is_the_jax_count(env, name):
    """``model_tflops_per_step`` (and the achieved rate and MFU from it)
    is the JAX package's FLOP count at the JAX bench's config, rounded as
    ``bench.py`` rounds it; 15.36 at the defaults, to two places."""
    jc = _jax_bench_config(env, ENVS[name])
    fps = jflops.train_step_flops_per_sample(jc, jae.make_window_spec(jc))
    n = jc.train.batch_sz * jc.train.n_win
    rec = bench.record(bench.bench_config(ENVS[name]), 1.25e6, 1.2e6, 8, 989e12)
    assert rec["model_tflops_per_step"] == round(fps * n / 1e12, 4)
    assert rec["achieved_tflops_per_chip"] == round(fps * 1.25e6 / 1e12, 2)
    assert rec["mfu"] == round(fps * 1.25e6 / 989e12, 4)
    if name == "defaults":  # 15.3597: the 15.360 TFLOP a step of PERF.md
        assert round(rec["model_tflops_per_step"], 2) == 15.36


def test_record_keys_are_the_jax_bench_keys():
    """The keys, in order, of ``bench.py``'s final line (read from its
    source with ast, as ``chip_smoke.py`` phase 14 reads them), in both
    headlines."""
    cfg = bench.bench_config({})
    want = bench_keys()
    assert "mfu" in want and "headline" in want
    assert list(bench.record(cfg, 1.0e6, 0.99e6, 8, None)) == want
    assert list(bench.record(cfg, 1.0e6, None, 8, None)) == want


def test_tiny_run_gives_a_complete_record():
    """Both segments at the tiny width on the CPU: the e2e headline, every
    number finite and positive, K steps a call, no MFU without a card; the
    fused stack's pair forward and backward (their plain versions on the
    CPU) once per pair in each of the run's steps.  The achieved rate is
    rounded to two places (bench.py:246): at the tiny width it is about
    0.004 TFLOP/s, so it is held to the rate it is computed from, not to
    > 0."""
    cfg = _tiny(bench.bench_config({}))
    pairs = len(gated.stack_dils(cfg.wavenet)) // 2
    fwd, bwd = gated.gated_pair_fused_reference, gated.gated_pair_bwd_reference
    before = (fwd.launches, bwd.launches)
    rec = bench.measure(cfg, "cpu", iters=ITERS, k=K)
    steps = bench.WARMUP + ITERS + 2 * K + bench.e2e_steps(ITERS, K)
    assert steps == 3 + 2 + 4 + 6
    assert (fwd.launches - before[0], bwd.launches - before[1]) == (pairs * steps,) * 2
    assert rec["metric"] == "train_audio_samples_per_sec_per_chip"
    assert rec["unit"] == "samples/sec/chip"
    assert rec["headline"] == "e2e" and rec["steps_per_call"] == K
    assert rec["mfu"] is None
    for key in ("value", "vs_baseline", "compute_only_value", "e2e_fraction",
                "model_tflops_per_step"):
        assert math.isfinite(rec[key]) and rec[key] > 0, (key, rec)
    # achieved = FLOP a sample x the compute-only rate; from the rounded
    # record: half a unit of its own last place, plus what the rounding of
    # model_tflops_per_step (4 places) and compute_only_value (1) carries
    n = cfg.train.batch_sz * cfg.train.n_win
    tflops, sps = rec["model_tflops_per_step"], rec["compute_only_value"]
    slack = 0.005 + (0.5e-4 * sps + 0.05 * tflops) / n + 1e-12
    achieved = rec["achieved_tflops_per_chip"]
    assert math.isfinite(achieved) and achieved >= 0, rec
    assert abs(achieved - tflops * sps / n) <= slack, (tflops * sps / n, rec)
    # the record rounds the ratios of the unrounded rates
    assert abs(rec["e2e_fraction"] - rec["value"] / rec["compute_only_value"]) < 1e-3
    assert abs(rec["vs_baseline"] - rec["value"] / 233.5) < 0.01


def test_e2e_steps_match_the_jax_bench():
    """At least three K-step calls, else the iterations rounded down to K
    (bench.py:195)."""
    for iters, k in ((20, 8), (2, 2), (40, 8), (17, 4), (1, 1)):
        assert bench.e2e_steps(iters, k) == max(3 * k, iters - iters % k)


def test_e2e_off_gives_the_compute_only_headline(env, capsys):
    """``BENCH_E2E=0``: no ``Chassis`` runs, the headline is the compute
    loop's and ``e2e_fraction`` and ``steps_per_call`` are None."""
    env.setattr(bench, "bench_config", lambda environ: _tiny(BENCH_CONFIG({})))
    env.setenv("BENCH_E2E", "0")
    env.setenv("BENCH_ITERS", str(ITERS))

    def no_chassis(*a, **kw):
        raise AssertionError("the e2e segment ran")

    env.setattr(chassis.Chassis, "train", no_chassis)
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr()
    rec = _lines(out.out)[-1]
    assert out.out.strip().splitlines()[-1].startswith("{")
    assert rec["headline"] == "compute_only"
    assert rec["e2e_fraction"] is None and rec["steps_per_call"] is None
    assert rec["value"] == rec["compute_only_value"] > 0
    assert out.err.strip().splitlines()[0] == "cpu"


def test_failing_e2e_segment_raises_with_no_line(env, capsys):
    """The JAX bench prints the compute-only headline when its e2e segment
    fails (bench.py:211-213); the port raises and prints no line."""
    env.setattr(bench, "bench_config", lambda environ: _tiny(BENCH_CONFIG({})))
    env.setenv("BENCH_ITERS", str(ITERS))
    env.setenv("BENCH_STEPS_PER_CALL", str(K))

    def planted(*a, **kw):
        raise RuntimeError("planted e2e failure")

    env.setattr(chassis.Chassis, "train", planted)
    with pytest.raises(RuntimeError, match="planted e2e failure"):
        bench.main(["--device", "cpu"])
    assert _lines(capsys.readouterr().out) == []


def test_default_device_raises_without_a_card(env, capsys):
    """No probe and no skip line: the default device raises."""
    env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    assert _lines(capsys.readouterr().out) == []


def test_cli_exits_nonzero_without_a_card():
    """``python -m ae_wavenet_tpu_torch.bench`` with no card visible: a
    non-zero exit and no JSON line (the JAX bench prints a skip line and
    exits 0).  The small sizes only bound the run should the guard fail."""
    run_env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    run_env.update(CUDA_VISIBLE_DEVICES="", BENCH_BATCH="1", BENCH_NWIN="320",
                   BENCH_ITERS="1", BENCH_E2E="0")
    r = subprocess.run([sys.executable, "-m", "ae_wavenet_tpu_torch.bench"], cwd=ROOT,
                       env=run_env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert _lines(r.stdout) == []
    assert "no CUDA device" in r.stderr


def test_visible_cards_do_not_divide_the_rate(env, monkeypatch):
    """The JAX bench divides by every visible device (bench.py:215); the
    port reports the one device's rate however many cards it sees."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(bench, "fixture", lambda prefix, cfg: prefix)
    monkeypatch.setattr(bench, "compute_only", lambda cfg, prefix, device, iters: 1.0e6)
    monkeypatch.setattr(bench, "e2e", lambda cfg, prefix, device, iters, k: 0.98e6)
    rec = bench.measure(bench.bench_config({}), "cpu")
    assert rec["value"] == 980000.0 and rec["compute_only_value"] == 1000000.0
    assert rec["e2e_fraction"] == 0.98 and rec["steps_per_call"] == 8
