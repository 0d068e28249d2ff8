"""Benchmark: training throughput (audio samples/s) of the flagship step on
the card: the MFCC frontend, the VQ-EMA bottleneck and the
speaker-conditioned WaveNet in bf16, on the hand-written gated stack.

Counterpart of the JAX package's root ``bench.py``, with its environment
and its one JSON line, printed last on stdout:

  {"metric": "train_audio_samples_per_sec_per_chip", "value": N, "unit": ...,
   "vs_baseline": N, "headline": "e2e" | "compute_only",
   "compute_only_value": N, "e2e_fraction": N, "steps_per_call": K,
   "model_tflops_per_step": N, "achieved_tflops_per_chip": N, "mfu": N}

Two segments on the same config and fixture (8 synthetic clips): a
compute-only loop of ``chassis.train_step`` over four batches already on
the device (3 warm-up steps, which also build the kernels, then
``BENCH_ITERS`` steps between two synchronisations), and the loop a user
runs, ``Chassis.train`` with ``BENCH_STEPS_PER_CALL`` steps a call and one
metrics fetch at the end (2K warm-up steps, then the timed ones).
``value`` is the second, the headline; ``BENCH_E2E=0`` skips it and the
headline is then the first.  MFU is the analytic FLOP count
(``utils/flops.py``) times the compute-only rate over the card's dense
bf16 peak.  The card's name and power limit go to stderr before the line.

Environment (the JAX bench's): ``BENCH_BATCH`` (4), ``BENCH_NWIN``
(48,000), ``BENCH_ITERS`` (20), ``BENCH_AUX_WEIGHT`` (1.0),
``BENCH_PALLAS_STACK`` (1; 0 runs the plain PyTorch stack),
``BENCH_FULL_FUSION`` and ``BENCH_BWD_GROUP`` (the whole-stack schedule,
only when set), ``BENCH_STEPS_PER_CALL`` (8), ``BENCH_E2E`` (1).

Where the port differs from the JAX bench: it has no backend probe and no
skip line (without a card the default device raises and no line is
printed); an e2e segment that fails raises, with no compute-only line in
its place; the rate is that of the one device the step ran on, however
many cards are visible; MFU is reported for every card whose peak
``utils/flops.peak_bf16_flops`` knows.

    python -m ae_wavenet_tpu_torch.bench [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

# The JAX bench's baseline (its bench.py:28-32; BASELINE.md "local
# baseline"): an equivalent PyTorch implementation of the same model and
# step on one host CPU core, 109.7 s a step at B = 16 x 1,600 samples.  A
# CPU number, the same for both packages; neither the card's nor a TPU's.
REFERENCE_SAMPLES_PER_SEC = 233.5
WARMUP = 3      # compute-only warm-up steps (the first builds the kernels)
N_BATCHES = 4   # batches put on the device for the compute-only loop


def bench_config(environ):
    """The flagship config as the JAX bench builds it from ``environ``
    (bench.py:116-146): VQ, the aux frame head, B x n_win, the fused
    stack unless ``BENCH_PALLAS_STACK`` is not "1", and the whole-stack
    schedule's two knobs where they are set."""
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, RunConfig,
                                                   TrainConfig)

    cfg = RunConfig(
        bottleneck=BottleneckConfig(kind="vq"),
        train=TrainConfig(batch_sz=int(environ.get("BENCH_BATCH", "4")),
                          n_win=int(environ.get("BENCH_NWIN", "48000")),
                          aux_frame_weight=float(environ.get("BENCH_AUX_WEIGHT", "1.0"))))
    wn = {}
    if environ.get("BENCH_PALLAS_STACK", "1") == "1":
        wn["use_pallas_stack"] = True
    if environ.get("BENCH_FULL_FUSION"):
        wn["gated_full_fusion"] = environ["BENCH_FULL_FUSION"] == "1"
    if environ.get("BENCH_BWD_GROUP"):
        wn["gated_bwd_group"] = int(environ["BENCH_BWD_GROUP"])
    return dataclasses.replace(cfg, wavenet=dataclasses.replace(cfg.wavenet, **wn))


def window_spec(cfg):
    """The window spec of ``cfg``'s model family."""
    from ae_wavenet_tpu_torch.models import registry

    return registry.get(cfg.model_kind).make_window_spec(cfg)


def fixture(prefix: str, cfg) -> str:
    """The JAX bench's fixture at ``prefix``: 8 clips of 4 speakers, each
    1,000 to 30,000 samples longer than a window (byte for byte the JAX
    package's ``make_synthetic_dataset`` at seed 0)."""
    from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset

    u_len = window_spec(cfg).u_len
    make_synthetic_dataset(prefix, n_clips=8, n_speakers=4,
                           clip_len=(u_len + 1000, u_len + 30000))
    return prefix


def compute_only(cfg, prefix: str, device, iters: int) -> float:
    """Samples/s of ``iters`` train steps on batches already on the device,
    after WARMUP steps, between two synchronisations (bench.py:156-180).
    The model and the optimizer are freed on return."""
    import numpy as np
    import torch

    from ae_wavenet_tpu_torch.data.dataset import PackedDataset, WindowSampler
    from ae_wavenet_tpu_torch.models import registry
    from ae_wavenet_tpu_torch.scripts._common import sync
    from ae_wavenet_tpu_torch.training import chassis

    family, spec, b = registry.get(cfg.model_kind), window_spec(cfg), cfg.train.batch_sz
    sampler = WindowSampler(PackedDataset(prefix), spec.u_len, b, seed=0)
    model = family.init(cfg, torch.Generator().manual_seed(0), device)
    opt = chassis.Adam(model.named_parameters(), cfg.train)
    batches = [(torch.from_numpy(w).to(device), torch.from_numpy(k.astype(np.int64)).to(device))
               for w, k in (sampler.batch_at(s) for s in range(N_BATCHES))]

    def step(s):
        w, k = batches[s % N_BATCHES]
        chassis.train_step(model, opt, cfg, spec, w, k, s)

    for s in range(WARMUP):
        step(s)
    sync(device)
    t0 = time.perf_counter()
    for s in range(iters):
        step(WARMUP + s)
    sync(device)
    return b * spec.n_win * iters / (time.perf_counter() - t0)


def e2e_steps(iters: int, k: int) -> int:
    """The timed steps of the e2e segment: at least three K-step calls."""
    return max(3 * k, iters - iters % k)


def e2e(cfg, prefix: str, device, iters: int, k: int) -> float:
    """Samples/s of ``Chassis.train`` with K steps a call and one metrics
    fetch, at the segment's end, after 2K warm-up steps (bench.py:182-209).
    A failure raises."""
    from ae_wavenet_tpu_torch.training.chassis import Chassis

    cfg_e2e = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps_per_call=k, log_every=1 << 30))
    n = e2e_steps(iters, k)
    ch = Chassis(cfg_e2e, prefix, device=device, log_stream=io.StringIO())
    try:
        ch.train(2 * k)  # ends in the fetch: the queue is drained
        t0 = time.perf_counter()
        ch.train(n)
        dt = time.perf_counter() - t0
    finally:
        ch.close()
    return cfg.train.batch_sz * window_spec(cfg).n_win * n / dt


def record(cfg, compute_sps: float, e2e_sps: float | None, k: int,
           peak: float | None) -> dict:
    """The JAX bench's line (bench.py:215-248, its keys and rounding).  The
    rates are the one device's the step ran on: nothing is divided by the
    cards that are merely visible."""
    from ae_wavenet_tpu_torch.utils import flops

    value = compute_sps if e2e_sps is None else e2e_sps
    fps = flops.train_step_flops_per_sample(cfg, window_spec(cfg))
    achieved = fps * compute_sps  # FLOP/s, the compute-only segment
    ran = e2e_sps is not None
    return {
        "metric": "train_audio_samples_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "samples/sec/chip",
        "vs_baseline": round(value / REFERENCE_SAMPLES_PER_SEC, 2),
        "headline": "e2e" if ran else "compute_only",
        "compute_only_value": round(compute_sps, 1),
        "e2e_fraction": round(value / compute_sps, 4) if ran else None,
        "steps_per_call": k if ran else None,
        "model_tflops_per_step": round(fps * cfg.train.batch_sz * cfg.train.n_win / 1e12, 4),
        "achieved_tflops_per_chip": round(achieved / 1e12, 2),
        "mfu": round(achieved / peak, 4) if peak else None,
    }


def peak_of(device) -> float | None:
    """The dense bf16 peak of ``device``'s card; None on the CPU."""
    import torch

    from ae_wavenet_tpu_torch.utils import flops

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return flops.peak_bf16_flops(torch.cuda.get_device_name(device))


def measure(cfg, device, iters: int = 20, k: int = 8, with_e2e: bool = True) -> dict:
    """Both segments on a fresh fixture in a temporary directory, then the
    record."""
    with tempfile.TemporaryDirectory() as td:
        prefix = fixture(os.path.join(td, "synth"), cfg)
        compute_sps = compute_only(cfg, prefix, device, iters)
        e2e_sps = e2e(cfg, prefix, device, iters, k) if with_e2e else None
    return record(cfg, compute_sps, e2e_sps, k, peak_of(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    from ae_wavenet_tpu_torch.utils import device as device_mod
    from ae_wavenet_tpu_torch.utils.precision import set_reference_precision

    device = device_mod.resolve(a.device)
    set_reference_precision()
    print(device_mod.card_line(device), file=sys.stderr)
    rec = measure(bench_config(os.environ), device,
                  iters=int(os.environ.get("BENCH_ITERS", "20")),
                  k=int(os.environ.get("BENCH_STEPS_PER_CALL", "8")),
                  with_e2e=os.environ.get("BENCH_E2E", "1") == "1")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
