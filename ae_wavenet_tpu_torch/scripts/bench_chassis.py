"""End-to-end chassis-loop throughput: the flagship config through
``Chassis.train``, the host sampler, the pinned loader and the metrics
fetch at the log point included, as opposed to a compute-only loop over
batches already on the device.

Counterpart of the JAX package's ``scripts/bench_chassis.py``: VQ, bf16,
B = 8 x 24,000 on the reference's synthetic fixture (8 clips), the
hand-written gated stack unless ``BENCH_PALLAS_STACK=0`` (then the plain
PyTorch stack).  3 warm-up steps, then one log window over ``--steps``.

    python -m ae_wavenet_tpu_torch.scripts.bench_chassis [--steps 30] [--device cuda]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile

from ae_wavenet_tpu_torch.scripts import _common

WARMUP = 3


def run_config(a, pallas_stack: bool):
    """The flagship VQ config at ``--batch`` x ``--n-win``, one log window
    over exactly the measured steps (log_every = warm-up + steps: the only
    fetch, and the drain, is the last one)."""
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, RunConfig,
                                                   TrainConfig, WaveNetConfig)

    return RunConfig(
        bottleneck=BottleneckConfig(kind="vq"),
        wavenet=WaveNetConfig(use_pallas_stack=pallas_stack),
        train=TrainConfig(batch_sz=a.batch, n_win=a.n_win,
                          log_every=a.steps + WARMUP, n_steps=a.steps + WARMUP))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-win", type=int, default=24000)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.training.chassis import Chassis

    device = _common.setup(a.device)
    cfg = run_config(a, os.environ.get("BENCH_PALLAS_STACK", "1") == "1")
    spec = ae.make_window_spec(cfg)
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "synth")
        make_synthetic_dataset(prefix, n_clips=8, n_speakers=4,
                               clip_len=(spec.u_len + 1000, spec.u_len + 30000))
        ch = Chassis(cfg, prefix, device=device, log_stream=io.StringIO())
        # the warm-up's end-of-call fetch drains the queue; the measuring
        # train() then has exactly one log window: its steps
        ch.train(WARMUP)
        hist = ch.train(a.steps)
        ch.close()
        e2e = hist[-1]["samples_per_sec"]
    print(json.dumps({
        "metric": "chassis_e2e_samples_per_sec",
        "value": round(e2e, 1),
        "config": f"b{a.batch} x {a.n_win}, {a.steps} steps, loader included",
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
