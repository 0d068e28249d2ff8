"""MFCC frontend throughput: must not bottleneck training.

Counterpart of the JAX package's ``scripts/bench_mfcc.py``.  Measures (a)
the frontend the train step runs, ``audio/mfcc.mfcc_delta_stack`` on the
device (``path`` ``torch_device_<platform>``), (b) the same function on
CPU tensors (``host_torch_cpu``: the reference's numpy twin
``mfcc_delta_stack_np`` is not ported, so the host row is the port's own
frontend run on the host, what a DataLoader-worker frontend would cost),
and (c) the implied share of the flagship train step at the port's main
path's rate (``MFCC_TRAIN_SPS``).

Environment: ``MFCC_BATCH`` (4), ``MFCC_T`` (50,000 samples),
``MFCC_TRAIN_SPS``.  Timing: the host clock between two synchronisations
of the device.

    python -m ae_wavenet_tpu_torch.scripts.bench_mfcc [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ae_wavenet_tpu_torch.scripts import _common

# the port's main path (pairs, saved y; B = 4, n_win = 48,000) on an NVIDIA
# H100 80GB HBM3 at 700 W: 1,313,028 samples/s (PERF.md section 5)
TRAIN_SPS = "1313028"
DEVICE_ITERS, HOST_ITERS = 30, 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    from ae_wavenet_tpu_torch.audio.mfcc import mfcc_delta_stack
    from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float
    from ae_wavenet_tpu_torch.utils.config import SpecConfig

    device = _common.setup(a.device)
    spec = SpecConfig()
    batch, t = int(os.environ.get("MFCC_BATCH", "4")), \
        int(os.environ.get("MFCC_T", "50000"))
    rng = np.random.default_rng(0)
    wav_i16 = rng.integers(-8000, 8000, (batch, t)).astype(np.int16)
    n_frames = (t - spec.win_sz) // spec.hop_sz + 1 - 4 * spec.delta_wing

    def frontend(x):
        return lambda: mfcc_delta_stack(int16_to_float(x), spec)

    # --- on the device (the train step's input stage)
    dt = _common.timed(frontend(torch.from_numpy(wav_i16).to(device)), DEVICE_ITERS,
                       device)
    dev_fps = batch * n_frames / dt
    print(json.dumps({
        "bench": "mfcc_frontend", "path": f"torch_device_{_common.platform(device)}",
        "batch": batch, "wav_samples": t, "frames_per_call": batch * n_frames,
        "us_per_call": round(dt * 1e6, 1),
        "frames_per_sec": round(dev_fps, 1),
        "audio_samples_per_sec": round(batch * t / dt, 1),
    }), flush=True)

    # --- the same frontend on the host
    dt_h = _common.timed(frontend(torch.from_numpy(wav_i16)), HOST_ITERS, "cpu")
    host_fps = batch * n_frames / dt_h
    print(json.dumps({
        "bench": "mfcc_frontend", "path": "host_torch_cpu",
        "frames_per_sec": round(host_fps, 1),
        "audio_samples_per_sec": round(batch * t / dt_h, 1),
        "device_speedup": round(dev_fps / host_fps, 1),
    }), flush=True)

    # --- share of the flagship train step: at R samples/s the frontend
    # processes R / hop_sz frames/s; its capacity above gives the share
    train_sps = float(os.environ.get("MFCC_TRAIN_SPS", TRAIN_SPS))
    need_fps = train_sps / spec.hop_sz
    print(json.dumps({
        "bench": "mfcc_frontend", "path": "train_step_share",
        "train_samples_per_sec_assumed": train_sps,
        "frames_per_sec_needed": round(need_fps, 1),
        "isolated_capacity_fraction": round(need_fps / dev_fps, 5),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
