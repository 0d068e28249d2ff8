"""Measure the train-loop pause a checkpoint save causes: a blocking save
against the async ``Saver`` (training/checkpoint.py).

Counterpart of the JAX package's ``scripts/bench_ckpt.py``.  The number
that matters is how long ``Chassis.train``'s step loop stalls: for the
blocking path the host snapshot, serialisation and write; for the async
path the host snapshot (``weights.export_state``: device to host) and
``Saver.save()``'s return (the write goes on on a background thread).
Both start from the model and optimizer state on the device, as
``Chassis.save`` does.

    python -m ae_wavenet_tpu_torch.scripts.bench_ckpt [--flagship] [--repeats 3] \\
        [--device cuda]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from ae_wavenet_tpu_torch.scripts import _common


def run_config(flagship: bool):
    """The flagship VQ config's parameter sizes, or the tiny config's."""
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, RunConfig,
                                                   tiny_config)

    return RunConfig(bottleneck=BottleneckConfig(kind="vq")) if flagship \
        else tiny_config()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--flagship", action="store_true",
                   help="flagship param sizes (default: tiny)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when there is no card")
    a = p.parse_args(argv)

    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod
    from ae_wavenet_tpu_torch.training import weights
    from ae_wavenet_tpu_torch.training.chassis import Adam

    device = _common.setup(a.device)
    cfg = run_config(a.flagship)
    model = ae.init(cfg, torch.Generator().manual_seed(0), device)
    opt = Adam(model.named_parameters(), cfg.train)
    n_bytes = sum(v.numel() * v.element_size()
                  for v in weights.export_state(model, opt.named_state()).values())

    def timed(fn):
        best = float("inf")
        for _ in range(a.repeats):
            _common.sync(device)
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    with tempfile.TemporaryDirectory() as td:
        saver = ckpt_mod.Saver()
        step = [0]

        def save(blocking: bool):
            step[0] += 1
            saver.save(td, step[0], weights.export_state(model, opt.named_state()),
                       cfg, blocking=blocking)

        blocking_s = timed(lambda: save(True))
        async_s = timed(lambda: save(False))  # loop-visible pause only
        t0 = time.perf_counter()
        saver.wait()
        drain_s = time.perf_counter() - t0
        saver.close()

    print(json.dumps({
        "metric": "ckpt_save_pause_sec",
        "params_mb": round(n_bytes / 1e6, 1),
        "blocking_save_sec": round(blocking_s, 4),
        "async_save_return_sec": round(async_s, 4),
        "async_final_drain_sec": round(drain_s, 4),
        "pause_reduction": round(blocking_s / max(async_s, 1e-9), 1),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
