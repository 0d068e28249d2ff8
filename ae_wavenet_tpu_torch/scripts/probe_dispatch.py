"""Localise the compute-vs-e2e throughput gap of the training loop.

Counterpart of the JAX package's ``scripts/probe_dispatch.py``.  The e2e
loop (``Chassis.train``) differs from a compute-only loop in host-side
costs per K-step block; this script measures each of them, then runs
``Chassis.train`` at several K to show the rest.  The keys and what they
measure here:

* ``rtt_scalar_get_ms``: ``.item()`` of a 0-d tensor on the device;
* ``assemble_block_ms``, ``block_mbytes``: K ``batch_at`` draws stacked
  into one block (the loader's work for a block);
* ``put_block_ms``: the block pinned and copied to the device with
  ``non_blocking``, then a synchronisation;
* ``dispatch_ms``: the host time for ``chassis.train_step(...,
  k_steps=K)`` to return (eager PyTorch: the host enqueues every kernel
  of the K steps, and waits when the launch queue is full);
* ``block_compute_rest_ms``: the synchronisation after that;
* ``compute_sps``: three blocks on the device, compute only;
* ``metrics_fetch_ms``: ``chassis.fetch`` of the last step's metrics;
* ``e2e_sps_k{1,K,2K}``, ``e2e_frac_k*``: ``Chassis.train`` with K steps a
  call and no log point inside the run, against ``compute_sps``.

Environment: ``PROBE_TINY`` (the tiny config, for a CPU check of the
plumbing), ``BENCH_BATCH`` (4), ``BENCH_NWIN`` (48,000),
``BENCH_STEPS_PER_CALL`` (8).  The flagship config is VQ, aux weight 1.0,
the hand-written gated stack.  Prints one JSON line (milliseconds).

    python -m ae_wavenet_tpu_torch.scripts.probe_dispatch [--device cuda]
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

from ae_wavenet_tpu_torch.scripts import _common


def timed(fn, iters: int) -> float:
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3  # ms


def run_config(tiny: bool, batch_sz: int, n_win: int):
    """The tiny config, or the flagship VQ config on the fused stack."""
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, RunConfig,
                                                   TrainConfig, WaveNetConfig,
                                                   tiny_config)

    if tiny:
        cfg = tiny_config()
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_sz=batch_sz, n_win=n_win))
    return RunConfig(bottleneck=BottleneckConfig(kind="vq"),
                     wavenet=WaveNetConfig(use_pallas_stack=True),
                     train=TrainConfig(batch_sz=batch_sz, n_win=n_win,
                                       aux_frame_weight=1.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    import numpy as np
    import torch

    from ae_wavenet_tpu_torch.data.dataset import PackedDataset, WindowSampler
    from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.training import chassis

    device = _common.setup(a.device)
    tiny = bool(os.environ.get("PROBE_TINY"))  # CPU check of the plumbing
    batch_sz = int(os.environ.get("BENCH_BATCH", "2" if tiny else "4"))
    n_win = int(os.environ.get("BENCH_NWIN", "320" if tiny else "48000"))
    k = int(os.environ.get("BENCH_STEPS_PER_CALL", "2" if tiny else "8"))
    cfg = run_config(tiny, batch_sz, n_win)
    spec = ae.make_window_spec(cfg)

    out: dict = {"k": k, "batch": batch_sz, "n_win": n_win}

    # (0) round trip: one scalar from the device
    one = torch.ones((), device=device) + 0
    _common.sync(device)
    out["rtt_scalar_get_ms"] = round(timed(one.item, 20), 3)

    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "synth")
        make_synthetic_dataset(prefix, n_clips=8, n_speakers=4,
                               clip_len=(spec.u_len + 1000, spec.u_len + 30000))
        ds = PackedDataset(prefix)
        sampler = WindowSampler(ds, spec.u_len, batch_sz, seed=0)

        # (1) host block assembly: K batch_at + np.stack
        def assemble(s=0):
            ws, ks = zip(*(sampler.batch_at(s + i) for i in range(k)))
            return np.stack(ws), np.stack(ks)

        out["assemble_block_ms"] = round(timed(assemble, 5), 2)
        wav_blk, spk_blk = assemble()
        out["block_mbytes"] = round(wav_blk.nbytes / 1e6, 2)

        # (2) host -> device copy of the staged block (the loader's: pinned,
        # non_blocking), then a synchronisation
        def put(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if device.type == "cuda":
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        def put_block():
            put(wav_blk)
            _common.sync(device)

        out["put_block_ms"] = round(timed(put_block, 5), 2)

        # (3) the K-step call and its compute
        model = ae.init(cfg, torch.Generator().manual_seed(0), device)
        opt = chassis.Adam(model.named_parameters(), cfg.train)
        dwav, dspk = put(wav_blk), put(spk_blk.astype(np.int64))

        def block(s):
            return chassis.train_step(model, opt, cfg, spec, dwav, dspk, s * k, k)

        for s in range(2):  # warm
            m = block(s)
        _common.sync(device)
        # how long the call takes to return on the host
        t0 = time.perf_counter()
        m = block(2)
        out["dispatch_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
        t0 = time.perf_counter()
        _common.sync(device)
        out["block_compute_rest_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        # steady-state compute-only rate over 3 blocks
        t0 = time.perf_counter()
        for i in range(3):
            m = block(3 + i)
        _common.sync(device)
        dt = time.perf_counter() - t0
        out["compute_sps"] = round(3 * k * batch_sz * n_win / dt)

        # (4) the metrics fetch (one device-to-host copy of ~10 scalars)
        out["metrics_fetch_ms"] = round(timed(lambda: chassis.fetch(m), 10), 2)
        del model, opt, dwav, dspk, m

        # (5) e2e at several K
        for kk in sorted({1, k, 2 * k}):
            cfg_k = dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, steps_per_call=kk,
                                               log_every=1 << 30))
            ch = chassis.Chassis(cfg_k, prefix, device=device,
                                 log_stream=io.StringIO())
            ch.train(2 * kk)
            n = max(3 * kk, 24 - 24 % kk)
            t0 = time.perf_counter()
            ch.train(n)
            dt = time.perf_counter() - t0
            sps = batch_sz * n_win * n / dt
            out[f"e2e_sps_k{kk}"] = round(sps)
            out[f"e2e_frac_k{kk}"] = round(sps / out["compute_sps"], 4)
            ch.close()
            del ch

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
