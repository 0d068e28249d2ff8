"""Measure autoregressive generation throughput (samples/sec and real-time
factor).

Counterpart of the JAX package's ``scripts/bench_gen.py``, its two arms
mapped onto the port:

* "xla_scan" times the plain formulation, the sampler
  ``ops/fastgen.generate`` (one cell step per sample, replayed as a CUDA
  graph on the card as the reference's scan is jitted; ``GEN_DTYPE=bf16``
  rounds every GEMM input to bf16 and sums in f32, as the reference's
  ``dtype`` does).  Its ``compile_s`` is the first call's seconds: nothing
  is compiled here, and every call captures its step anew;
* "pallas_fused" (``_int8`` with ``GEN_INT8=1``, ``_int4`` with
  ``GEN_INT4=1``) times the hand-written sampler,
  ``ops/fastgen_cuda.generate_auto`` (K4, K5, K6: ``csrc/fastgen.cu``),
  weight packing included.  It runs wherever the tensors are (on CPU
  tensors the kernel's plain version); the reference ran it on the TPU
  only.

Environment: ``GEN_BATCH`` (64), ``GEN_STEPS`` (4096), ``GEN_DTYPE``
(``bf16``), ``GEN_SKIP_SCAN`` (``1`` skips the "xla_scan" record), ``GEN_INT8``,
``GEN_INT4``.  Each record is the best of three calls after a warm-up, the
host clock around a call that ends in a synchronisation of the device.

    python -m ae_wavenet_tpu_torch.scripts.bench_gen [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ae_wavenet_tpu_torch.scripts import _common


def decoder_config():
    """The flagship decoder."""
    from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

    return WaveNetConfig()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    from ae_wavenet_tpu_torch.models.wavenet import WaveNet
    from ae_wavenet_tpu_torch.ops import fastgen
    from ae_wavenet_tpu_torch.ops import fastgen_cuda as fc

    device = _common.setup(a.device)
    batch = int(os.environ.get("GEN_BATCH", "64"))
    t_gen = int(os.environ.get("GEN_STEPS", "4096"))
    dtype = (torch.bfloat16 if os.environ.get("GEN_DTYPE", "bf16") == "bf16"
             else torch.float32)

    cfg = decoder_config()
    wn = WaveNet(cfg, torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(0)
    cond = torch.as_tensor(rng.normal(size=(batch, cfg.n_lc_out, t_gen)) * 0.1,
                           dtype=torch.float32, device=device)
    spk = torch.as_tensor(rng.integers(0, cfg.n_speakers, (batch,)), device=device)
    state = fastgen.init_state(cfg, batch, device=device)

    def fresh() -> fastgen.GenState:
        """The start state again: the sampler writes its queues in place."""
        return fastgen.GenState(tuple(b.clone() for b in state.bufs),
                                state.prev_id.clone(), state.t)

    def best_of_three(run, seed0: int) -> float:
        dt = 1e30
        for r in range(3):
            st = fresh()
            _common.sync(device)
            t0 = time.perf_counter()
            run(st, seed0 + r)
            _common.sync(device)
            dt = min(dt, time.perf_counter() - t0)
        return dt

    def gen(seed: int, on=device) -> torch.Generator:
        return torch.Generator(device=on).manual_seed(seed)

    if os.environ.get("GEN_SKIP_SCAN", "0") != "1":
        def scan(st, seed):
            return fastgen.generate(wn, cfg, st, cond, gen(seed), gc_ids=spk,
                                    dtype=dtype)

        st = fresh()
        _common.sync(device)
        t0 = time.perf_counter()
        scan(st, 1)
        _common.sync(device)
        compile_s = time.perf_counter() - t0
        dt = best_of_three(scan, 2)
        sps = t_gen / dt  # sequential samples/sec per stream
        print(json.dumps({
            "path": "xla_scan",
            "platform": _common.platform(device),
            "batch": batch,
            "dtype": str(dtype).rsplit(".", 1)[-1],
            "gen_steps": t_gen,
            "wall_s": round(dt, 3),
            "samples_per_sec_per_stream": round(sps, 1),
            "rtf_16k": round(sps / 16000.0, 3),
            "aggregate_samples_per_sec": round(sps * batch, 1),
            "compile_s": round(compile_s, 1),
        }), flush=True)

    # the hand-written sampler
    quantized = os.environ.get("GEN_INT8", "0") == "1"
    if os.environ.get("GEN_INT4", "0") == "1":
        quantized = "int4"

    def fused(st, seed):
        # the kernel's seed is drawn on the host
        return fc.generate_auto(wn, cfg, st, cond, gen(seed, "cpu"), gc_ids=spk,
                                quantized=quantized)

    fused(fresh(), 3)
    dt = best_of_three(fused, 4)
    sps = t_gen / dt
    print(json.dumps({
        "path": "pallas_fused" + (
            "_int4" if quantized == "int4" else "_int8" if quantized else ""),
        "batch": batch,
        "gen_steps": t_gen,
        "vmem_dil_max": cfg.fastgen_vmem_dil_max,
        "wall_s": round(dt, 3),
        "samples_per_sec_per_stream": round(sps, 1),
        "rtf_16k": round(sps / 16000.0, 3),
        "aggregate_samples_per_sec": round(sps * batch, 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
