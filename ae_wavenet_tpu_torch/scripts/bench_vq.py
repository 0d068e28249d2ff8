"""Head-to-head: the hand-written VQ lookup against the plain PyTorch
formulation, the op alone over a K x N sweep and inside the train step.

Counterpart of the JAX package's ``scripts/bench_vq.py``, its two arms
mapped onto the port:

* "xla" is the plain formulation: ``ops/vq_cuda.vq_lookup_reference`` for
  the op alone, ``VQBottleneck``'s unfused path (``vq_use_pallas=False``)
  in the step;
* "pallas" is the hand-written kernel, K9 (``ops/vq_cuda.vq_lookup_fused``,
  ``csrc/vq.cu``).

At every sweep shape the kernel's codes, rows, counts and sums are held to
the plain version's (codes equal except near-ties, on under 1% of the
rows; the rows the codebook's, bit for bit; the counts exact; the sums
within 1e-4 of their largest): a disagreement raises.  ``tile_n`` is the
TPU kernel's row tile; the CUDA kernel has none, so it is null here.  The
train step is the flagship step (VQ, bf16, B = ``BENCH_BATCH``, n_win =
``BENCH_NWIN``) on the hand-written gated stack, at step 0 every time, as
the reference's is; the timing is the host clock between two
synchronisations of the device (``TRAIN_WARMUP`` calls, then
``TRAIN_ITERS``).

    python -m ae_wavenet_tpu_torch.scripts.bench_vq [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ae_wavenet_tpu_torch.scripts import _common

SWEEP_K = (512, 4096, 8192)
SWEEP_N = (4096, 16384)
D = 64
OP_WARMUP, OP_ITERS = 3, 20
TRAIN_WARMUP, TRAIN_ITERS = 3, 15
SUM_REL_TOL = 1e-4   # f32 sums of up to N rows taken in another order
TIE_REL_GAP = 1e-5   # a differing code must be this near a tie


def disagreement(z, e, got, want) -> list[str]:
    """Why the kernel's (codes, quant, counts, sums) ``got`` do not hold to
    the plain version's ``want`` on latents z and codebook e (empty: they
    do)."""
    n, k = z.shape[0], e.shape[0]
    codes, ref = got[0].long(), want[0].long()
    why = []
    differ = torch.nonzero(codes != ref)[:, 0]
    if len(differ) >= max(1, n // 100):
        why.append(f"{len(differ)} of {n} codes differ")
    zd, ed = z[differ[:64]].double(), e.double()
    d2 = ed.square().sum(1)[None] - 2.0 * zd @ ed.t()
    for i, r in enumerate(differ[:64].tolist()):
        gap = abs(float(d2[i, codes[r]] - d2[i, ref[r]]))
        if gap > TIE_REL_GAP * float(d2[i].abs().max()):
            why.append(f"row {r}: codes {int(codes[r])} and {int(ref[r])} are no tie")
    if not torch.equal(got[1], e[codes]):
        why.append("quant is not codebook[codes]")
    if not torch.equal(got[2], torch.bincount(codes, minlength=k).float()):
        why.append("counts are not exact")
    sums = torch.zeros(k, z.shape[1], dtype=torch.float64, device=z.device)
    sums.index_add_(0, codes, z.double())
    err = float((got[3].double() - sums).abs().max())
    if err > SUM_REL_TOL * float(sums.abs().max()):
        why.append(f"sums off by {err:.4g}")
    return why


def step_config(use_pallas: bool, batch_sz: int, n_win: int):
    """The flagship train step's config, the VQ kernel on or off."""
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, RunConfig,
                                                   TrainConfig, WaveNetConfig)

    return RunConfig(bottleneck=BottleneckConfig(kind="vq", vq_use_pallas=use_pallas),
                     wavenet=WaveNetConfig(use_pallas_stack=True),
                     train=TrainConfig(batch_sz=batch_sz, n_win=n_win))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.ops import vq_cuda
    from ae_wavenet_tpu_torch.training import chassis

    device = _common.setup(a.device)
    batch_sz = int(os.environ.get("BENCH_BATCH", "8"))
    n_win = int(os.environ.get("BENCH_NWIN", "24000"))

    # --- the op alone: the plain formulation against the kernel ----------
    rng = np.random.default_rng(0)
    for k in SWEEP_K:
        for n in SWEEP_N:
            z = torch.as_tensor(rng.normal(size=(n, D)), dtype=torch.float32,
                                device=device)
            e = torch.as_tensor(rng.normal(size=(k, D)), dtype=torch.float32,
                                device=device)
            why = disagreement(z, e, vq_cuda.vq_lookup_fused(z, e),
                               vq_cuda.vq_lookup_reference(z, e))
            if why:
                raise RuntimeError(f"vq kernel at N={n} K={k} D={D}: " + "; ".join(why))
            dt_xla = _common.timed(lambda: vq_cuda.vq_lookup_reference(z, e), OP_ITERS,
                                   device, OP_WARMUP)
            dt_pl = _common.timed(lambda: vq_cuda.vq_lookup_fused(z, e), OP_ITERS,
                                  device, OP_WARMUP)
            print(json.dumps({
                "bench": "vq_op", "n": n, "k": k, "d": D, "tile_n": None,
                "xla_us": round(dt_xla * 1e6, 1),
                "pallas_us": round(dt_pl * 1e6, 1),
                "speedup": round(dt_xla / dt_pl, 2),
            }), flush=True)
            del z, e

    # --- the flagship train step -----------------------------------------
    results = {}
    for use_pallas in (False, True):
        cfg = step_config(use_pallas, batch_sz, n_win)
        spec = ae.make_window_spec(cfg)
        model = ae.init(cfg, torch.Generator().manual_seed(0), device)
        opt = chassis.Adam(model.named_parameters(), cfg.train)
        wav = torch.as_tensor(rng.integers(-8000, 8000, (batch_sz, spec.u_len)),
                              dtype=torch.int16, device=device)
        spk = torch.as_tensor(rng.integers(0, cfg.wavenet.n_speakers, (batch_sz,)),
                              device=device)

        def step():
            return chassis.train_step(model, opt, cfg, spec, wav, spk, 0)

        dt = _common.timed(step, TRAIN_ITERS, device, TRAIN_WARMUP)
        sps = batch_sz * n_win / dt
        results["pallas" if use_pallas else "xla"] = sps
        print(json.dumps({
            "bench": "train_step", "vq_use_pallas": use_pallas,
            "batch": batch_sz, "n_win": n_win,
            "step_ms": round(dt * 1e3, 2),
            "samples_per_sec_per_chip": round(sps, 1),
        }), flush=True)
        del model, opt

    print(json.dumps({
        "bench": "decision",
        "pallas_over_xla": round(results["pallas"] / results["xla"], 4),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
