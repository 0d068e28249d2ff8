"""Convergence A/B: the flagship-dims VQ config trained on the plain
PyTorch gated stack and on the hand-written one, from identical init on
identical batches: the adoption gate for the hand-written stack beyond
the kernels' checks and its speed.

Counterpart of the JAX package's ``scripts/convergence_ab.py``, its two
arms mapped onto the port: "xla" is ``use_pallas_stack=False`` (the plain
bf16 stack of ``models/wavenet.apply``), "pallas" the hand-written
kernels (K1 forward and K2 backward on layer pairs, ``csrc/gated.cu``).
Both arms draw the same initial weights, batches and random draws (one
seed).  The gate: the mean |recon CE difference| over the steps at most
``MEAN_LIMIT`` and the largest at most ``MAX_LIMIT`` (the TPU's reading,
``BASELINE.md``: 0.0072-0.0089 and 0.036-0.061); outside either the
record is printed and the script returns 1.

    python -m ae_wavenet_tpu_torch.scripts.convergence_ab [--steps 40] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import io
import json
import os
import tempfile

from ae_wavenet_tpu_torch.scripts import _common

MEAN_LIMIT = 0.03
MAX_LIMIT = 0.15


def run_config(steps: int):
    """The flagship VQ config at B = 8 x 8,000, lr 4e-4, aux weight 1.0,
    a log point every step."""
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, RunConfig,
                                                   TrainConfig)

    return RunConfig(
        bottleneck=BottleneckConfig(kind="vq"),
        train=TrainConfig(batch_sz=8, n_win=8000, n_steps=steps, log_every=1,
                          learning_rate=4e-4, aux_frame_weight=1.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.training.chassis import Chassis

    device = _common.setup(a.device)
    base = run_config(a.steps)
    spec = ae.make_window_spec(base)
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "synth")
        make_synthetic_dataset(prefix, n_clips=8, n_speakers=4,
                               clip_len=(spec.u_len + 1000, spec.u_len + 30000))
        out = {}
        for name, flag in [("xla", False), ("pallas", True)]:
            cfg = dc.replace(base, wavenet=dc.replace(base.wavenet,
                                                      use_pallas_stack=flag))
            ch = Chassis(cfg, prefix, device=device, log_stream=io.StringIO())
            hist = ch.train(a.steps)
            ch.close()
            out[name] = [round(h["recon_ce"], 4) for h in hist]
        diffs = [abs(x - y) for x, y in zip(out["xla"], out["pallas"])]
        rec = {
            "steps": a.steps,
            "xla_first_last": [out["xla"][0], out["xla"][-1]],
            "pallas_first_last": [out["pallas"][0], out["pallas"][-1]],
            "max_abs_ce_diff": max(diffs),
            "mean_abs_ce_diff": sum(diffs) / len(diffs),
        }
        print(json.dumps(rec))
    return 0 if (rec["mean_abs_ce_diff"] <= MEAN_LIMIT
                 and rec["max_abs_ce_diff"] <= MAX_LIMIT) else 1


if __name__ == "__main__":
    raise SystemExit(main())
