"""VAE posterior-health diagnosis.

Counterpart of the JAX package's ``scripts/diag_vae.py``.  Trains the VAE
bottleneck and its 'zero' (no conditioning, the pure-AR baseline) and
'ae' (continuous, the upper bound) twins on the same batches and reports
the posterior health each step computes (``models/bottlenecks.py``'s VAE
metrics): KL nats per frame, active units (dims whose unfloored batch-mean
KL is above 0.02 nats) and the variance of mu, at every log point.
Posterior collapse shows as active units -> 0 with a recon CE near the
zero twin's; a healthy VAE keeps its units active and beats the zero twin
by a margin approaching the ae twin's.

    python -m ae_wavenet_tpu_torch.scripts.diag_vae --steps 300 --preset tiny --device cpu
    python -m ae_wavenet_tpu_torch.scripts.diag_vae --steps 2000 --preset flagship
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import sys

from ae_wavenet_tpu_torch.scripts import _common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", choices=("tiny", "flagship"), default="tiny")
    ap.add_argument("--workdir", default=_common.workdir("diag_vae"))
    ap.add_argument("--free-nats", type=float, default=0.1)
    ap.add_argument("--kl-anneal", type=int, default=None,
                    help="anneal steps (default: steps//2)")
    ap.add_argument("--aux-weight", type=float, default=0.0)
    ap.add_argument("--skip-twins", action="store_true")
    ap.add_argument("--json", default=None, help="append records here")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    from ae_wavenet_tpu_torch.training.chassis import Chassis
    from ae_wavenet_tpu_torch.utils.config import (RunConfig, TrainConfig,
                                                   WaveNetConfig, tiny_config)

    device = _common.setup(a.device)
    os.makedirs(a.workdir, exist_ok=True)
    anneal = a.kl_anneal if a.kl_anneal is not None else a.steps // 2
    if a.preset == "tiny":
        prefix = _common.fixture(os.path.join(a.workdir, "synth_tiny"), n_clips=8,
                                 n_speakers=4, clip_len=(12_000, 20_000))
        base = tiny_config()
        base = dc.replace(
            base, train=dc.replace(base.train, n_steps=a.steps,
                                   log_every=max(a.steps // 10, 10), ckpt_every=0,
                                   holdout_every=4, learning_rate=2e-3,
                                   aux_frame_weight=a.aux_weight))
    else:
        prefix = _common.fixture(os.path.join(a.workdir, "synth32"))
        base = RunConfig(
            wavenet=WaveNetConfig(use_pallas_stack=True),
            train=TrainConfig(batch_sz=4, n_win=48000, n_steps=a.steps, log_every=50,
                              ckpt_every=0, holdout_every=5, steps_per_call=4,
                              aux_frame_weight=a.aux_weight))
    bn_dim = base.bottleneck.n_dim

    def emit(rec):
        print(json.dumps(rec), flush=True)
        if a.json:
            with open(a.json, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def run(kind: str) -> dict:
        bn = dc.replace(base.bottleneck, kind=kind, n_dim=bn_dim,
                        free_nats=a.free_nats, kl_anneal_steps=anneal)
        ch = Chassis(dc.replace(base, bottleneck=bn), prefix, ckpt_dir=None,
                     device=device, log_stream=sys.stdout)
        hist = ch.train(a.steps)
        ev = ch.evaluate()
        ch.close()
        rec = {"kind": kind, "steps": a.steps,
               "final_eval_recon_ce": round(float(ev["recon_ce"]), 4)}
        if kind == "vae":
            last = hist[-1]
            rec.update({
                "kl_per_frame": round(float(last["kl"]), 4),
                "active_units": int(last["active_units"]),
                "n_dims": bn_dim,
                "mu_var": round(float(last["mu_var"]), 5),
                "free_nats": a.free_nats,
                "kl_anneal_steps": anneal,
                "aux_weight": a.aux_weight,
                "kl_trend": [round(float(h["kl"]), 3) for h in hist],
                "active_trend": [int(h["active_units"]) for h in hist],
            })
        emit(rec)
        return rec

    vae = run("vae")
    if not a.skip_twins:
        zero = run("zero")
        ae_rec = run("ae")
        ce = {r["kind"]: r["final_eval_recon_ce"] for r in (vae, zero, ae_rec)}
        emit({"summary": {
            "vae_conditioning_gain_nats": round(ce["zero"] - ce["vae"], 4),
            "continuous_conditioning_gain_nats": round(ce["zero"] - ce["ae"], 4),
            "vae_gap_to_continuous": round(ce["vae"] - ce["ae"], 4),
            "active_units": vae["active_units"],
            "n_dims": vae["n_dims"],
            "collapsed": vae["active_units"] == 0,
        }})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
