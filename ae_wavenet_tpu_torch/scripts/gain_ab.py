"""Conditioning-gain A/B: does the autoencoder beat a pure-AR decoder?

Counterpart of the JAX package's ``scripts/gain_ab.py``.  The system's
reason to exist (latents that carry information the decoder uses),
reduced to one measured number per bottleneck:

    gain = holdout_recon_CE(zero twin) - holdout_recon_CE(bottleneck twin)

with every twin trained on identical batches (the same seed, so the same
``batch_at(step)``) at the flagship dims.  For VQ the gain is bounded by
the bottleneck's channel capacity,

    gain_vq <= latent_rate * G * ln(K) / sample_rate     [nats/sample],

0.0195 at the flagship config (50 Hz, K = 512, G = 1); the record gives
the measured gain beside that ceiling.

    python -m ae_wavenet_tpu_torch.scripts.gain_ab --fixture v3 --steps 2000 \\
        --bottlenecks zero,ae,vq [--clips 32] [--out gain.jsonl] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from ae_wavenet_tpu_torch.scripts import _common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--fixture", choices=("v2", "v3"), default="v3")
    ap.add_argument("--clips", type=int, default=32)
    ap.add_argument("--speakers", type=int, default=8)
    ap.add_argument("--bottlenecks", default="zero,ae,vq")
    ap.add_argument("--vq-k", type=int, default=512)
    ap.add_argument("--vq-groups", type=int, default=1,
                    help="grouped (product) VQ: multiplies the information "
                         "ceiling by G")
    ap.add_argument("--latent-hz", type=int, choices=(50, 100), default=50)
    ap.add_argument("--batch-sz", type=int, default=4)
    ap.add_argument("--n-win", type=int, default=48000)
    ap.add_argument("--steps-per-call", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-batches", type=int, default=16,
                    help="holdout eval batches per twin (identical across "
                         "twins; more = tighter CE estimate)")
    ap.add_argument("--workdir", default=_common.workdir("gain_ab"))
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--tiny", action="store_true",
                    help="the whole protocol at the tiny width")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    import dataclasses as dc

    from ae_wavenet_tpu_torch.training.chassis import Chassis
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, RunConfig,
                                                   TrainConfig, tiny_config)

    device = _common.setup(a.device)
    os.makedirs(a.workdir, exist_ok=True)
    suffix = "" if a.fixture == "v2" else f"_{a.fixture}"
    prefix = os.path.join(a.workdir, f"synth{a.clips}{suffix}")
    if a.tiny:
        _common.fixture(prefix, a.fixture, n_clips=8, n_speakers=4,
                        clip_len=(14000, 20000))
    else:
        _common.fixture(prefix, a.fixture, n_clips=a.clips, n_speakers=a.speakers)

    out_f = open(a.out, "a", buffering=1) if a.out else None

    def emit(rec: dict) -> None:
        print(json.dumps(rec), flush=True)
        if out_f:
            out_f.write(json.dumps(rec) + "\n")

    def make_cfg(kind: str) -> RunConfig:
        aux_w = 0.0 if kind == "zero" else 1.0
        extra = {}
        if kind == "vae":
            extra = dict(free_nats=0.1, kl_anneal_steps=a.steps // 2)
        if a.tiny:
            cfg = tiny_config()
            return dc.replace(
                cfg,
                bottleneck=BottleneckConfig(kind=kind, n_dim=16, vq_k=min(a.vq_k, 32),
                                            vq_groups=a.vq_groups, **extra),
                train=dc.replace(cfg.train, n_steps=a.steps, log_every=50,
                                 ckpt_every=0, holdout_every=5, seed=a.seed,
                                 steps_per_call=a.steps_per_call,
                                 aux_frame_weight=aux_w))
        return _common.flagship_config(
            BottleneckConfig(kind=kind, vq_k=a.vq_k, vq_groups=a.vq_groups, **extra),
            TrainConfig(batch_sz=a.batch_sz, n_win=a.n_win, n_steps=a.steps,
                        log_every=50, ckpt_every=0, holdout_every=5, seed=a.seed,
                        steps_per_call=a.steps_per_call, aux_frame_weight=aux_w),
            a.latent_hz)

    def run(kind: str) -> dict:
        t0 = time.time()
        ch = Chassis(make_cfg(kind), prefix, ckpt_dir=None, device=device,
                     log_stream=sys.stdout)
        ch.train(a.steps)
        ev = ch.evaluate(n_batches=a.eval_batches)
        ch.close()
        # sorted, as the reference's metrics dict comes back from jit
        return {"kind": kind, "steps": a.steps,
                "eval": {k: round(float(v), 5) for k, v in sorted(ev.items())
                         if k != "split"},
                "wall_s": round(time.time() - t0, 1)}

    try:
        kinds = [k for k in a.bottlenecks.split(",") if k]
        sr = 16000
        header = {
            "gain_ab": {"fixture": a.fixture, "clips": a.clips, "steps": a.steps,
                        "seed": a.seed, "vq_k": a.vq_k, "vq_groups": a.vq_groups,
                        "latent_hz": a.latent_hz, "kinds": kinds},
            # the VQ channel-capacity ceiling on the teacher-forced CE gain
            # (G independent codebooks carry G * ln(K) nats a latent frame)
            "vq_gain_ceiling_nats": round(
                a.latent_hz * a.vq_groups * math.log(a.vq_k) / sr, 4),
        }
        emit(header)
        ce = {}
        for kind in kinds:
            rec = run(kind)
            ce[kind] = rec["eval"]["recon_ce"]
            emit(rec)
        if "zero" in ce:
            gains = {k: round(ce["zero"] - v, 4) for k, v in ce.items() if k != "zero"}
            emit({"summary": {"recon_ce": ce, "gain_vs_zero_nats": gains,
                              "vq_gain_ceiling_nats": header["vq_gain_ceiling_nats"]}})
    finally:
        if out_f:
            out_f.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
