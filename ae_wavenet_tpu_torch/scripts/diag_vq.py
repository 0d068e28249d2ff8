"""Diagnose VQ codebook collapse at the flagship dims.

Counterpart of the JAX package's ``scripts/diag_vq.py``.  Tells the two
candidate causes apart:
  (a) the encoder's output cloud is tiny from the start (scale or init), or
  (b) training shrinks it (posterior collapse: the decoder's
      autoregressive capacity suffices on this data, so commitment wins).

It also trains an AE-bottleneck twin (continuous conditioning, the upper
bound) and a ZERO-bottleneck twin (no conditioning, the pure-AR baseline)
on the same batches: conditioning gain = zero CE - ae CE.  A gain of ~0
means the fixture is AR-predictable and collapse is optimal; a real gain
with a collapsed VQ points at the VQ's dynamics.

    python -m ae_wavenet_tpu_torch.scripts.diag_vq --steps 300 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ae_wavenet_tpu_torch.scripts import _common


@torch.no_grad()
def latents(ch, batch) -> np.ndarray:
    """The encoder's f32 latents of a (wav, speaker) batch, one row per
    frame: [B*T, D], rows ordered (b, t)."""
    from ae_wavenet_tpu_torch.audio.mfcc import mfcc_delta_stack
    from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float
    from ae_wavenet_tpu_torch.models.common import normalize_frames

    cfg, spec = ch.cfg, ch.spec
    wav = int16_to_float(torch.from_numpy(batch[0]).to(ch.device))
    frames = mfcc_delta_stack(wav[..., spec.fb : spec.fe], cfg.spec)
    z = ch.model.encoder(normalize_frames(frames, spec=cfg.spec))
    b, d, t = z.shape
    return z.permute(0, 2, 1).reshape(b * t, d).float().cpu().numpy()


def nearest(zf: np.ndarray, e: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """-> (squared distances [N, K] of the rows of zf to the codes e,
    nearest code per row)."""
    d2 = (zf**2).sum(1, keepdims=True) - 2.0 * zf @ e.T + (e**2).sum(1)[None, :]
    return d2, d2.argmin(1)


def cloud_stats(ch, batch) -> dict:
    """Encoder-output cloud and codebook geometry on one batch."""
    zf = latents(ch, batch)
    out = {
        "n_frames": int(zf.shape[0]),
        "frame_norm_mean": float(np.linalg.norm(zf, axis=1).mean()),
        "cloud_rms_spread": float(np.sqrt(((zf - zf.mean(0)) ** 2).sum(1).mean())),
        "per_dim_std_mean": float(zf.std(0).mean()),
    }
    bn = dict(ch.model.bottleneck.named_buffers())
    if "codebook" in bn:
        e = bn["codebook"].float().cpu().numpy()
        ema = bn["ema_counts"].float().cpu().numpy()
        d2, idx = nearest(zf, e)
        counts = np.bincount(idx, minlength=e.shape[0]).astype(np.float64)
        p = counts / counts.sum()
        nz = p[p > 0]
        out.update(
            codebook_rms_spread=float(np.sqrt(((e - e.mean(0)) ** 2).sum(1).mean())),
            nearest_d2_mean=float(d2.min(1).mean()),
            batch_perplexity=float(np.exp(-(nz * np.log(nz)).sum())),
            batch_codes_used=int((counts > 0).sum()),
            ema_counts_max=float(ema.max()),
            ema_counts_gt_thresh=int((ema > ch.cfg.bottleneck.vq_restart_thresh).sum()),
        )
    return out


def twin_config(kind: str, a):
    """The flagship dims with the fused stack and bottleneck ``kind``, B =
    4 x 48,000, every 5th clip held out (``a``: the parsed flags)."""
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, RunConfig,
                                                   TrainConfig, WaveNetConfig)

    return RunConfig(
        bottleneck=BottleneckConfig(kind=kind, ema_decay=a.ema_decay,
                                    vq_warmup_steps=a.vq_warmup),
        wavenet=WaveNetConfig(use_pallas_stack=True),
        train=TrainConfig(batch_sz=4, n_win=48000, n_steps=a.steps, log_every=50,
                          ckpt_every=0, holdout_every=5, steps_per_call=4,
                          aux_frame_weight=a.aux_weight))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workdir", default=_common.workdir("long_run"))
    ap.add_argument("--skip-ae", action="store_true")
    ap.add_argument("--aux-weight", type=float, default=0.0)
    ap.add_argument("--ema-decay", type=float, default=0.99)
    ap.add_argument("--vq-warmup", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    from ae_wavenet_tpu_torch.training.chassis import Chassis

    device = _common.setup(a.device)
    os.makedirs(a.workdir, exist_ok=True)
    prefix = _common.fixture(os.path.join(a.workdir, "synth32"))

    def run(kind: str) -> float:
        ch = Chassis(twin_config(kind, a), prefix, ckpt_dir=None, device=device,
                     log_stream=sys.stdout)
        batch = ch.sampler.batch_at(0)
        if kind == "vq":
            print(json.dumps({"at": "init", **cloud_stats(ch, batch)}), flush=True)
        ch.train(a.steps)
        if kind == "vq":
            print(json.dumps({"at": f"step{a.steps}", **cloud_stats(ch, batch)}),
                  flush=True)
        ev = ch.evaluate()
        ch.close()
        print(json.dumps({"kind": kind, "final_eval_recon_ce": float(ev["recon_ce"])}),
              flush=True)
        return float(ev["recon_ce"])

    ce = {"vq": run("vq")}
    if not a.skip_ae:
        ce["ae"] = run("ae")
        ce["zero"] = run("zero")
        print(json.dumps({
            "summary": ce,
            "conditioning_gain_nats": round(ce["zero"] - ce["ae"], 4),
            "vq_gap_to_continuous": round(ce["vq"] - ce["ae"], 4),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
