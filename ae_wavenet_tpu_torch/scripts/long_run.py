"""Sustained flagship training on the card: thousands of steps of the
shipped configuration (B = 4 x 48,000, VQ-EMA, the fused gated stack,
bf16) with holdout eval, checkpoints and codebook-health logging.

    python -m ae_wavenet_tpu_torch.scripts.long_run --steps 2000 \\
        [--out run.jsonl] [--device cuda]

Counterpart of the JAX package's ``scripts/long_run.py``, flag for flag
and record for record.  Writes the JSONL metric stream (train CE, grad
norm, perplexity, restarts, samples/s, and eval CE on the held-out clip
split every ``--eval-every`` steps) and ends with the free-running quality
probe (free NLL, teacher NLL, log-mel spectral distance) on four held-out
clips batched into one rollout, at the final step or every
``--quality-every`` steps.  The audio is the reference's synthetic
speech-like fixture (``data/preprocess.make_synthetic_dataset``, byte for
byte the JAX package's), so a run here is comparable with the reference's
records under ``docs/``: the same windows from (seed, step), the same
constant learning rate; only the initial weights and the random streams
of jitter and restarts differ.  ``--out`` defaults to ``long_run.jsonl``
in ``--workdir``.  Beside the reference's keys, each probe record has
``probe_s`` (the probe's seconds) and the run's last record
``median_samples_per_sec`` (the training rate: the median over the log
points after the first).  ``--tiny`` runs the whole script at the tiny
width (``--device cpu`` runs it without a card).
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import statistics
import time

from ae_wavenet_tpu_torch.scripts import _common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-sz", type=int, default=4)
    ap.add_argument("--n-win", type=int, default=48000)
    ap.add_argument("--steps-per-call", type=int, default=8)
    ap.add_argument("--eval-every", type=int, default=200)
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="retention: keep the newest N checkpoints plus the "
                         "best-holdout one (0 = keep all)")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--data", default=None,
                    help="packed dataset prefix (default: the reference's "
                         "synthetic fixture under --workdir)")
    ap.add_argument("--clips", type=int, default=32,
                    help="synthetic fixture size (ignored with --data)")
    ap.add_argument("--speakers", type=int, default=8)
    ap.add_argument("--fixture", choices=("v2", "v3"), default="v2",
                    help="synthetic fixture style: v2 = smooth random-walk "
                         "modulation; v3 = hard sample-and-hold innovations "
                         "(the conditioning-gain fixture)")
    ap.add_argument("--bottleneck", choices=("vq", "vae", "ae", "zero"),
                    default="vq",
                    help="bottleneck kind; 'zero' is the pure-AR ablation "
                         "twin (conditioning gain = zero CE - conditioned CE)")
    ap.add_argument("--vq-k", type=int, default=512)
    ap.add_argument("--vq-groups", type=int, default=1,
                    help="grouped (product) VQ codebooks; G > 1 takes the "
                         "plain VQ path")
    ap.add_argument("--latent-hz", type=int, choices=(50, 100), default=50,
                    help="latent frame rate: 100 removes the encoder's "
                         "stride 2, doubling the VQ information ceiling "
                         "(ln(K) nats per latent)")
    ap.add_argument("--workdir", default=_common.workdir("long_run"))
    ap.add_argument("--out", default=None,
                    help="JSONL record (appended; default "
                         "WORKDIR/long_run.jsonl)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--quality-samples", type=int, default=16000)
    ap.add_argument("--quality-every", type=int, default=0,
                    help=">0: score free-running quality on the holdout "
                         "clips every N steps (must be a multiple of "
                         "--steps-per-call)")
    ap.add_argument("--aux-weight", type=float, default=1.0,
                    help="latent->MFCC aux loss weight (keeps the VQ "
                         "codebook alive)")
    ap.add_argument("--tiny", action="store_true",
                    help="the whole script at the tiny width")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    import numpy as np
    import torch

    from ae_wavenet_tpu_torch.data.dataset import PackedDataset
    from ae_wavenet_tpu_torch.eval.quality import QUALITY_KEYS, free_running_report
    from ae_wavenet_tpu_torch.training.chassis import Chassis
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, TrainConfig,
                                                   tiny_config)

    device = _common.setup(a.device)
    os.makedirs(a.workdir, exist_ok=True)
    prefix = a.data
    if prefix is None:
        suffix = "" if a.fixture == "v2" else f"_{a.fixture}"
        prefix = os.path.join(a.workdir, f"synth{a.clips}{suffix}")
        if a.tiny:
            _common.fixture(prefix, a.fixture, n_clips=8, n_speakers=4,
                            clip_len=(14000, 20000))
        else:
            _common.fixture(prefix, a.fixture, n_clips=a.clips, n_speakers=a.speakers)
    # a resume continues on the data it trained on: the resolved prefix is
    # recorded in the workdir and checked on --resume (a --resume without
    # the original --clips/--fixture would resolve another fixture)
    meta_path = os.path.join(a.workdir, "run_meta.json")
    if a.resume:
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except OSError:
            meta = None
        if meta is not None and meta.get("data_prefix") != prefix:
            raise SystemExit(
                f"--resume data mismatch: this workdir trained on "
                f"{meta.get('data_prefix')!r} but the current flags resolve "
                f"to {prefix!r}; pass the original --clips/--fixture/--data")
    else:
        with open(meta_path, "w") as f:
            json.dump({"data_prefix": prefix, "clips": a.clips,
                       "speakers": a.speakers, "fixture": a.fixture,
                       "bottleneck": a.bottleneck}, f)

    # the zero ablation has no latent, so the aux head (a latent->MFCC
    # probe) means nothing there
    aux_w = 0.0 if a.bottleneck == "zero" else a.aux_weight

    def make_bn(n_dim: int, vq_k: int) -> BottleneckConfig:
        extra = {}
        if a.bottleneck == "vae":
            # diag_vae's protocol: free bits, KL annealed over half the run
            extra = dict(free_nats=0.1, kl_anneal_steps=a.steps // 2)
        return BottleneckConfig(kind=a.bottleneck, n_dim=n_dim, vq_k=vq_k,
                                vq_groups=a.vq_groups, **extra)

    if a.tiny:
        cfg = tiny_config()
        cfg = dc.replace(
            cfg, bottleneck=make_bn(16, min(a.vq_k, 32)),
            train=dc.replace(cfg.train, n_steps=a.steps, log_every=a.log_every,
                             ckpt_every=a.ckpt_every, ckpt_keep=a.ckpt_keep,
                             holdout_every=5, steps_per_call=a.steps_per_call,
                             aux_frame_weight=aux_w))
    else:
        cfg = _common.flagship_config(
            make_bn(64, a.vq_k),
            TrainConfig(batch_sz=a.batch_sz, n_win=a.n_win, n_steps=a.steps,
                        log_every=a.log_every, ckpt_every=a.ckpt_every,
                        ckpt_keep=a.ckpt_keep, holdout_every=5,
                        steps_per_call=a.steps_per_call, aux_frame_weight=aux_w),
            a.latent_hz)
    k = max(1, cfg.train.steps_per_call)
    if a.quality_every > 0 and (a.quality_every % k or a.steps % k):
        # fail before training: Chassis.train checks each block, so a bad
        # tail block would raise after the run and lose its save and probe
        raise SystemExit(
            f"--quality-every {a.quality_every} and --steps {a.steps} must "
            f"both be multiples of --steps-per-call {k}")

    out = a.out if a.out is not None else os.path.join(a.workdir, "long_run.jsonl")
    with open(out, "a", buffering=1) as log_f:
        log_f.write(json.dumps({"run_config": "flagship", "steps": a.steps,
                                "batch": a.batch_sz, "n_win": a.n_win,
                                "bottleneck": a.bottleneck, "fixture": a.fixture,
                                "vq_k": a.vq_k, "vq_groups": a.vq_groups,
                                "latent_hz": a.latent_hz, "clips": a.clips,
                                "data_prefix": prefix, "t_start": time.time()})
                    + "\n")
        ch = Chassis(cfg, prefix, ckpt_dir=os.path.join(a.workdir, "ckpt"),
                     device=device, log_stream=log_f)
        if a.resume:
            print("resumed at", ch.resume(), flush=True)

        ds = PackedDataset(prefix)
        hold = [i for i in range(len(ds)) if i % 5 == 0]
        # four holdout clips in one rollout: one clip's free-running metrics
        # vary widely from probe to probe, and the sampler is batched
        clips = hold[:4]
        t_common = min(min(int(ds.lengths[c]) for c in clips), 64000)
        q_wav = torch.from_numpy(np.stack([ds.clip(c, t_common) for c in clips]))
        q_spk = torch.from_numpy(ds.speakers[clips].astype(np.int64))

        def quality_probe(**extra):
            """Free-running quality on the holdout clips at the current
            weights; ``extra`` joins the record."""
            t_probe = time.time()
            rep = free_running_report(ch.model, ch.cfg, q_wav.to(device),
                                      q_spk.to(device), torch.Generator().manual_seed(0),
                                      n_samples=a.quality_samples)
            q = {k: round(float(rep[k]), 4) for k in QUALITY_KEYS}
            q["clips"] = clips
            q["n_scored"] = int(rep["n_scored"])
            rec = {"quality_holdout": q, "step": ch.step,
                   "probe_s": round(time.time() - t_probe, 1), **extra}
            print(json.dumps(rec), flush=True)
            log_f.write(json.dumps(rec) + "\n")

        t0 = time.time()
        preempted = False
        history: list[dict] = []
        if a.quality_every > 0:
            # the quality-vs-steps curve: train in blocks, probe between them
            while ch.step < a.steps:
                history += ch.train(min(a.quality_every, a.steps - ch.step),
                                    eval_every=a.eval_every)
                quality_probe()
                if ch.preempted:
                    # train() saved and returned on SIGTERM/SIGINT (also in a
                    # range's last block, where the step count looks complete)
                    preempted = True
                    break
        else:
            history = ch.train(a.steps - ch.step, eval_every=a.eval_every)
            preempted = ch.preempted
        wall = time.time() - t0
        path = ch.save()
        print(f"trained to step {ch.step} in {wall:.0f}s, saved {path}", flush=True)
        # the training rate: the median over the log points after the first
        # (whose interval holds the warm-up: the kernels' build, first launches)
        rates = [r["samples_per_sec"] for r in history[1:]]
        final = {"wall_s": round(wall, 1)}
        if rates:
            final["median_samples_per_sec"] = round(statistics.median(rates), 1)
        if a.quality_every <= 0:
            quality_probe(**final)
        else:
            log_f.write(json.dumps({"step": ch.step, **final, "done": not preempted,
                                    "preempted": preempted}) + "\n")
        ch.close()
    return 1 if preempted else 0


if __name__ == "__main__":
    raise SystemExit(main())
