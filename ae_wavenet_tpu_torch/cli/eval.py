"""CLI: offline evaluation from a checkpoint directory.

    python -m ae_wavenet_tpu_torch.cli.eval --ckpt-dir CKPT --data PREFIX \
        [--n-batches 16] [--quality] [--quality-clips 0] [--device cuda] \
        [--json out.jsonl]

Reports eval-mode teacher-forced metrics (recon CE and the bottleneck's
terms, deterministic latent path, no jitter) averaged over ``--n-batches``
windows: from the held-out clip split when the checkpointed config has
``holdout_every`` set, else from unseen window offsets of the training
clips.  ``--quality`` adds the free-running generation metrics
(eval/quality.free_running_report) on the requested clips.  The config
comes from the checkpoint, as in ``cli/train.py resume``.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    from ae_wavenet_tpu_torch.utils.precision import set_reference_precision

    set_reference_precision()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--data", required=True)
    p.add_argument("--n-batches", type=int, default=16)
    p.add_argument("--quality", action="store_true",
                   help="also run free-running generation quality")
    p.add_argument("--quality-clips", default="0")
    p.add_argument("--quality-samples", type=int, default=16000)
    p.add_argument("--max-input", type=int, default=64000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when there is no card")
    p.add_argument("--json", default=None, help="append records here")
    a = p.parse_args(argv)

    import io

    import torch

    from ae_wavenet_tpu_torch.training import chassis as ch_mod
    from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    try:
        step, cfg = ckpt_mod.load_config(a.ckpt_dir, a.step)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    # through the chassis, so the eval step, the holdout split and the
    # restore checks are the training ones
    ch = ch_mod.Chassis(cfg, a.data, ckpt_dir=a.ckpt_dir, device=device,
                        log_stream=io.StringIO())
    step = ch.resume(step)
    ev = ch.evaluate(n_batches=a.n_batches)
    rec = {"step": step, "holdout": bool(cfg.train.holdout_every),
           "n_batches": a.n_batches,
           **{f"eval_{k}": round(float(v), 5) for k, v in ev.items()
              if isinstance(v, (int, float))}}
    records = [rec]
    print(json.dumps(rec), flush=True)

    if a.quality:
        from ae_wavenet_tpu_torch.eval.quality import clip_quality_record

        model = ch.model.eval()
        for ci in (int(x) for x in a.quality_clips.split(",") if x):
            qrec = clip_quality_record(
                model, ch.cfg, ch.dataset, ci, torch.Generator().manual_seed(a.seed),
                n_samples=a.quality_samples, max_input=a.max_input,
                encode_fn=ch.family.encode, step=step, device=device)
            records.append(qrec)
            print(json.dumps(qrec), flush=True)

    ch.close()
    if a.json:
        with open(a.json, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
