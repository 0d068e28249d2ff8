"""Score generated audio from a checkpoint: free-running NLL and log-mel
spectral distance on dataset clips.

    python -m ae_wavenet_tpu_torch.scripts.eval_quality --ckpt-dir DIR \\
        --data PREFIX [--step N|best] [--clips 0,1,2] [--n-samples 16000] \\
        [--json out.jsonl] [--divergence] [--device cuda]

Counterpart of the JAX package's ``scripts/eval_quality.py``: one JSON
line per clip and a summary line, with its keys.  ``--divergence`` sweeps
the sampling temperature and buckets free NLL by rollout position
(``eval/quality.divergence_report``) in place of the single-temperature
record.  The rollout is the f32 sampler (``ops/fastgen.generate``, a CUDA
graph replayed once a sample on the card).
"""

from __future__ import annotations

import argparse
import json

from ae_wavenet_tpu_torch.scripts import _common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--step", default=None,
                   help="checkpoint step (default LATEST); 'best' picks the "
                        "best-holdout checkpoint from the BEST sidecar "
                        "(runs with --ckpt-keep retention write it)")
    p.add_argument("--data", required=True)
    p.add_argument("--clips", default="0", help="comma list of clip indices")
    p.add_argument("--n-samples", type=int, default=16000)
    p.add_argument("--max-input", type=int, default=64000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", default=None, help="also append records here")
    p.add_argument("--divergence", action="store_true",
                   help="temperature sweep + free_nll-vs-position curve "
                        "(eval/quality.divergence_report) instead of the "
                        "single-temperature report")
    p.add_argument("--temperatures", default="1.0,0.9,0.8,0.0",
                   help="comma list for --divergence (0 = greedy)")
    p.add_argument("--nll-buckets", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when there is no card")
    a = p.parse_args(argv)

    import numpy as np
    import torch

    from ae_wavenet_tpu_torch.data.dataset import PackedDataset
    from ae_wavenet_tpu_torch.eval.quality import clip_quality_record, divergence_report
    from ae_wavenet_tpu_torch.models import registry
    from ae_wavenet_tpu_torch.training import checkpoint

    device = _common.setup(a.device)
    step, best = _common.pick_step(a.ckpt_dir, a.step)
    if best is not None:
        print(json.dumps({"best_checkpoint": {"step": best[0],
                                              "eval_recon_ce": best[1]}}), flush=True)
    step, model, cfg = checkpoint.load_model(a.ckpt_dir, step)
    model = model.to(device).eval()
    encode = registry.get(cfg.model_kind).encode

    ds = PackedDataset(a.data)
    records = []
    for ci in (int(x) for x in a.clips.split(",") if x):
        gen = torch.Generator().manual_seed(a.seed)
        if a.divergence:
            wav = torch.from_numpy(ds.clip(ci, a.max_input))[None].to(device)
            spk = torch.from_numpy(ds.speakers[ci : ci + 1].astype(np.int64)).to(device)
            rep = divergence_report(
                model, cfg, wav, spk, gen, n_samples=a.n_samples, encode_fn=encode,
                temperatures=tuple(float(x) for x in a.temperatures.split(",") if x),
                nll_buckets=a.nll_buckets)
            rec = {"step": step, "clip": ci, "divergence": rep}
        else:
            rec = clip_quality_record(model, cfg, ds, ci, gen, n_samples=a.n_samples,
                                      max_input=a.max_input, encode_fn=encode,
                                      step=step, device=device)
        records.append(rec)
        print(json.dumps(rec), flush=True)

    def mean(values) -> float:
        return round(float(np.mean(list(values))), 4)

    if a.divergence:
        temps = records[0]["divergence"]["temperatures"]
        summary = {
            "step": step,
            "clips": len(records),
            "teacher_nll_mean": mean(r["divergence"]["teacher_nll"] for r in records),
            "free_nll_by_temp": {
                t: mean(r["divergence"]["temperatures"][t]["free_nll"] for r in records)
                for t in temps},
            "spectral_l2_by_temp": {
                t: mean(r["divergence"]["temperatures"][t]["spectral_l2"]
                        for r in records)
                for t in temps},
        }
    else:
        summary = {
            "step": step,
            "clips": len(records),
            "free_nll_mean": mean(r["free_nll"] for r in records),
            "teacher_nll_mean": mean(r["teacher_nll"] for r in records),
            "spectral_l2_mean": mean(r["spectral_l2"] for r in records),
        }
    print(json.dumps({"summary": summary}), flush=True)
    if a.json:
        with open(a.json, "a") as f:
            for r in records + [{"summary": summary}]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
