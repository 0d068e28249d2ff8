"""Convergence curves of the three bottleneck families (ae, vq, vae) on
the reference's synthetic fixture at the tiny width: evidence of
end-to-end training health.

Counterpart of the JAX package's ``scripts/train_curves.py`` (the same
fixture bytes, recipe and record; ``CURVE_STEPS`` steps a family, 2,000
by default).  It runs on the card unless ``--device cpu`` is given, and
writes ``--out`` (``docs/training_curves_torch.json`` under the working
directory by default), never the reference's record
``docs/training_curves.json``.

    python -m ae_wavenet_tpu_torch.scripts.train_curves [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import io
import json
import os
import tempfile

from ae_wavenet_tpu_torch.scripts import _common

DEFAULT_OUT = os.path.join("docs", "training_curves_torch.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)
    if os.path.basename(a.out) == "training_curves.json":
        raise SystemExit(f"--out {a.out}: that name is the JAX package's record")

    from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
    from ae_wavenet_tpu_torch.training.chassis import Chassis
    from ae_wavenet_tpu_torch.utils.config import BottleneckConfig, tiny_config

    device = _common.setup(a.device)
    steps = int(os.environ.get("CURVE_STEPS", "2000"))
    out = {}
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "synth")
        make_synthetic_dataset(prefix, n_clips=12, n_speakers=4, seed=0)
        for kind, bn in [
            ("ae", BottleneckConfig(kind="ae", n_dim=16)),
            ("vq", BottleneckConfig(kind="vq", n_dim=16, vq_k=64, jitter_p=0.0)),
            ("vae", BottleneckConfig(kind="vae", n_dim=16, free_nats=0.05,
                                     kl_anneal_steps=steps // 2)),
        ]:
            cfg = tiny_config()
            cfg = dc.replace(cfg, bottleneck=bn,
                             train=dc.replace(cfg.train, batch_sz=8, n_steps=steps,
                                              log_every=max(steps // 40, 10),
                                              learning_rate=1e-3,
                                              # 5 is coprime with the 4-speaker
                                              # period, so the holdout split
                                              # spans all speakers
                                              holdout_every=5))
            ch = Chassis(cfg, prefix, device=device, log_stream=io.StringIO())
            hist = ch.train(steps)
            ev = ch.evaluate(n_batches=4)
            ch.close()
            out[kind] = {
                "steps": [h["step"] for h in hist],
                "recon_ce": [round(h["recon_ce"], 4) for h in hist],
                "extra": {k: round(hist[-1][k], 4) for k in hist[-1]
                          if k in ("perplexity", "kl", "commitment")},
                "eval_recon_ce_holdout": round(ev["recon_ce"], 4),
            }
            print(kind, "final train CE", out[kind]["recon_ce"][-1],
                  "holdout CE", out[kind]["eval_recon_ce_holdout"],
                  out[kind]["extra"], flush=True)

    if os.path.dirname(a.out):
        os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
