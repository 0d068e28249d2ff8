"""Conditioning-gain vs corpus-size trend table (round-5 headline).

A copy of the JAX package's ``scripts/gain_scaling.py`` (no jax there either),
so the port reads the records of either package without importing it.

For each corpus scale, loads the matched zero/G=1/G=4 long_run JSONLs and
prints, at a shared --max-step budget:

  - paired per-step CE differences (zero-G1, zero-G4) over the late third
    of shared holdout evals, with SE and step-wins (the noise-cancelling
    statistic from scripts/compare_runs.py / BASELINE.md "4x data"), and
  - the late-probe mean free-running spectral_l2 per arm.

The claim under test (SURVEY.md §0: latents must carry information the AR
decoder uses): the teacher-forced gain should GROW as the corpus outruns
the decoder's ability to memorize it.

Usage:
    python -m ae_wavenet_tpu_torch.scripts.gain_scaling \
      256=docs/long_run_r5_zero256_12k.jsonl,docs/long_run_r5_vq256_12k.jsonl,docs/long_run_r5_vqg4_256.jsonl \
      1024=docs/long_run_r5_zero1024.jsonl,docs/long_run_r5_vqg1_1024.jsonl,docs/long_run_r5_vqg4_1024.jsonl \
      [2048=...] [--max-step 12000] [--late-floor 0]
"""

from __future__ import annotations

import argparse
import json


def load(path: str, max_step: int) -> dict:
    # '+'-joined paths merge histories (base run + its --resume extension
    # files, which only contain the extension's records)
    evals, quality = {}, {}
    for p in path.split("+"):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                r = json.loads(line)
                step = r.get("step")
                if step is None or step > max_step:
                    continue
                if r.get("eval_split") == "holdout" and "eval_recon_ce" in r:
                    evals[step] = r["eval_recon_ce"]
                if "quality_holdout" in r:
                    quality[step] = r["quality_holdout"]
    return {"evals": evals, "quality": sorted(quality.items())}


def paired(a: dict, b: dict, late_floor: int) -> tuple[float, float, int, int, int]:
    shared = sorted(set(a) & set(b))
    late = [s for s in shared[-max(1, len(shared) // 3):] if s >= late_floor]
    d = [a[s] - b[s] for s in late]
    n = len(d)
    mean = sum(d) / n
    var = sum((x - mean) ** 2 for x in d) / max(1, n - 1)
    se = (var / n) ** 0.5
    wins = sum(1 for x in d if x > 0)
    return mean, se, wins, n, late[0]


def late_spectral(q: list, max_step: int) -> float | None:
    # mean spectral_l2 over probes in the last half of the budget
    vals = [d["spectral_l2"] for s, d in q if s > max_step // 2]
    return sum(vals) / len(vals) if vals else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scales", nargs="+",
                    help="LABEL=zero.jsonl,g1.jsonl,g4.jsonl")
    ap.add_argument("--max-step", type=int, default=12000)
    ap.add_argument("--late-floor", type=int, default=0)
    args = ap.parse_args(argv)

    hdr = (f"{'scale':<7} {'zero-G1 (SE)':>22} {'wins':>7} "
           f"{'zero-G4 (SE)':>22} {'wins':>7} "
           f"{'spec z/g1/g4':>20}")
    print(f"budget: steps <= {args.max_step}, paired late third\n")
    print(hdr)
    for spec in args.scales:
        label, _, paths = spec.partition("=")
        zp, g1p, g4p = paths.split(",")
        zero, g1, g4 = (load(p, args.max_step) for p in (zp, g1p, g4p))
        m1, se1, w1, n1, f1 = paired(zero["evals"], g1["evals"], args.late_floor)
        m4, se4, w4, n4, _ = paired(zero["evals"], g4["evals"], args.late_floor)
        sz = late_spectral(zero["quality"], args.max_step)
        s1 = late_spectral(g1["quality"], args.max_step)
        s4 = late_spectral(g4["quality"], args.max_step)
        spec_cell = ("/".join(f"{v:.1f}" if v is not None else "-"
                              for v in (sz, s1, s4)))
        print(f"{label:<7} {m1:+.4f} +/- {se1:.4f}{'':>3} {w1:>4}/{n1:<2} "
              f"{m4:+.4f} +/- {se4:.4f}{'':>3} {w4:>4}/{n4:<2} "
              f"{spec_cell:>20}   (late evals >= {f1})")

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
