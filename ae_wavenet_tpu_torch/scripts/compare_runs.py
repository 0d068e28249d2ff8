"""Matched-budget comparison table across long_run JSONL records.

A copy of the JAX package's ``scripts/compare_runs.py`` (no jax there either),
so the port reads the records of either package without importing it.

The round-5 twin/three-way protocol (BASELINE.md "12k matched-budget
twins", "Grouped VQ at scale"): arms share corpus, seed, and step budget;
we compare (a) best holdout recon CE and the step it lands on, (b) the
mean over the late third of eval points (plateau robustness), and (c) the
free-running quality probes (spectral log-mel L2, teacher/free NLL) at
every matched probe step.

Usage:
    python -m ae_wavenet_tpu_torch.scripts.compare_runs LABEL=path.jsonl [LABEL=path.jsonl ...]
    python -m ae_wavenet_tpu_torch.scripts.compare_runs --max-step 6000 g1=a.jsonl g4=b.jsonl
"""

from __future__ import annotations

import argparse
import json


def load(path: str, max_step: int) -> dict:
    evals, quality = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            step = r.get("step")
            if step is None or step > max_step:
                continue
            if r.get("eval_split") == "holdout" and "eval_recon_ce" in r:
                evals.append((step, r["eval_recon_ce"]))
            if "quality_holdout" in r:
                q = r["quality_holdout"]
                quality.append((step, q))
    return {"evals": sorted(evals), "quality": sorted(quality)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+", help="LABEL=path.jsonl")
    ap.add_argument("--max-step", type=int, default=10**9)
    args = ap.parse_args(argv)

    arms = {}
    for spec in args.runs:
        label, _, path = spec.partition("=")
        if not path:
            label, path = spec, spec
        arms[label] = load(path, args.max_step)

    print(f"{'arm':<12} {'best CE':>9} {'@step':>7} {'late-mean CE':>13} {'n_eval':>7}")
    for label, d in arms.items():
        ev = d["evals"]
        if not ev:
            print(f"{label:<12} (no holdout evals <= max-step)")
            continue
        best_step, best = min(ev, key=lambda t: t[1])
        late = [ce for _, ce in ev[-max(1, len(ev) // 3):]]
        print(f"{label:<12} {best:>9.4f} {best_step:>7} "
              f"{sum(late) / len(late):>13.4f} {len(ev):>7}")

    # Paired per-step CE differences over the late third of shared evals.
    # The arms of a twin/three-way share corpus, seed, and eval protocol,
    # so the per-step difference cancels the eval-batch noise that makes
    # single-eval "best CE" snapshots unreliable (BASELINE.md "4x data").
    labels = [l for l in arms if arms[l]["evals"]]
    if len(labels) >= 2:
        maps = {l: dict(arms[l]["evals"]) for l in labels}
        shared = sorted(set.intersection(*(set(m) for m in maps.values())))
        late = shared[-max(1, len(shared) // 3):]
        if len(late) >= 2:
            print(f"\npaired per-step CE diffs, late third "
                  f"(evals >= {late[0]}, n={len(late)}):")
            for i, a in enumerate(labels):
                for b in labels[i + 1:]:
                    d = [maps[a][s] - maps[b][s] for s in late]
                    n = len(d)
                    mean = sum(d) / n
                    var = sum((x - mean) ** 2 for x in d) / (n - 1)
                    se = (var / n) ** 0.5
                    wins = sum(1 for x in d if x > 0)
                    print(f"  {a} - {b}: mean {mean:+.4f} +/- {se:.4f} (SE), "
                          f"{b}-wins {wins}/{n}")

    steps = sorted({s for d in arms.values() for s, _ in d["quality"]})
    if steps:
        print(f"\nquality probes (spectral_l2 | teacher_nll | free_nll):")
        header = "step".ljust(8) + "".join(l.ljust(26) for l in arms)
        print(header)
        for s in steps:
            row = f"{s:<8}"
            for d in arms.values():
                q = dict(d["quality"]).get(s)
                cell = (f"{q['spectral_l2']:.1f} | {q['teacher_nll']:.3f} | "
                        f"{q['free_nll']:.1f}" if q else "-")
                row += cell.ljust(26)
            print(row)

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
