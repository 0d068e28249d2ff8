"""CLI: offline preprocessing into a packed dataset.

    python -m ae_wavenet_tpu_torch.cli.preprocess catalog.txt out_prefix
    python -m ae_wavenet_tpu_torch.cli.preprocess --synthetic out_prefix \\
        [--n-clips N] [--n-speakers S] [--seed K]

Catalog mode reads ``<speaker> <path>`` lines (``data/preprocess
.preprocess_catalog``); ``--synthetic`` writes the reference's seeded
v2 fixture (``data/preprocess.make_synthetic_dataset``).  Either way it
writes ``out_prefix.dat`` and ``out_prefix.json`` and prints one summary
line.  No torch is needed.
"""

from __future__ import annotations

import argparse

from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset, preprocess_catalog


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("catalog", nargs="?", help="file of '<speaker> <path>' lines")
    p.add_argument("out_prefix", help="output prefix for .dat/.json")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic fixture instead of reading a catalog")
    p.add_argument("--n-clips", type=int, default=10)
    p.add_argument("--n-speakers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if a.synthetic:
        idx = make_synthetic_dataset(a.out_prefix, n_clips=a.n_clips,
                                     n_speakers=a.n_speakers,
                                     sample_rate=a.sample_rate, seed=a.seed)
    else:
        if not a.catalog:
            p.error("catalog is required unless --synthetic")
        idx = preprocess_catalog(a.catalog, a.out_prefix, a.sample_rate)
    n = sum(c["length"] for c in idx["clips"])
    print(f"wrote {a.out_prefix}.dat: {len(idx['clips'])} clips, "
          f"{idx['n_speakers']} speakers, {n} samples "
          f"({n / idx['sample_rate']:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
