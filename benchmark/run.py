"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, the kernels' build cache,
data and weights from the seed, warm-up of the cell's shapes) counts as
``setup_s``; the loop of the cell's traffic (``loops/<loop>.py``) then
measures for ``--seconds``; after the window the reference decides
``correct``.  With ``--trace 1`` a profiled sub-window follows the window
and the per-layer metrics are printed instead of the end-to-end ones.  The
numbers compared are printed last on standard error and last in the result
line.  Exits non-zero, printing no result, without the CUDA cards the
cell asks for, outside a checkout of the repository, or when JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own build directory, ``ae_wavenet_tpu_torch/_build``, is
    there already)."""
    base = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def fail(code: int, msg: str) -> None:
    sys.stderr.write(f"benchmark: {msg}\n")
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if not (ROOT / "ae_wavenet_tpu_torch").is_dir():
        fail(4, f"{ROOT} holds no ae_wavenet_tpu_torch: run from a checkout of the repository")
    _caches()
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    man = harness.manifest()
    run = harness.open_run(man, a.workload, a.seed, a.seconds, bool(a.trace))
    run.t_start = T_START

    import torch

    need = int(run.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        fail(3, f"the cell needs {need} CUDA card(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    try:
        result = harness.execute(man, run)
    except harness.ForbiddenModules as e:
        fail(5, str(e))
    sys.stderr.write(f"set-up {run.setup_s!r} s; parts {run.window.get('setup_parts')}\n")
    for k in ("prime_s", "generate_s", "reference_s"):
        if k in run.window:
            sys.stderr.write(f"{k}: {run.window[k]}\n")
    if "not_compared" in run.window:
        sys.stderr.write(f"beside the checks, not compared: {run.window['not_compared']}\n")
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name}: {c['value']!r} limit {c['limit']!r}\n")
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
