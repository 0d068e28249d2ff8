"""What the benchmark loads and where it runs: no JAX and no JAX package
in a run (compared by whole top-level names, since the port's name begins
with the JAX package's), nothing of the program in the reference, and no
result without a card or outside a checkout."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT


@pytest.mark.parametrize("modules,found", [
    (["ae_wavenet_tpu_torch", "ae_wavenet_tpu_torch.ops.fastgen", "jaxtyping", "flaxen"], []),
    (["ae_wavenet_tpu.ops.gated_pallas"], ["ae_wavenet_tpu.ops.gated_pallas"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]),
])
def test_forbidden_modules_compares_whole_top_level_names(modules, found):
    assert harness.forbidden_modules(modules) == found


def _python(code: str, cwd=ROOT, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **env})


def test_the_reference_and_the_yardstick_load_nothing_of_the_program():
    r = _python(
        "import sys, json\n"
        "import benchmark.reference.models, benchmark.reference.train, "
        "benchmark.reference.data, benchmark.reference.precision, benchmark.reference.sampling\n"
        "import benchmark.counts, benchmark.peaks, benchmark.traffic, benchmark.trace\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('ae_wavenet_tpu_torch', 'ae_wavenet_tpu', 'jax', 'jaxlib', 'flax'))))")
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process: the program, its plain versions
    and the reference leave no JAX module behind."""
    code = (
        "import sys, pathlib, json\n"
        "import torch; torch.set_num_threads(1)\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        f"root = tiny.make_root(pathlib.Path({str(tmp_path)!r}))\n"
        "man, run = tiny.open_run(root, tiny.TRAIN)\n"
        "res = harness.execute(man, run, root)\n"
        "print(json.dumps([res['correct'], harness.forbidden_modules(sys.modules)]))\n")
    r = _python(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [True, []]


def _run_py(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "train.chorowski_vq.b4x48k", "--seed", "2147483649", "--seconds",
                           "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_result_without_a_card():
    r = _run_py(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_no_result_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run_py(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
