"""The vocoder cells' tiny counterparts (``conftest.py``) run whole on the
CPU: ``correct`` for the program, not for the planted faults of
``calibrate_vocoder.py``; the traced mixture run reads its layers."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate_vocoder, harness
from benchmark.tests import conftest, tiny


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, cell, fault=None, trace=False):
    root = tiny.make_root(tmp_path)
    man, run = tiny.open_run(root, cell, seed=2**31 + 11, trace=trace)
    if fault is None:
        return run, harness.execute(man, run, root)
    with getattr(calibrate_vocoder, fault)():
        return run, harness.execute(man, run, root)


@pytest.mark.parametrize("cell,fault", [
    (conftest.MOL, None), (conftest.MOL, "component_altered"),
    (conftest.MOL, "sample_altered"),
    (conftest.INVERTER_TRAIN, None), (conftest.INVERTER_TRAIN, "half_batch"),
    (conftest.INVERTER_TRAIN, "step_left_out")])
def test_the_vocoder_cells_hold_the_program_and_refuse_its_faults(tmp_path, cell, fault):
    run, res = _run(tmp_path, cell, fault)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["correct"] is (fault is None), res["checks"]
    want = ({"mix_gap", "value_gap", "clipped_share"} if cell == conftest.MOL
            else {"grad_gap", "grad_diff", "change_gap"})
    assert set(res["checks"]) == want


def test_the_traced_mixture_cell_reads_its_layers(tmp_path):
    run, res = _run(tmp_path, conftest.MOL, trace=True)
    assert res["correct"] is True, res["checks"]
    # on the CPU the plain sampler streams nothing, and the window keeps
    # the unclipped readings beside the checks
    assert run.window["streamed_mb_a_step"] == 0.0
    assert set(run.window["not_compared"]) == {"mix_gap_unclipped", "value_gap_unclipped"}


def test_every_cell_of_the_manifest_has_a_tiny_counterpart():
    real = {w["name"] for w in harness.manifest()["workloads"]}
    assert real == {r for _, _, r in tiny.CELLS.values()}
