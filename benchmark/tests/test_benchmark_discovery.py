"""A configuration, a traffic mix, a cell and a per-layer metric are added
by new files and manifest entries alone: in a copy of the benchmark, with
no file that is there edited, the harness finds them and runs the cell."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_new_configuration_traffic_cell_and_metric_by_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "benchmark").rglob("*") if p.is_file()}
    doc = json.loads((root / "benchmark/configs/tiny_vq.json").read_text())
    doc["wavenet"]["n_block_layers"] = 4
    (root / "benchmark/configs/tiny_vq4.json").write_text(json.dumps(doc))
    tr = dict(tiny.TRAFFIC["tiny_serve"], greedy_every=1, max_requests=2)
    (root / "benchmark/traffic/tiny_greedy.json").write_text(json.dumps(tr))
    (root / "benchmark/limits/tiny.greedy.json").write_text(json.dumps(tiny.LIMITS["serve"]))
    (root / "benchmark/metrics/gen_steps.greedy.py").write_text(
        '"""Generated samples a request."""\n\n\ndef read(run):\n'
        '    w = run.window\n    return w["gen_samples"] / w["requests"]\n')
    man = harness.manifest(root)
    man["configs"].append({"name": "tiny_vq4", "source": "https://arxiv.org/abs/1901.08810",
                           "file": "benchmark/configs/tiny_vq4.json", "reduced": [],
                           "why": "four layers"})
    man["workloads"].append({"name": "tiny.greedy", "config": "tiny_vq4",
                             "traffic": "tiny_greedy", "chips": 1, "why": "greedy"})
    for m in man["end_to_end"]:
        if m["name"] == "request_s":
            m["workloads"].append("tiny.greedy")
    man["per_layer"].append({"name": "gen_steps.greedy", "unit": "samples", "better": "higher",
                             "source": "program_counter", "layer": "Sampler",
                             "moves": "request_s", "workloads": ["tiny.greedy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "benchmark").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing that was there changed

    man, run = tiny.open_run(root, "tiny.greedy", trace=True)
    assert run.traffic["greedy_every"] == 1 and run.config_doc["wavenet"]["n_block_layers"] == 4
    res = harness.execute(man, run, root)
    assert res["correct"] is True
    assert res["metrics"]["gen_steps.greedy"]["value"] == 2 * tiny.TRAFFIC["tiny_serve"][
        "gen_samples"]
    assert [m["name"] for m in harness.metrics_for(man, "tiny.greedy", False)] == [
        "request_s", "setup_s"]
