"""BENCHMARK.json against the rules its checks hold it to, and
every part it names present under ``benchmark/``."""

from __future__ import annotations

import json
import math
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E = {m["name"] for m in MAN["end_to_end"]}
CELLS = {w["name"] for w in MAN["workloads"]}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_the_allowed_keys_and_characters(kind, keys):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= {
        "configs": 24, "workloads": 24, "end_to_end": 16, "per_layer": 128}[kind]
    for e in MAN[kind]:
        assert set(e) <= keys and set(e) >= keys - {"workloads"}, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer") + (("source",) if kind == "configs" else ()):
            if k in e:
                assert _line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")


def test_metric_names_do_not_collide_across_kinds():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))


def test_end_to_end_bounds_and_sources():
    assert "setup_s" in E2E
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for w in m.get("workloads", []):
            assert w in CELLS


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for c in CELLS:
        e2e = {m["name"] for m in harness.metrics_for(MAN, c, False)}
        assert "setup_s" in e2e and len(e2e) >= 2, c
        assert harness.metrics_for(MAN, c, True), c


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    for m in MAN["per_layer"]:
        assert m["moves"] in E2E
        for c in m.get("workloads", []):
            assert c in CELLS
            assert m["moves"] in {e["name"] for e in harness.metrics_for(MAN, c, False)}, (
                m["name"], c)


def test_roofline_and_mfu_metrics_are_shares():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert len(four) <= max(1, math.floor(len(MAN["workloads"]) / 4))


def test_configurations_are_files_under_paths_and_used():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        assert c["source"].startswith("https://")
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_configuration_pairs_with_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_part_a_cell_names_is_present(cell):
    w = harness.by_name(MAN["workloads"], cell, "workload")
    assert _line(w["why"])
    tr = json.loads((ROOT / "benchmark/traffic" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "benchmark/loops" / f"{tr['loop']}.py").is_file()
    assert (ROOT / "benchmark/limits" / f"{cell}.json").is_file()
    for m in harness.metrics_for(MAN, cell, False) + harness.metrics_for(MAN, cell, True):
        assert (ROOT / "benchmark/metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_the_command_names_only_files_under_paths():
    for w in MAN["command"][1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in MAN["paths"])
            assert (ROOT / w).is_file()
