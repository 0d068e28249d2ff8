"""The harness: the manifest, the parts found by name, and one run's
context.

``BENCHMARK.json`` names every configuration, traffic mix, cell and
metric.  Each is found by its name alone, so a later change adds one by
adding files and entries, never by editing a file here:

* a configuration is ``configs/<name>.json`` (the manifest's ``file``): the
  program's ``RunConfig`` JSON with ``source``, ``reduced`` and ``assumed``;
* a traffic mix is ``traffic/<name>.json``: ``loop`` names the loop
  ``loops/<loop>.py`` and the rest are its parameters;
* a metric is ``metrics/<name>.py`` with ``read(run) -> float | None``;
* a cell's correctness limits are ``limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ae_wavenet_tpu")


def manifest(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def by_name(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: pathlib.Path, name: str):
    """Import the file at ``path`` as module ``name`` (metric files carry
    dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, flax's
    or the JAX package's."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def metrics_for(man: dict, cell: str, trace: bool) -> list:
    """The manifest's metrics this cell reports: its end-to-end metrics
    without ``--trace``, its per-layer metrics with it."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


@dataclasses.dataclass
class Check:
    """One number compared against its limit (it passes at or under it)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what the loop and the trace
    leave for the metric readers."""
    cell: dict
    config_doc: dict        # the configuration file as read
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace_on: bool
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    tmp: str = dataclasses.field(default_factory=lambda: os.environ.get("TMPDIR", "/tmp"))
    # filled by the loop
    setup_s: float | None = None
    window: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    checks: list = dataclasses.field(default_factory=list)
    trace: object = None
    counts: dict = dataclasses.field(default_factory=dict)
    peak: dict | None = None
    device_kind: str = "cpu"
    device_count: int = 0

    def mark(self, part: str) -> None:
        """Seconds since the process started, under ``part`` of the set-up
        (printed on standard error beside ``setup_s``)."""
        self.window.setdefault("setup_parts", {})[part] = time.perf_counter() - self.t_start

    def config_json(self, overrides: dict | None = None) -> str:
        """The configuration as it is run: the file's groups with this
        run's seed and the traffic's training-job keys."""
        doc = {k: v for k, v in self.config_doc.items()
               if k not in ("source", "reduced", "assumed")}
        train = dict(doc["train"], seed=int(self.seed))
        for k in ("batch_sz", "n_win", "steps_per_call"):
            if k in self.traffic:
                train[k] = self.traffic[k]
        doc["train"] = {**train, **(overrides or {})}
        return json.dumps(doc)


def open_run(man: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             root: pathlib.Path = ROOT, device: str = "cuda") -> Run:
    cell = by_name(man["workloads"], cell_name, "workload")
    conf = by_name(man["configs"], cell["config"], "config")
    with open(root / conf["file"]) as f:
        config_doc = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / "benchmark" / "limits" / f"{cell_name}.json") as f:
        limits = json.load(f)
    return Run(cell=cell, config_doc=config_doc, traffic=traffic, limits=limits,
               seed=seed, seconds=seconds, trace_on=trace, device=device)


def loop_of(run: Run, root: pathlib.Path = ROOT):
    name = run.traffic["loop"]
    return load_module(root / "benchmark" / "loops" / f"{name}.py", f"bench_loop_{name}")


def read_metrics(man: dict, run: Run, root: pathlib.Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of the cell's metrics whose reader finds
    something to read."""
    out = {}
    for m in metrics_for(man, run.cell["name"], run.trace_on):
        mod = load_module(root / "benchmark" / "metrics" / f"{m['name']}.py",
                          "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def execute(man: dict, run: Run, root: pathlib.Path = ROOT) -> dict:
    """Drive the cell's loop, read its metrics and make the result line's
    object; raises ``ForbiddenModules`` where JAX or the JAX package was
    loaded meanwhile."""
    loop_of(run, root).run(run)
    metrics = read_metrics(man, run, root)
    bad = forbidden_modules(sys.modules)
    if bad:
        raise ForbiddenModules(f"modules of JAX or the JAX package were loaded: {bad}")
    device = {"platform": "gpu" if run.device_count else "cpu", "kind": run.device_kind,
              "count": run.device_count, "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": bool(run.checks) and all(c.ok for c in run.checks),
              "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return result


class ForbiddenModules(RuntimeError):
    pass
