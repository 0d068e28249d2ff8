"""Tiny counterparts of the flow vocoder's serving cell and the mixture
vocoder's training cell, registered in ``tiny.CELLS`` at import (``tiny.py``
and ``conftest.py`` are left as the cells before them set them):
``tiny.flow`` stands for ``serve.waveglow_22k.b16``, ``tiny.mol_train``
for ``train.wavenet_mol_24k.b4x24k``.  ``tiny.make_root`` is wrapped so
that each root also holds the tiny WaveGlow's configuration and both
cells' limits.  ``benchmark/conftest.py`` imports this module, so every
test of the benchmark sees them."""

from __future__ import annotations

import json

from benchmark import harness
from benchmark.tests import conftest  # noqa: F401  (the tiny mixture vocoder's config)
from benchmark.tests import tiny

FLOW, MOL_TRAIN = "tiny.flow", "tiny.mol_train"

FLOW_WAVENET = {"n_res": 32, "n_dil": 32, "n_skp": 32, "n_block_layers": 3,
                "lc_upsample_strides": [16], "lc_upsample_filters": [64], "n_lc_in": 8,
                "n_lc_out": 8}
FLOW_SPEC = {"n_mels": 8, "win_sz": 64, "hop_sz": 16, "n_fft": 64}
FLOW_GROUP = {"n_flows": 4, "n_early_every": 2}
# the CPU's sound readings at these widths are about a tenth of these
FLOW_LIMITS = {"wave_gap": 0.01, "peak_gap": 0.02}
MOL_TRAIN_LIMITS = {"grad_gap": 0.01, "grad_diff": 0.05, "change_gap": 0.2}

tiny.TRAFFIC.setdefault("tiny_flow", {
    "loop": "vocode_flow", "batch": 3, "frames": 10, "check_rows": 2, "max_requests": 3,
    "pool": {"n_clips": 4, "clip_len": [208, 209], "n_speakers": 1, "sample_rate": 22050}})
tiny.TRAFFIC.setdefault("tiny_train_mol", {
    "loop": "train_mol", "batch_sz": 2, "n_win": 320, "steps_per_call": 2,
    "dataset": {"n_clips": 8, "clip_len": [6000, 9000], "n_speakers": 1,
                "sample_rate": 24000}})
tiny.CELLS.setdefault(FLOW, ("tiny_flow", "tiny_flow", "serve.waveglow_22k.b16"))
tiny.CELLS.setdefault(MOL_TRAIN, ("tiny_mol", "tiny_train_mol",
                                  "train.wavenet_mol_24k.b4x24k"))


def flow_config() -> dict:
    """``waveglow_22k`` at tiny widths: 4 flows of 3 layers of 32, 8 mel
    bands, a hop of 16."""
    doc = json.loads((harness.ROOT / "benchmark/configs/waveglow_22k.json").read_text())
    doc = {k: v for k, v in doc.items() if k not in ("source", "reduced", "assumed")}
    doc["wavenet"].update(FLOW_WAVENET)
    doc["spec"].update(FLOW_SPEC)
    doc["flow"].update(FLOW_GROUP)
    return doc


def _with_flow(make_root):
    def wrapped(tmp):
        root = make_root(tmp)
        (root / "benchmark/configs/tiny_flow.json").write_text(json.dumps(flow_config()))
        for cell, limits in ((FLOW, FLOW_LIMITS), (MOL_TRAIN, MOL_TRAIN_LIMITS)):
            (root / f"benchmark/limits/{cell}.json").write_text(json.dumps(limits))
        man = json.loads((root / "BENCHMARK.json").read_text())
        man["configs"].append({"name": "tiny_flow", "source": "https://arxiv.org/abs/1811.00002",
                               "file": "benchmark/configs/tiny_flow.json", "reduced": [],
                               "why": "tiny widths for the CPU tests"})
        (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
        return root

    wrapped.with_flow = True
    return wrapped


if not getattr(tiny.make_root, "with_flow", False):
    tiny.make_root = _with_flow(tiny.make_root)
