"""Tiny counterparts of the vocoder cells, registered for every test of the
benchmark (``tiny.py`` and ``__init__.py`` are left as the cells before
them set them): ``tiny.inverter_train`` stands for
``train.mfcc_inverter.b4x48k``, ``tiny.mol`` for
``serve.wavenet_mol_24k.b64``.  ``tiny.make_root`` is wrapped so that each
root also holds the tiny mixture vocoder's configuration and the cell's
own limits."""

from __future__ import annotations

import json

from benchmark import harness
from benchmark.tests import tiny

INVERTER_TRAIN, MOL = "tiny.inverter_train", "tiny.mol"

MOL_WAVENET = {"n_blocks": 1, "n_block_layers": 6, "n_res": 32, "n_dil": 32, "n_skp": 32,
               "n_post": 32, "n_lc_in": 16, "n_lc_out": 16, "n_mix": 3,
               "use_pallas_stack": False}
MOL_LIMITS = {"mix_gap": 0.02, "value_gap": 0.015, "clipped_share": 0.05}

tiny.TRAFFIC.setdefault("tiny_mol", {
    "loop": "vocode_mol", "batch": 3, "gen_samples": 40, "temperature": 1.0,
    "greedy_every": 2, "check_rows": 2, "max_requests": 3,
    "pool": {"n_clips": 4, "clip_len": [9000, 9001], "n_speakers": 1, "sample_rate": 24000}})
tiny.CELLS.setdefault(INVERTER_TRAIN, ("tiny_inverter", "tiny_train",
                                       "train.mfcc_inverter.b4x48k"))
tiny.CELLS.setdefault(MOL, ("tiny_mol", "tiny_mol", "serve.wavenet_mol_24k.b64"))


def mol_config() -> dict:
    """``wavenet_mol_24k`` at tiny widths: 6 layers of 32, 3 components, 16
    mel bands."""
    doc = json.loads((harness.ROOT / "benchmark/configs/wavenet_mol_24k.json").read_text())
    doc = {k: v for k, v in doc.items() if k not in ("source", "reduced", "assumed")}
    doc["wavenet"].update(MOL_WAVENET)
    doc["spec"].update(n_mels=16)
    doc["train"].update(batch_sz=2, n_win=320, steps_per_call=2, compute_dtype="float32")
    return doc


def _with_vocoders(make_root):
    def wrapped(tmp):
        root = make_root(tmp)
        (root / "benchmark/configs/tiny_mol.json").write_text(json.dumps(mol_config()))
        (root / f"benchmark/limits/{MOL}.json").write_text(json.dumps(MOL_LIMITS))
        man = json.loads((root / "BENCHMARK.json").read_text())
        man["configs"].append({"name": "tiny_mol",
                               "source": "https://arxiv.org/abs/1712.05884",
                               "file": "benchmark/configs/tiny_mol.json", "reduced": [],
                               "why": "tiny widths for the CPU tests"})
        (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
        return root

    wrapped.with_vocoders = True
    return wrapped


if not getattr(tiny.make_root, "with_vocoders", False):
    tiny.make_root = _with_vocoders(tiny.make_root)
