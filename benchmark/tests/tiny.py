"""A copy of the benchmark at tiny widths, for the CPU tests: the manifest's
metrics and the loops as they are, with tiny configurations, traffic and
cells in a temporary root.  The tiny cells' limits are set as the real
cells' are, between the CPU's sound readings at these widths and the
control's or a fault's (a tiny stack rounds differently from a wide one)."""

from __future__ import annotations

import json
import pathlib
import shutil

from benchmark import harness

TRAIN, SERVE, VOCODE = "tiny.train", "tiny.serve", "tiny.vocode"

WAVENET = {"n_blocks": 1, "n_block_layers": 6, "n_res": 32, "n_dil": 32, "n_skp": 32,
           "n_post": 32, "n_lc_in": 16, "n_lc_out": 32, "n_speakers": 8,
           "n_global_embed": 8, "use_pallas_stack": True}


def _config(kind: str) -> dict:
    doc = json.loads((harness.ROOT / "benchmark/configs/chorowski_vq.json").read_text())
    doc["encoder"].update(n_ch=48, n_pre_res=1, n_post_res=1, n_out=16)
    doc["bottleneck"].update(n_dim=16, vq_k=32)
    doc["wavenet"].update(WAVENET)
    doc["train"].update(batch_sz=2, n_win=320, steps_per_call=2)
    if kind == "mfcc_inverter":
        doc["model_kind"] = "mfcc_inverter"
        doc["spec"]["norm"] = "dataset"
        doc["wavenet"].update(lc_upsample_strides=[5, 4, 4, 2],
                              lc_upsample_filters=[10, 8, 8, 4])
    return doc


TRAFFIC = {
    "tiny_train": {"loop": "train", "batch_sz": 2, "n_win": 320, "steps_per_call": 2,
                   "dataset": {"n_clips": 8, "clip_len": [6000, 9000], "n_speakers": 8}},
    "tiny_serve": {"loop": "reconstruct", "batch": 2, "gen_samples": 48, "temperature": 1.0,
                   "greedy_every": 2, "max_requests": 4,
                   "pool": {"n_clips": 4, "clip_len": [6000, 6001], "n_speakers": 8}},
}

LIMITS = {"train": {"grad_gap": 0.02, "grad_diff": 0.1, "change_gap": 0.15,
                    "codebook_gap": 1e-3},
          "serve": {"widest_gap": 0.002}}

CELLS = {TRAIN: ("tiny_vq", "tiny_train", "train.chorowski_vq.b4x48k"),
         SERVE: ("tiny_vq", "tiny_serve", "serve.chorowski_vq.b1"),
         VOCODE: ("tiny_inverter", "tiny_serve", "serve.mfcc_inverter.b64")}


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """A root whose ``benchmark/`` is a copy of this one plus the tiny
    configurations, traffic and cells; its manifest is this one's with the
    tiny cells in place of the real ones."""
    root = tmp / "root"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest()
    rename = {real: tiny for tiny, (_, _, real) in CELLS.items()}
    for kind in ("vq", "inverter"):
        (root / f"benchmark/configs/tiny_{kind}.json").write_text(
            json.dumps(_config("mfcc_inverter" if kind == "inverter" else "autoencoder")))
    for name, tr in TRAFFIC.items():
        (root / f"benchmark/traffic/{name}.json").write_text(json.dumps(tr))
    for tiny, (_, tr, _) in CELLS.items():
        kind = "serve" if TRAFFIC[tr]["loop"] == "reconstruct" else "train"
        (root / f"benchmark/limits/{tiny}.json").write_text(json.dumps(LIMITS[kind]))
    man["configs"] += [{"name": f"tiny_{k}", "source": "https://arxiv.org/abs/1901.08810",
                        "file": f"benchmark/configs/tiny_{k}.json", "reduced": [],
                        "why": "tiny widths for the CPU tests"} for k in ("vq", "inverter")]
    man["workloads"] = [{"name": tiny, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
                        for tiny, (c, t, _) in CELLS.items()]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root


def open_run(root, cell: str, seed: int = 12345, seconds: float = 0.5, trace: bool = False):
    man = harness.manifest(root)
    run = harness.open_run(man, cell, seed, seconds, trace, root=root, device="cpu")
    run.tmp = str(root / "tmp")
    return man, run
