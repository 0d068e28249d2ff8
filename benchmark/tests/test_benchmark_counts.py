"""The frozen counts against hand counts and against the program's own."""

from __future__ import annotations

import json

import pytest

from benchmark import counts, harness, peaks
from benchmark.reference import config, models


def _cfg(name: str):
    doc = json.loads((harness.ROOT / f"benchmark/configs/{name}.json").read_text())
    return config.from_json(json.dumps(doc))


def test_flagship_step_is_15_360_tflop():
    cfg = _cfg("chorowski_vq")
    spec = models.window_spec(cfg)
    assert (cfg.train.batch_sz, spec.n_win) == (4, 48000)
    assert round(counts.train_step_flops(cfg, spec, 4) / 1e12, 3) == 15.360


@pytest.mark.parametrize("name", ["chorowski_vq", "mfcc_inverter"])
def test_step_count_equals_the_programs(name):
    from ae_wavenet_tpu_torch.models import registry
    from ae_wavenet_tpu_torch.utils import config as prog_config
    from ae_wavenet_tpu_torch.utils import flops

    doc = json.loads((harness.ROOT / f"benchmark/configs/{name}.json").read_text())
    pcfg = prog_config.from_json(json.dumps(doc))
    pspec = registry.get(pcfg.model_kind).make_window_spec(pcfg)
    cfg = _cfg(name)
    want = flops.train_step_flops_per_item(pcfg, pspec) * 4
    assert counts.train_step_flops(cfg, models.window_spec(cfg), 4) == want


def test_gated_layer_and_stack_by_hand():
    wn = _cfg("chorowski_vq").wavenet
    # taps 2 x 384 and cond 128 + 32 into 2 x 256, then 256 into 384 + 256
    assert counts.layer_macs(wn) == (2 * 384 + 160) * 512 + 256 * 640 == 638976
    cfg = _cfg("chorowski_vq")
    ops, n_bytes = counts.stack_step(cfg, models.window_spec(cfg), 4)
    assert ops == 3 * 2 * 4 * 48000 * 638976 * 20
    assert ops / 989e12 > n_bytes / 3.35e12  # bound by operations


def test_sampler_step_by_hand():
    wn = _cfg("chorowski_vq").wavenet
    per_sample = 2 * (20 * 638976 + 256 * 256 + 256 * 256)
    ops, n_bytes = counts.sampler_launch(_cfg("chorowski_vq"), 1, 16000)
    assert ops == 16000 * per_sample
    assert round(per_sample / 1e6, 1) == 25.8  # ~26 MFLOP a generated sample
    weights = 2 * (20 * 638976 + 2 * 256 * 256) + 4 * 256 * 384
    assert n_bytes == weights + 16000 * (2 * 160 + 4) + 4 * 2046 * 384
    assert models.receptive_field(wn) == 2046


def test_request_counts_prime_and_generation_per_row():
    cfg = _cfg("chorowski_vq")
    one = counts.request_flops(cfg, 64000, 16000, 1)
    assert counts.request_flops(cfg, 64000, 16000, 64) == 64 * one
    gen = 2 * 16000 * counts.sampler_step_macs(cfg.wavenet)
    prime = 2 * 2046 * 20 * 638976
    assert gen + prime < one < 1.1 * (gen + prime)


@pytest.mark.parametrize("name,flops,hbm", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12), ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H100 NVL", 835e12, 3.9e12), ("NVIDIA A100-SXM4-80GB", None, None)])
def test_peaks_by_card_name(name, flops, hbm):
    p = peaks.of(name)
    assert (p is None) if flops is None else (p == {"bf16": flops, "hbm": hbm})
