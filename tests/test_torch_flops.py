"""The port's FLOP count (``utils/flops.py``) against the JAX package's, and
against PyTorch's own counter.

For the autoencoder the analytic counts must equal the reference's,
integer for integer.  For the MFCC inverter the port counts the
inverter's own graph; the reference's count charges it the autoencoder's
encoder and bottleneck, and an upsampler from ``n_lc_in`` channels in
place of ``3 * n_mfcc``.  Against ``torch.utils.flop_counter`` on the
plain f32 forward the analytic count must lie between 0.75x and 1.02x of
the counter's (the band ``tests/test_flops.py:63-64`` uses against XLA).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ae_wavenet_tpu.models import autoencoder as jae
from ae_wavenet_tpu.models import mfcc_inverter as jmi
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu.utils import flops as jflops
from ae_wavenet_tpu_torch.models import autoencoder as tae
from ae_wavenet_tpu_torch.models import mfcc_inverter as tmi
from ae_wavenet_tpu_torch.utils import config as tcfg
from ae_wavenet_tpu_torch.utils import flops as tflops


def _both(cfg):
    return cfg, tcfg.from_json(jcfg.to_json(cfg))


def _inverter(cfg):
    return dataclasses.replace(
        cfg, model_kind="mfcc_inverter",
        wavenet=dataclasses.replace(cfg.wavenet, lc_upsample_strides=(5, 4, 4, 2),
                                    lc_upsample_filters=(10, 8, 8, 4)))


CASES = [("tiny", None), ("chorowski", None), ("chorowski", 48000), ("vq", None),
         ("vae", 8000)]


@pytest.mark.parametrize("preset,n_win", CASES)
def test_autoencoder_counts_equal_jax(preset, n_win):
    """Every key of ``forward_flops``, the per-item and the per-sample
    training counts, equal to JAX's."""
    jc, tc = _both(jcfg.PRESETS[preset]())
    js, ts = jae.make_window_spec(jc, n_win), tae.make_window_spec(tc, n_win)
    want, got = jflops.forward_flops(jc, js), tflops.forward_flops(tc, ts)
    assert got == want
    assert all(isinstance(v, int) for v in got.values())
    assert (tflops.train_step_flops_per_item(tc, ts)
            == jflops.train_step_flops_per_item(jc, js))
    assert (tflops.train_step_flops_per_sample(tc, ts)
            == jflops.train_step_flops_per_sample(jc, js))


def test_inverter_count_differs_from_jax_where_the_graphs_differ():
    """The frontend and the decoder are counted as JAX counts them; the
    encoder, bottleneck and aux head are 0 (the inverter has none), and the
    upsampler's first layer takes 3 * n_mfcc channels over the frames."""
    jc, tc = _both(_inverter(jcfg.chorowski_config()))
    js, ts = jmi.make_window_spec(jc, 48000), tmi.make_window_spec(tc, 48000)
    want, got = jflops.forward_flops(jc, js), tflops.forward_flops(tc, ts)
    assert got["mfcc"] == want["mfcc"] and got["decoder"] == want["decoder"]
    assert got["encoder"] == got["bottleneck"] == got["aux_frame"] == 0
    assert min(want["encoder"], want["bottleneck"], want["aux_frame"]) > 0
    wn, up = tc.wavenet, ts.up_steps
    first = 2 * ts.n_frames * wn.n_lc_out * 3 * tc.spec.n_mfcc * wn.lc_upsample_filters[0]
    rest = sum(2 * up[i - 1].keep * wn.n_lc_out * wn.n_lc_out * f
               for i, f in enumerate(wn.lc_upsample_filters) if i)
    assert got["upsample"] == first + rest != want["upsample"]
    assert got["total"] == sum(v for k, v in got.items() if k != "total")


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 989e12),
    ("TPU v5 lite", 197e12), ("TPU v5p", 459e12), ("TPU v4", 275e12),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_lookup(name, want):
    assert tflops.peak_bf16_flops(name) == want


def test_peak_is_none_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tflops.peak_bf16_flops() is None


@pytest.mark.parametrize("n_win", [None, 1000])
def test_inverter_count_against_torch_flop_counter(n_win):
    """The analytic count of the plain f32 forward lies between 0.75x and
    1.02x of what ``FlopCounterMode`` counts (products, convs and
    transposed convs) in ``mfcc_inverter.forward``."""
    cfg = tcfg.from_json(jcfg.to_json(_inverter(jcfg.tiny_config())))
    spec = tmi.make_window_spec(cfg, n_win)
    model = tmi.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = cfg.train.batch_sz
    wav = torch.from_numpy(np.random.default_rng(0).integers(
        -8000, 8000, size=(b, spec.u_len)).astype(np.int16))
    spk = torch.zeros(b, dtype=torch.long)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        tmi.forward(model, cfg, spec, wav, spk)
    counted = counter.get_total_flops()
    analytic = tflops.forward_flops(cfg, spec)["total"] * b
    assert 0.75 * counted <= analytic <= 1.02 * counted, (analytic, counted)
