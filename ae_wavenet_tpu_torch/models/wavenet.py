"""WaveNet decoder: parameters, geometry and the conditioning upsampler.

Counterpart of ``ae_wavenet_tpu.models.wavenet`` for the generation path:
the geometry helpers, the parameter layout (embedding, speaker embedding,
transposed-conv upsampler, gated layers with taps ``w_prev``/``w_cur``/
``w_cond``/``w_res``/``w_skip``, post-net) and :func:`upsample_apply`.
The teacher-forced stack ``apply`` belongs to the training slice; the
autoregressive cell lives in ``ops/fastgen.py``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ae_wavenet_tpu_torch.geometry.vconv import Chain, Conv, PlanStep, TConv
from ae_wavenet_tpu_torch.ops.conv1d import tconv1d
from ae_wavenet_tpu_torch.utils.config import WaveNetConfig


def dilated_geometry(cfg: WaveNetConfig) -> Chain:
    """Causal dilated stack as a chain (footprint per layer = Conv(k, dil))."""
    return Chain([Conv(cfg.filter_sz, dilation=d, name=f"dil{i}")
                  for i, d in enumerate(cfg.dilations)])


def receptive_field(cfg: WaveNetConfig) -> int:
    """Left context consumed by the stack (input samples beyond each output)."""
    return (cfg.filter_sz - 1) * sum(cfg.dilations)


def upsample_geometry(cfg: WaveNetConfig) -> Chain:
    return Chain([TConv(f, stride=s, name=f"up{i}") for i, (f, s) in
                  enumerate(zip(cfg.lc_upsample_filters, cfg.lc_upsample_strides))])


def _dense(gen, cout: int, cin: int, scale: float | None = None) -> nn.ParameterDict:
    scale = 1.0 / math.sqrt(cin) if scale is None else scale
    return nn.ParameterDict({
        "w": nn.Parameter(torch.randn(cout, cin, generator=gen) * scale),
        "b": nn.Parameter(torch.zeros(cout)),
    })


class GatedLayer(nn.Module):
    """One dilated k=2 gated layer as five 1x1 taps, each {w [out, in], b}."""

    def __init__(self, cfg: WaveNetConfig, gen: torch.Generator | None = None):
        super().__init__()
        n_cond = cfg.n_lc_out + cfg.n_global_embed
        self.w_prev = _dense(gen, 2 * cfg.n_dil, cfg.n_res)
        self.w_cur = _dense(gen, 2 * cfg.n_dil, cfg.n_res)
        self.w_cond = _dense(gen, 2 * cfg.n_dil, n_cond)
        self.w_res = _dense(gen, cfg.n_res, cfg.n_dil)
        self.w_skip = _dense(gen, cfg.n_skp, cfg.n_dil)


class WaveNet(nn.Module):
    def __init__(self, cfg: WaveNetConfig, generator: torch.Generator | None = None,
                 n_lc_in: int | None = None):
        """n_lc_in: channels of the raw local-conditioning input (defaults to
        cfg.n_lc_in)."""
        super().__init__()
        g = generator
        self.cfg = cfg
        cin = cfg.n_lc_in if n_lc_in is None else n_lc_in
        self.embed = nn.Parameter(
            torch.randn(cfg.n_quant, cfg.n_res, generator=g) / math.sqrt(cfg.n_res))
        self.gc_embed = nn.Parameter(
            torch.randn(cfg.n_speakers, cfg.n_global_embed, generator=g)
            / math.sqrt(cfg.n_global_embed))
        ups = []
        for f in cfg.lc_upsample_filters:
            ups.append(nn.ParameterDict({
                "w": nn.Parameter(torch.randn(cfg.n_lc_out, cin, f, generator=g)
                                  / math.sqrt(cin * f)),
                "b": nn.Parameter(torch.zeros(cfg.n_lc_out)),
            }))
            cin = cfg.n_lc_out
        self.upsample = nn.ModuleList(ups)
        self.layers = nn.ModuleList([GatedLayer(cfg, g) for _ in cfg.dilations])
        self.post1 = _dense(g, cfg.n_post, cfg.n_skp)
        self.post2 = _dense(g, cfg.n_quant, cfg.n_post, scale=1e-2)


def upsample_apply(wavenet: WaveNet, cfg: WaveNetConfig, z: torch.Tensor,
                   steps: Sequence[PlanStep] | None = None) -> torch.Tensor:
    """z: [B, C, Tz] latents -> [B, n_lc_out, T] wav-rate conditioning.

    ``steps``: geometry plan for the upsample chain (static trims).  When
    None, all complete output positions are returned."""
    x = z
    for i, p in enumerate(wavenet.upsample):
        x = F.relu(tconv1d(x, p["w"], p["b"], stride=cfg.lc_upsample_strides[i]))
        if steps is not None:
            st = steps[i]
            x = x[..., st.trim_l : st.trim_l + st.keep]
    return x
