"""WaveNet decoder: parameters, geometry and the conditioning upsampler.

Counterpart of ``ae_wavenet_tpu.models.wavenet``: the geometry helpers,
the parameter layout (embedding, speaker embedding, transposed-conv
upsampler, gated layers with taps ``w_prev``/``w_cur``/``w_cond``/
``w_res``/``w_skip``, post-net), :func:`upsample_apply` and the
teacher-forced stack :func:`apply`.  The autoregressive cell lives in
``ops/fastgen.py``; the fused training stack in ``ops/gated.py``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ae_wavenet_tpu_torch.audio.mulaw import mu_encode
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
        if cfg.n_mix:
            self.in0 = _dense(g, cfg.n_res, 1)
            self.register_parameter("embed", None)
        else:
            self.embed = nn.Parameter(
                torch.randn(cfg.n_quant, cfg.n_res, generator=g) / math.sqrt(cfg.n_res))
        if cfg.n_global_embed:
            self.gc_embed = nn.Parameter(
                torch.randn(cfg.n_speakers, cfg.n_global_embed, generator=g)
                / math.sqrt(cfg.n_global_embed))
        else:
            self.register_parameter("gc_embed", None)
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
        self.post2 = _dense(g, cfg.n_out, cfg.n_post, scale=1e-2)


def embed_input(wavenet: WaveNet, x: torch.Tensor) -> torch.Tensor:
    """The stack's input x0 [..., n_res] f32 of AR inputs x [...]: the
    embedding row of each mu-law id, or, where the decoder has a mixture
    output (the input map ``in0`` in place of the embedding), the rank-1 map
    x * w_in0 + b_in0 of each sample in [-1, 1]."""
    if wavenet.embed is None:
        return x[..., None].float() * wavenet.in0["w"][:, 0] + wavenet.in0["b"]
    return wavenet.embed[x]


def decoder_inputs(cfg: WaveNetConfig, wav: torch.Tensor) -> torch.Tensor:
    """The decoder's AR inputs (and targets) of a float wav in [-1, 1]:
    mu-law ids, or with ``cfg.n_mix`` the samples themselves."""
    return wav if cfg.n_mix else mu_encode(wav, cfg.n_quant)


def upsample_apply(wavenet: WaveNet, cfg: WaveNetConfig, z: torch.Tensor,
                   steps: Sequence[PlanStep] | None = None,
                   dtype=torch.float32) -> torch.Tensor:
    """z: [B, C, Tz] latents -> [B, n_lc_out, T] wav-rate conditioning, in
    the compute ``dtype`` (operands and outputs).

    ``steps``: geometry plan for the upsample chain (static trims).  When
    None, all complete output positions are returned."""
    x = z
    for i, p in enumerate(wavenet.upsample):
        x = F.relu(tconv1d(x.to(dtype), p["w"].to(dtype), p["b"],
                           stride=cfg.lc_upsample_strides[i]))
        if steps is not None:
            st = steps[i]
            x = x[..., st.trim_l : st.trim_l + st.keep]
    return x


def _mm(p: nn.ParameterDict, x: torch.Tensor, dtype) -> torch.Tensor:
    """1x1 'conv' [B, Cin, T] -> [B, Cout, T]: operands and output in the
    compute dtype, then the bias added in it (the reference's ``_mm``)."""
    y = torch.einsum("oc,bct->bot", p["w"].to(dtype), x.to(dtype))
    return y + p["b"][None, :, None].to(dtype)


def apply(wavenet: WaveNet, cfg: WaveNetConfig, x_ids: torch.Tensor,
          cond: torch.Tensor, gc_ids: torch.Tensor | None = None, *,
          dtype=torch.float32, btq: bool = False) -> torch.Tensor:
    """Teacher-forcing forward: x_ids [B, T_in] mu-law ids (with
    ``cfg.n_mix``: samples in [-1, 1]), cond [B, n_lc_out, T_in] -> logits
    [B, n_out, T_in - rf] (time-major [B, T_out, n_out] with ``btq``).

    The plain per-layer stack rounds where the reference's XLA stack does:
    every 1x1 product gives a compute-dtype output, the residual stream
    runs in the compute dtype and skip accumulates in f32.  With
    ``cfg.use_pallas_stack`` and bf16 it runs the fused stack
    (``ops/gated.stack_apply``) on any device."""
    if cfg.filter_sz != 2:
        raise NotImplementedError("the two-tap matmul path requires filter_sz=2")
    if cfg.use_pallas_stack and dtype == torch.bfloat16:
        from ae_wavenet_tpu_torch.ops import gated

        return gated.stack_apply(wavenet, cfg, x_ids, cond, gc_ids, btq=btq)
    from ae_wavenet_tpu_torch.ops.fastgen import with_gc

    rf = receptive_field(cfg)
    t_in = x_ids.shape[-1]
    t_out = t_in - rf
    x = embed_input(wavenet, x_ids).permute(0, 2, 1).to(dtype)
    cond = with_gc(wavenet, cfg, cond, gc_ids)
    skip = torch.zeros(x.shape[0], cfg.n_skp, t_out, device=x.device)
    offset = 0
    for layer, d in zip(wavenet.layers, cfg.dilations):
        dd = d * (cfg.filter_sz - 1)
        cur, prev = x[..., dd:], x[..., : x.shape[-1] - dd]
        offset += dd
        y = _mm(layer.w_prev, prev, dtype) + _mm(layer.w_cur, cur, dtype)
        y = y + _mm(layer.w_cond, cond[..., offset:t_in], dtype)
        f, g = y.chunk(2, 1)
        h = torch.tanh(f) * torch.sigmoid(g)
        x = cur + _mm(layer.w_res, h, dtype)
        skip = skip + _mm(layer.w_skip, h[..., h.shape[-1] - t_out :], dtype)
    h = F.relu(skip)
    h = F.relu(_mm(wavenet.post1, h, dtype))
    logits = _mm(wavenet.post2, h, dtype)
    return logits.permute(0, 2, 1) if btq else logits
