"""Chorowski-style MFCC encoder: k=3 residual pairs, one strided
downsampling conv, channel LayerNorm, linear head to the bottleneck.

Counterpart of ``ae_wavenet_tpu.models.encoder``.  All convs are VALID; the
layer structure is mirrored by :func:`geometry`, so input frames [0, N) map
to latents [0, geometry(cfg).out_len(N)) with no trim.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ae_wavenet_tpu_torch.geometry.vconv import Chain, Conv
from ae_wavenet_tpu_torch.ops.conv1d import conv1d
from ae_wavenet_tpu_torch.utils.config import EncoderConfig


def geometry(cfg: EncoderConfig) -> Chain:
    layers = []
    for i in range(cfg.n_pre_res):
        layers += [Conv(3, name=f"pre{i}a"), Conv(3, name=f"pre{i}b")]
    layers.append(Conv(cfg.down_filter, stride=cfg.down_stride, name="down"))
    for i in range(cfg.n_post_res):
        layers += [Conv(3, name=f"post{i}a"), Conv(3, name=f"post{i}b")]
    layers.append(Conv(1, name="head"))
    return Chain(layers)


def conv_params(gen: torch.Generator | None, cout: int, cin: int, f: int,
                scale: float) -> nn.ParameterDict:
    """{"w": N(0, scale^2) [cout, cin, f], "b": zeros [cout]}."""
    return nn.ParameterDict({
        "w": nn.Parameter(torch.randn(cout, cin, f, generator=gen) * scale),
        "b": nn.Parameter(torch.zeros(cout)),
    })


def _he(gen, cout, cin, f):
    # He init for ReLU stacks
    return conv_params(gen, cout, cin, f, math.sqrt(2.0 / (cin * f)))


def _ln_params(c: int) -> nn.ParameterDict:
    return nn.ParameterDict({"g": nn.Parameter(torch.ones(c)),
                             "o": nn.Parameter(torch.zeros(c))})


def _ln(p: nn.ParameterDict, x: torch.Tensor) -> torch.Tensor:
    """Channel LayerNorm at each (batch, time) position."""
    mean = x.mean(1, keepdim=True)
    var = x.var(1, unbiased=False, keepdim=True)
    xn = (x - mean) * torch.rsqrt(var + 1e-6)
    return xn * p["g"][None, :, None] + p["o"][None, :, None]


def _res_pair(p: nn.ModuleDict, x: torch.Tensor, dtype) -> torch.Tensor:
    """Two k=3 VALID convs with ReLU, residual added on the trimmed center,
    channel-LayerNormed (in f32, cast back to the compute dtype)."""
    h = F.relu(conv1d(x.to(dtype), p["a"]["w"].to(dtype), p["a"]["b"]))
    h = conv1d(h.to(dtype), p["b"]["w"].to(dtype), p["b"]["b"])
    y = F.relu(x[..., 2:-2] + h)
    return _ln(p["ln"], y.float()).to(y.dtype)


class Encoder(nn.Module):
    """Parameters under the reference's names (``stem``, ``pre.i.{a,b,ln}``,
    ``down``, ``down_ln``, ``post.i.{a,b,ln}``, ``head``)."""

    def __init__(self, cfg: EncoderConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        c, g = cfg.n_ch, generator

        def pair():
            return nn.ModuleDict({"a": _he(g, c, c, 3), "b": _he(g, c, c, 3),
                                  "ln": _ln_params(c)})

        self.stem = _he(g, c, cfg.n_in, 1)
        self.pre = nn.ModuleList([pair() for _ in range(cfg.n_pre_res)])
        self.down = _he(g, c, c, cfg.down_filter)
        self.down_ln = _ln_params(c)
        self.post = nn.ModuleList([pair() for _ in range(cfg.n_post_res)])
        self.head = _he(g, cfg.n_out, c, 1)

    def forward(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """x: [B, n_in, F] MFCC stack -> latents [B, n_out, Tz] in f32.

        ``dtype`` is the compute dtype: convs take operands in it and give
        outputs in it (the reference's bf16 training path)."""
        def conv(p, v, **kw):
            return conv1d(v.to(dtype), p["w"].to(dtype), p["b"], **kw)

        x = F.relu(conv(self.stem, x))
        for p in self.pre:
            x = _res_pair(p, x, dtype)
        x = F.relu(conv(self.down, x, stride=self.cfg.down_stride))
        x = _ln(self.down_ln, x.float()).to(x.dtype)
        for p in self.post:
            x = _res_pair(p, x, dtype)
        return conv(self.head, x).float()
