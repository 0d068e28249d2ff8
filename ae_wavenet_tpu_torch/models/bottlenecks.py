"""Bottlenecks on their evaluation path: plain AE, zero (conditioning
ablation), VAE (posterior mean) and VQ (nearest code, G >= 1 groups).

Counterpart of ``ae_wavenet_tpu.models.bottlenecks.apply(train=False)``:
no EMA update, no jitter, no restarts.  VQ state (``codebook``,
``ema_counts``, ``ema_sums``) is kept as buffers under the reference's
``bn_state`` names so checkpoints round-trip; the training behaviour that
updates it waits for the training slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ae_wavenet_tpu_torch.utils.config import BottleneckConfig


class AEBottleneck(nn.Module):
    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return z


class ZeroBottleneck(nn.Module):
    """The decoder sees all-zero local conditioning."""

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(z)


class VAEBottleneck(nn.Module):
    def __init__(self, cfg: BottleneckConfig, generator: torch.Generator | None = None):
        super().__init__()
        d, s = cfg.n_dim, 1.0 / math.sqrt(cfg.n_dim)
        self.w_mu = nn.Parameter(torch.randn(d, d, generator=generator) * s)
        self.b_mu = nn.Parameter(torch.zeros(d))
        self.w_sig = nn.Parameter(torch.randn(d, d, generator=generator) * s)
        self.b_sig = nn.Parameter(torch.zeros(d))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """Posterior mean (no reparameterization draw in eval)."""
        return (torch.einsum("bdt,ed->bet", z, self.w_mu)
                + self.b_mu[None, :, None])


class VQBottleneck(nn.Module):
    def __init__(self, cfg: BottleneckConfig, generator: torch.Generator | None = None):
        super().__init__()
        g = cfg.vq_groups
        if g == 1:  # the reference keeps ungrouped state shapes for G = 1
            shape, counts_shape = (cfg.vq_k, cfg.n_dim), (cfg.vq_k,)
        else:
            shape, counts_shape = (g, cfg.vq_k, cfg.n_dim // g), (g, cfg.vq_k)
        codebook = torch.randn(*shape, generator=generator) / math.sqrt(shape[-1])
        self.groups = g
        self.register_buffer("codebook", codebook)
        self.register_buffer("ema_counts", torch.ones(counts_shape))
        self.register_buffer("ema_sums", codebook.clone())

    def _grouped(self, z: torch.Tensor):
        """z [B, D, T] -> (flat z [N, D], per-group z [G, N, D/G],
        per-group codebook [G, K, D/G])."""
        b, d, t = z.shape
        zf = z.permute(0, 2, 1).reshape(b * t, d)
        zg = zf.reshape(b * t, self.groups, d // self.groups).permute(1, 0, 2)
        e = self.codebook
        return zf, zg, (e if e.dim() == 3 else e[None])

    @staticmethod
    def _nearest(zg: torch.Tensor, eg: torch.Tensor) -> torch.Tensor:
        d2 = (zg.square().sum(2, keepdim=True)
              - 2.0 * torch.einsum("gnd,gkd->gnk", zg, eg)
              + eg.square().sum(2)[:, None, :])
        return d2.argmin(2)

    def codes(self, z: torch.Tensor) -> torch.Tensor:
        """Nearest code per group: [G, B*T] (rows ordered (b, t))."""
        _, zg, eg = self._grouped(z)
        return self._nearest(zg, eg)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        b, d, t = z.shape
        zf, zg, eg = self._grouped(z)
        idx = self._nearest(zg, eg)
        qg = torch.gather(eg, 1, idx[..., None].expand(-1, -1, eg.shape[-1]))
        q = qg.permute(1, 0, 2).reshape(b * t, d)
        # the reference's straight-through value zf + (q - zf), kept as is
        # so the conditioning matches it to the last bit
        zq = zf + (q - zf)
        return zq.reshape(b, t, d).permute(0, 2, 1)


def make(cfg: BottleneckConfig, generator: torch.Generator | None = None) -> nn.Module:
    if cfg.kind == "ae":
        return AEBottleneck()
    if cfg.kind == "zero":
        return ZeroBottleneck()
    if cfg.kind == "vae":
        return VAEBottleneck(cfg, generator)
    if cfg.kind == "vq":
        return VQBottleneck(cfg, generator)
    raise ValueError(f"unknown bottleneck kind {cfg.kind!r}")
