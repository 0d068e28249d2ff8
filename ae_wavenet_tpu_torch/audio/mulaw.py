"""Mu-law companding codec (mu = n_quant - 1) on torch tensors.

Counterpart of ``ae_wavenet_tpu.audio.mulaw``'s jittable functions.  Both
frameworks round half to even (``torch.round`` / ``jnp.round``).
"""

from __future__ import annotations

import math

import torch


def _check(n_quant: int):
    if n_quant < 2 or n_quant % 2:
        raise ValueError(f"n_quant must be even and >= 2, got {n_quant}")


def mu_encode(x: torch.Tensor, n_quant: int = 256) -> torch.Tensor:
    """float wav in [-1, 1] -> int64 ids in [0, n_quant)."""
    _check(n_quant)
    mu = float(n_quant - 1)
    x = torch.clamp(x, -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) * (1.0 / math.log1p(mu))
    q = torch.round((y + 1.0) * (0.5 * mu))
    return torch.clamp(q, 0, mu).long()


def mu_decode(q: torch.Tensor, n_quant: int = 256) -> torch.Tensor:
    """int ids -> float32 wav in [-1, 1]."""
    _check(n_quant)
    mu = float(n_quant - 1)
    y = 2.0 * q.float() / mu - 1.0
    return torch.sign(y) * torch.expm1(torch.abs(y) * math.log1p(mu)) / mu


def int16_to_float(x: torch.Tensor) -> torch.Tensor:
    """Raw int16 PCM -> float32 in [-1, 1]."""
    return x.float() * (1.0 / 32768.0)
