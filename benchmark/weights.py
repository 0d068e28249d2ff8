"""Seeded weights, made on the run's device in one draw.

Every parameter and buffer of the program's model gets a value from one
``torch.randn`` of all their elements on the device (a generator seeded
from ``--seed``), scaled per tensor by the rule of the model's own
initialiser: 1/sqrt(fan-in) for a product's weights (He, sqrt(2/fan-in),
in the encoder; 1e-2 for the output projection), zeros for biases and
LayerNorm offsets, ones for LayerNorm gains and the VQ EMA counts, the
codebook again for the EMA sums.  The same tensors go to the program
(copied into its model) and to the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _scale(name: str, shape) -> float | None:
    """The standard deviation of a drawn tensor, or None when it is not
    drawn (see :func:`_constant`)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("b", "o", "g", "b_mu", "b_sig", "ema_counts", "ema_sums"):
        return None
    if leaf == "codebook":
        return 1.0 / math.sqrt(shape[-1])
    if name.endswith("post2.w"):
        return 1e-2
    fan_in = int(np.prod(shape[1:]))
    if name.startswith("encoder."):
        return math.sqrt(2.0 / fan_in)
    return 1.0 / math.sqrt(fan_in)


def _constant(name: str) -> float:
    leaf = name.rsplit(".", 1)[-1]
    return 1.0 if leaf in ("g", "ema_counts") else 0.0


def make(model: torch.nn.Module, seed: int, device) -> dict:
    """{name: tensor} for every parameter and buffer of ``model``, on
    ``device`` in float32, from ``seed``."""
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    drawn = [(k, t.shape, _scale(k, t.shape)) for k, t in named.items()]
    drawn = [(k, s, sd) for k, s, sd in drawn if sd is not None]
    total = sum(int(np.prod(s)) for _, s, _ in drawn)
    key = int(np.random.SeedSequence([int(seed), 0x57]).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(key)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, s, sd in drawn:
        n = int(np.prod(s))
        out[k] = flat[at : at + n].view(s).mul_(sd)
        at += n
    for k, t in named.items():
        if k not in out:
            out[k] = torch.full(t.shape, _constant(k), device=device)
    for k in [k for k in named if k.endswith("ema_sums")]:
        out[k] = out[k[: -len("ema_sums")] + "codebook"].clone()
    return out


@torch.no_grad()
def load(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the model's own tensors, in place."""
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    if set(named) != set(weights):
        raise KeyError(f"weights do not match the model: {sorted(set(named) ^ set(weights))[:8]}")
    for k, t in named.items():
        t.copy_(weights[k])
