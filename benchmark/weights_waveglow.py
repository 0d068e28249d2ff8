"""Seeded weights of WaveGlow (``configs/waveglow_22k.json``), made on the
run's device in one draw.

As ``weights.py`` draws the WaveNet models': one ``torch.randn`` of every
element on the device (a generator seeded from ``--seed``), scaled per
tensor.  Products at 1/sqrt(fan-in); biases at BIAS_SD; each flow's W_k
orthogonal with determinant +1, the Q of a QR of its drawn block (its first
column negated where the determinant is -1), as ``Invertible1x1Conv``
starts; the upsampler at UPSAMPLE_GAIN / sqrt(fan-in), for raw log-mel
frames of magnitude about 5; the ``end`` product, zero in NVIDIA's
initialisation (every coupling the identity), at END_SCALE / sqrt(fan-in)
and its bias at END_SCALE / 10: the largest |log s| over the pool then
reads about 0.7 at the published widths (about 8 x END_SCALE), so the
couplings, not the noise alone, shape the audio.  The same tensors go to the program (copied into its model) and
to the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BIAS_SD = 0.1
UPSAMPLE_GAIN = 0.15
END_SCALE = 0.1


def _scale(name: str, shape) -> float:
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("upsample."):
        # the transposed convolution's fan-in: n_mels x filter / stride taps
        # meet each output; filter / stride = 4 at the published widths
        return UPSAMPLE_GAIN / math.sqrt(shape[0] * 4) if leaf == "w" else BIAS_SD
    if ".end." in name:
        return END_SCALE / math.sqrt(shape[1]) if leaf == "w" else END_SCALE / 10
    if leaf in ("b", "b_in", "b_rs"):
        return BIAS_SD
    if leaf == "W":
        return 1.0
    return 1.0 / math.sqrt(int(np.prod(shape[1:])))


def orthogonal(a: torch.Tensor) -> torch.Tensor:
    """The Q of a's QR (in float64), with determinant +1."""
    q = torch.linalg.qr(a.double())[0]
    if torch.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.float()


def make(model: torch.nn.Module, seed: int, device) -> dict:
    """{name: tensor} for every parameter of ``model``, on ``device`` in
    float32, from ``seed``."""
    named = dict(model.named_parameters())
    total = sum(t.numel() for t in named.values())
    key = int(np.random.SeedSequence([int(seed), 0x57, 0x61]).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(key)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, t in named.items():
        n = t.numel()
        v = flat[at : at + n].view(t.shape)
        at += n
        out[k] = orthogonal(v) if k.endswith(".W") else v.mul_(_scale(k, t.shape))
    return out
