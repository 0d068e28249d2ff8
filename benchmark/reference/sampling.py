"""The sampler's draws, worked out again: which id a served token had to be.

A request's tokens are drawn by Gumbel-max: id = argmax(logits / T + g)
(at T = 0, argmax(logits)), g = -log(-log(u + 1e-12) + 1e-12), u the top
24 bits of a Philox4x32-10 word over 2**24.  The key is (seed, 0), where
``seed`` is the first ``torch.randint(0, 2**31 - 1, ())`` of the request's
generator (masked to 31 bits); the counter of row ``r`` of the request's
batch at absolute step ``t`` and class ``c`` is (c // 4, r, t, 0), and the
word is c % 4.  The absolute step of a row's first generated sample is the
number of context samples its priming consumed: the receptive field.
Restated from the published Philox4x32-10 (Salmon et al. 2011).
"""

from __future__ import annotations

import torch

_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def kernel_seed(request_seed: int) -> int:
    """The Philox key's first word for the request whose generator is
    seeded with ``request_seed``."""
    g = torch.Generator().manual_seed(int(request_seed))
    return int(torch.randint(0, 2**31 - 1, (), generator=g)) & 0x7FFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    p1, p0 = a * (b >> 16), a * (b & 0xFFFF)  # each < 2**48 in int64
    lo = (((p1 & 0xFFFF) << 16) + p0) & _U32
    return (p1 + (p0 >> 16)) >> 16, lo


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W[0]) & _U32, (k1 + _W[1]) & _U32
        hi0, lo0 = _mulhilo(_M[0], c0)
        hi1, lo1 = _mulhilo(_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def gumbel(seed: int, rows: torch.Tensor, t0: int, n: int, n_quant: int) -> torch.Tensor:
    """g [R, n, n_quant] f32 of batch rows ``rows`` at absolute steps
    t0 .. t0 + n - 1."""
    dev = rows.device
    col = torch.arange(n_quant, device=dev)
    shape = (rows.shape[0], n, n_quant)
    c0 = (col >> 2).expand(shape)
    c1 = rows.long()[:, None, None].expand(shape)
    c2 = torch.arange(t0, t0 + n, device=dev)[None, :, None].expand(shape)
    words = philox(c0, c1, c2, torch.zeros_like(c2), seed, 0)
    w = (col & 3).expand(shape)
    bits = torch.where(w == 0, words[0], torch.where(w == 1, words[1],
                       torch.where(w == 2, words[2], words[3])))
    u = (bits >> 8).float() * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u + 1e-12) + 1e-12)
