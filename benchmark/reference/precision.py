"""The precision of the reference's products.

A product ``result(op(a) @ op(b))`` takes its operands through
``operand`` and its output through ``result``.  ``exact`` leaves both as
they are (float32).  ``fp8`` is the precision below the configuration's
bf16, as fp8 training computes: each operand rounded to float8 e4m3 in the
forward pass, and the gradient of each product's output rounded to float8
e5m2 before the backward pass's two products read it, each tensor with one
scale (its largest magnitude onto the format's largest finite value), the
sums kept in float32.  The roundings pass gradients straight through.
"""

from __future__ import annotations

import torch


def _round(x: torch.Tensor, fmt, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.detach().float() * scale).to(fmt).float() / scale).to(x.dtype)


class _E5M2Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Exact:
    @staticmethod
    def operand(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def result(y: torch.Tensor) -> torch.Tensor:
        return y


class FP8:
    @staticmethod
    def operand(x: torch.Tensor) -> torch.Tensor:
        if not x.is_floating_point():
            return x
        return x + (_round(x, torch.float8_e4m3fn, 448.0) - x).detach()

    @staticmethod
    def result(y: torch.Tensor) -> torch.Tensor:
        return _E5M2Grad.apply(y) if y.requires_grad else y


exact, fp8 = Exact(), FP8()
