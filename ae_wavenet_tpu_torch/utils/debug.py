"""Numeric checks: the ``--nan-checks`` test of the training loop.

Counterpart of ``ae_wavenet_tpu.utils.debug.assert_all_finite``."""

from __future__ import annotations

import torch


def assert_all_finite(named, name: str = "tree") -> None:
    """Raise FloatingPointError naming the non-finite floating tensors of
    ``named`` ((name, tensor) pairs, e.g. ``module.named_parameters()``)."""
    named = list(named)
    flags = [torch.isfinite(t).all() for _, t in named if t.is_floating_point()]
    if not flags or bool(torch.stack(flags).all()):
        return
    bad = [k for k, t in named if t.is_floating_point()
           and not bool(torch.isfinite(t).all())]
    raise FloatingPointError(f"non-finite values in {name}: {bad[:8]}")
