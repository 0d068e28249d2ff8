"""The device an entry point runs on: the card, unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device that is not there
    raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available (pass "
            "device='cpu' to run on the CPU)")
    return device
