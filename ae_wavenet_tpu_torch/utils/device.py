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


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for the
    first visible card, the number a measurement on it stands beside; on
    the CPU, ``cpu``.  Raises where ``nvidia-smi`` fails on a CUDA device."""
    import subprocess

    if torch.device(device).type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed ({r.returncode}): {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]
