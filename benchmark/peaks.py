"""Published peaks of the cards the benchmark runs on.

NVIDIA's H100 data sheet, dense rates without sparsity: bf16 tensor-core
FLOP/s and device-memory bytes/s of each variant, chosen by a part of the
name CUDA reports for the card (the first part found decides).  A card
that is not listed has no peak, and the metrics that need one are left
out of the result.
"""

from __future__ import annotations

# (part of the lower-cased name without spaces, bf16 FLOP/s, bytes/s)
H100 = (
    ("pcie", 756e12, 2.0e12),    # "NVIDIA H100 PCIe"
    ("nvl", 835e12, 3.9e12),     # "NVIDIA H100 NVL"
    ("sxm", 989e12, 3.35e12),    # "NVIDIA H100 SXM5 ..."
    ("hbm3", 989e12, 3.35e12),   # "NVIDIA H100 80GB HBM3", the SXM part
)


def of(device_kind: str) -> dict | None:
    """{"bf16": FLOP/s, "hbm": bytes/s} of the card, or None."""
    dk = device_kind.lower().replace(" ", "")
    if "h100" not in dk:
        return None
    for part, flops, hbm in H100:
        if part in dk:
            return {"bf16": flops, "hbm": hbm}
    return None


def bound_s(ops: float, n_bytes: float, peak: dict) -> float:
    """The least seconds the card could take: operations over the bf16 peak
    or bytes over the memory rate, whichever is larger."""
    return max(ops / peak["bf16"], n_bytes / peak["hbm"])
