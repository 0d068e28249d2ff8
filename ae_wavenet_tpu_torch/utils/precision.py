"""Float32 numerics on the card, as the reference computes them."""

from __future__ import annotations

import torch


def set_reference_precision() -> None:
    """Turn off TF32 for float32 matmuls and cuDNN convolutions.

    The JAX package computes these convolutions and products in f32; PyTorch
    would run the convolutions (and, where enabled, matmuls) in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
