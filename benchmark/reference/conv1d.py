"""1-D convolutions in the geometry conventions of ``geometry.vconv``.

NCW layout, VALID only: window sizing and trimming are decided by the
geometry layer.  Counterpart of ``ae_wavenet_tpu.ops.conv1d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """VALID 1-D correlation. x: [B, Cin, T], w: [Cout, Cin, F] ->
    [B, Cout, T'] (geometry ``vconv.Conv(F, stride, dilation)``).

    The output takes the input's dtype, and the bias is added after the
    conv in that dtype, as the reference rounds a bf16 conv."""
    y = F.conv1d(x, w, stride=stride, dilation=dilation)
    return y if b is None else y + b[None, :, None].to(y.dtype)


def tconv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
            *, stride: int) -> torch.Tensor:
    """Transposed 1-D conv returning only COMPLETE output positions.

    x: [B, Cin, T], w: [Cout, Cin, F] (the reference's correlation layout)
    -> [B, Cout, (T-1)*stride + 1 - (F-1)].

    The reference computes y[u] = sum_{j,k: u = j*stride - k} x[j] w[k]
    (zero-stuffing followed by a correlation).  ``conv_transpose1d`` computes
    z[v] = sum_{v = j*stride + k'} x[j] w'[k'], so with the taps flipped
    (k' = F-1-k) y[u] = z[u + F - 1]: the complete range is z[F-1 :
    (T-1)*stride + 1], the complete positions of ``vconv.TConv``.
    """
    f = w.shape[-1]
    y = F.conv_transpose1d(x, w.flip(-1).transpose(0, 1), stride=stride)
    y = y[..., f - 1 : (x.shape[-1] - 1) * stride + 1]
    if b is not None:
        y = y + b[None, :, None].to(y.dtype)
    return y
