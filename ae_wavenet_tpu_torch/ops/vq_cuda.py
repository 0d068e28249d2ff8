"""Fused VQ lookup: nearest code, codebook row and EMA statistics in one call.

Replaces the TPU kernel ``ae_wavenet_tpu/ops/vq_pallas.py``
``vq_lookup_fused`` with ``csrc/vq.cu``, written by hand for Hopper
(``sm_90a``).  For latents z [N, D] and a codebook [K, D] (f32, G = 1):

    codes  [N]    int32  argmin_k |e_k|^2 - 2 z_n . e_k, first index on ties
    quant  [N, D] f32    codebook[codes], bit for bit
    counts [K]    f32    rows per code (exact integers)
    sums   [K, D] f32    sum of the rows of z per code

A caller that reads only codes and quant (the serving and eval halves of the
bottleneck) passes ``stats=False``: counts and sums come back as None and
the kernel stops before its barrier across the grid.  Either way a call is
one launch; the wrapper's own work is one ``torch.empty`` per output (the
cheapest carve on the host: views of one buffer cost more) and the call.

``|z_n|^2`` is constant per row and left out of the distances, as in the TPU
kernel; ``VQBottleneck._nearest`` keeps it and stays the unfused path.  The
kernel has no backward: its inputs are detached latents.

What bounds it on the card: tens of MFLOP over less than a megabyte at the
model's shapes, so latency dominates (the launch, L2 round trips, one grid
barrier); the kernel spreads the rows over the SMs, keeps the [N, K]
distances and the one-hot matrix out of device memory and reduces the sums
in a fixed order, so two runs give the same bits.

:func:`vq_lookup_fused` dispatches on the device of ``z``: CUDA tensors
launch the kernel (or raise), CPU tensors take the plain version
:func:`vq_lookup_reference`.  Each counts its runs in ``.launches``.
"""

from __future__ import annotations

import torch

_MAX_D = 256  # csrc/vq.cu MAX_D
# the statistics' grid barrier: two int32 counters per (device, stream), zero
# when made; every call leaves them ready for the next one (csrc/vq.cu)
_BARRIERS: dict = {}


def _barrier(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _BARRIERS:
        _BARRIERS[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _BARRIERS[key]


@torch.no_grad()
def vq_lookup_reference(z: torch.Tensor, codebook: torch.Tensor,
                        stats: bool = True):
    """Plain PyTorch version of the kernel's contract (csrc/vq.cu):
    -> (codes [N] int32, quant [N, D], counts [K], sums [K, D]); counts and
    sums are None without ``stats``."""
    vq_lookup_reference.launches += 1
    d2 = codebook.square().sum(1)[None, :] - 2.0 * (z @ codebook.t())
    codes = d2.argmin(1)  # the first index on ties
    if not stats:
        return codes.to(torch.int32), codebook[codes], None, None
    onehot = torch.nn.functional.one_hot(codes, codebook.shape[0]).to(z.dtype)
    return (codes.to(torch.int32), codebook[codes], onehot.sum(0), onehot.t() @ z)


vq_lookup_reference.launches = 0


def _launch(lib, z, codebook, codes, quant, counts, sums) -> int:
    """``awt_vq_lookup`` on the current device's current stream."""
    stream = torch.cuda.current_stream(z.device).cuda_stream
    stats = counts is not None
    return lib.awt_vq_lookup(z.data_ptr(), codebook.data_ptr(), z.shape[0],
                             codebook.shape[0], z.shape[1], codes.data_ptr(),
                             quant.data_ptr(), counts.data_ptr() if stats else None,
                             sums.data_ptr() if stats else None,
                             _barrier(z.device, stream).data_ptr() if stats else None,
                             stream)


def vq_lookup_fused(z: torch.Tensor, codebook: torch.Tensor, stats: bool = True):
    """z [N, D] f32, codebook [K, D] f32 -> (codes [N] int32, quant [N, D],
    counts [K], sums [K, D]); counts and sums are None without ``stats``.
    On CUDA tensors this launches ``csrc/vq.cu`` on the current stream; on
    CPU tensors it runs :func:`vq_lookup_reference`.  No gradient flows
    through it."""
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"z {tuple(z.shape)} and codebook {tuple(codebook.shape)}: "
                         "need [N, D] and [K, D]")
    if z.shape[0] < 1:
        raise ValueError("need at least one row of z")
    z, codebook = z.detach(), codebook.detach()
    if z.device.type == "cpu":
        return vq_lookup_reference(z, codebook, stats)
    if z.device.type != "cuda":
        raise ValueError(f"no VQ kernel for device {z.device}")
    for name, v in (("z", z), ("codebook", codebook)):
        if v.device != z.device:
            raise ValueError(f"{name} is on {v.device}, z on {z.device}")
        if v.dtype != torch.float32:
            raise ValueError(f"{name}: {v.dtype}, the kernel takes float32")
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    n, d = z.shape
    k = codebook.shape[0]
    if d > _MAX_D:
        raise ValueError(f"D={d}: the kernel takes latents up to {_MAX_D} wide")
    from ae_wavenet_tpu_torch.ops import _build

    lib = _build.load()
    dev = z.device
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    quant = torch.empty(n, d, device=dev)
    counts = torch.empty(k, device=dev) if stats else None
    sums = torch.empty(k, d, device=dev) if stats else None
    if dev.index == torch.cuda.current_device():
        rc = _launch(lib, z, codebook, codes, quant, counts, sums)
    else:
        with torch.cuda.device(dev):
            rc = _launch(lib, z, codebook, codes, quant, counts, sums)
    if rc != 0:
        raise RuntimeError(f"vq kernel launch failed: CUDA error {rc} "
                           f"({lib.awt_cuda_error_string(rc).decode()})")
    vq_lookup_fused.launches += 1
    return codes, quant, counts, sums


vq_lookup_fused.launches = 0
