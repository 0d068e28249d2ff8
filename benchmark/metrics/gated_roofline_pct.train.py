"""The gated stack's bound (its forward and backward products at the bf16
peak, or its bytes at the memory rate) over the device time of the
Hopper tile core's kernels (wg_*) in the traced steps."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "wg_", "stack_ops", "stack_bytes", "step")
