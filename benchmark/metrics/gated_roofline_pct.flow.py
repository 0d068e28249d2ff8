"""The three-tap gated layers' bound (their products at the bf16 peak, or
their bytes at the memory rate: ``counts_waveglow.layer_launch``, a
launch's) over the device time of the Hopper tile core's kernels (wg_*) in
the traced request, times their launches there."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "wg_", "layer_ops", "layer_bytes", "launch")
