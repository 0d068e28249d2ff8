"""The sampler launches' bound (the generated steps' products at the bf16
peak, or their bytes at the memory rate) over the device time of
fastgen_kernel in the traced request."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "fastgen_kernel", "sampler_ops", "sampler_bytes", "launch")
