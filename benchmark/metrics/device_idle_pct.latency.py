"""The share of the traced sub-window in which no kernel, copy or set ran
on the device (the union of their intervals from torch.profiler)."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
