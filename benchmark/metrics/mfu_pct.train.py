"""The window's training operations (benchmark/counts.py, forward and
backward) over its seconds, as a share of the card's bf16 peak."""

from benchmark import readers


def read(run):
    return readers.mfu_pct(run, "step_flops", "steps")
