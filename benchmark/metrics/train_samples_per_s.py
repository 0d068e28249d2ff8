"""Loss samples of every training step completed in the window, over the
window's seconds (the window ends in the loop's own fetch)."""

from benchmark import readers


def read(run):
    return readers.rate(run, "samples")
