"""Generated samples of every request completed in the window (all rows of
every batch), over the window's seconds."""

from benchmark import readers


def read(run):
    return readers.rate(run, "gen_samples")
