"""Seconds from the process's start to the first timed step or request:
imports, the kernels' build cache, data and weights from the seed, and the
warm-up of the cell's shapes (in a cell's first run, the build too)."""


def read(run):
    return run.setup_s
