"""Milliseconds of prime a request, mean over the window (the program's
timings["prime"], host clock after a device sync)."""

from benchmark import readers


def read(run):
    return readers.mean_ms(run, "prime_s")
