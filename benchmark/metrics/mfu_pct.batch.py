"""The window's model operations of every request (encode, prime, generated
samples) over its seconds, as a share of the card's bf16 peak."""

from benchmark import readers


def read(run):
    return readers.mfu_pct(run, "request_flops", "requests")
