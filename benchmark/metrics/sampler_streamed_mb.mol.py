"""Megabytes of weights a generated step of the traced request read through
L2: the shares of the layers that do not fit in the sampler's shared memory
(the program's counter ``generate_fused.streamed_bytes``, over the traced
request's steps)."""


def read(run):
    return run.window.get("streamed_mb_a_step")
