"""Milliseconds a training step waited for its batch on average over the
window (``Chassis.stats["loader_wait"]``, the loader thread's queue)."""


def read(run):
    w = run.window
    return 1e3 * w["loader_wait_s"] / w["steps"] if "loader_wait_s" in w else None
