"""What the metric readers (``metrics/<name>.py``) share.  Each returns
None where the run holds nothing to read, and the metric is then left out
of the result line."""

from __future__ import annotations

import statistics

from benchmark import peaks


def rate(run, key: str):
    """``key`` of the window (samples) over the window's seconds."""
    w = run.window
    return w[key] / w["seconds"] if key in w and w.get("seconds") else None


def idle_pct(run):
    t = run.trace
    return None if t is None or not t.kernels else 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(run, flops_key: str, count_key: str):
    """The window's model operations over its seconds, as a share of the
    published bf16 peak of the cards the run uses."""
    w = run.window
    if run.peak is None or flops_key not in run.counts or not w.get("seconds"):
        return None
    return 100.0 * run.counts[flops_key] * w[count_key] / w["seconds"] / (
        run.peak["bf16"] * max(1, run.device_count))


def roofline_pct(run, kernel: str, ops_key: str, bytes_key: str, per: str):
    """The bound of the traced work over the device time of the kernels
    whose name holds ``kernel``; ``per`` = "step" (the counts are a
    step's, times the traced steps) or "launch" (a launch's, times the
    traced launches)."""
    t = run.trace
    if t is None or run.peak is None or ops_key not in run.counts:
        return None
    dev_s = t.device_s(kernel)
    if dev_s <= 0:
        return None
    n = run.window["trace_steps"] if per == "step" else t.calls(kernel)
    bound = peaks.bound_s(run.counts[ops_key], run.counts[bytes_key], run.peak)
    return 100.0 * bound * n / dev_s


def mean_ms(run, key: str):
    v = run.window.get(key)
    return 1e3 * statistics.fmean(v) if v else None
