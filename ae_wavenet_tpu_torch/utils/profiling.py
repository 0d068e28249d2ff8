"""Tracing and step timing.

Counterpart of ``ae_wavenet_tpu.utils.profiling``:

* :func:`trace` is a context manager around ``torch.profiler`` that writes
  a Chrome trace (``chrome://tracing`` or ui.perfetto.dev) into ``log_dir``
  and fills a summary of the traced window: the share of it in which the
  device was busy, and the device's time by kernel, under the kernels' own
  names.
* :class:`StepTimer` is wall-clock step timing that fences the device only
  when it is read, never per step.

``start_server`` (a live profiling endpoint) has no counterpart in
``torch.profiler`` and is left out.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


def _union_us(spans: list) -> float:
    """Total length of the union of (start, end) intervals."""
    total, hi = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > hi:
            total += b - max(a, hi)
            hi = b
    return total


def summarize(prof, top: int = 5) -> dict:
    """Summary of a finished ``torch.profiler.profile``: ``window_ms`` (first
    to last event of the trace, host or device), ``device_busy_ms`` (the
    union of the device's kernel and copy intervals), ``device_busy_share``
    (None when the trace holds no device activity, as on the CPU),
    ``n_kernels`` and ``top_kernels`` [{name, ms, calls}] by total device
    time."""
    from torch.autograd import DeviceType

    spans, device_spans, by_name = [], [], {}
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        if e.device_type == DeviceType.CUDA:
            device_spans.append((a, b))
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (b - a) / 1e3, calls + 1)
    window = (max(b for _, b in spans) - min(a for a, _ in spans)) if spans else 0.0
    busy = _union_us(device_spans)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / window if device_spans and window else None,
            "n_kernels": len(device_spans),
            "top_kernels": [{"name": n, "ms": ms, "calls": c} for n, (ms, c) in ranked]}


@contextlib.contextmanager
def trace(log_dir: str, top: int = 5):
    """Trace the body (host, and the device when there is one).  Yields a
    dict that holds, once the body has ended, :func:`summarize`'s keys and
    ``trace_file``, the Chrome trace written under ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    on_card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    summary: dict = {}
    with profile(activities=acts) as prof:
        try:
            yield summary
        finally:
            if on_card:
                torch.cuda.synchronize()  # pending kernels belong to the window
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    summary.update(summarize(prof, top), trace_file=path)


class StepTimer:
    """Accumulates step wall time; fences the device only when read."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1):
        self._steps += n

    def rate(self, fence: bool = False) -> float:
        """Steps/sec since the last reset; with ``fence``, wait for the
        device first so that pending work is counted."""
        if fence and torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else float("inf")
