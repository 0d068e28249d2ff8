"""The traced sub-window of a run: ``torch.profiler`` over the body of
:func:`window`, reduced in memory (no trace file is written).

The benchmark marks its own spans with ``record_function("bench.<name>")``
around its calls into the program; the window itself is ``bench.window``.
The reduction gives the window's length, the union of the device's kernel,
copy and set intervals inside it (busy; the profiler's mirror of a
benchmark span on the device's timeline is not work and is left out), the device time by kernel name,
and the longest idle gaps, each labelled with the innermost benchmark span
the host was in when the gap began.  Copy of the union arithmetic of the
program's ``utils/profiling.summarize``.
"""

from __future__ import annotations

import contextlib


def _merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """What the profiled window held (seconds throughout)."""

    def __init__(self, events):
        host, dev = [], []
        for e in events:
            a = e.start_ns() / 1e9
            b = a + e.duration_ns() / 1e9
            if e.name().startswith("bench."):  # on the host and mirrored on the device
                if not str(e.device_type()).endswith("CUDA"):
                    host.append((e.name()[len("bench."):], a, b))
            elif str(e.device_type()).endswith("CUDA"):
                dev.append((e.name(), a, b))
        win = [(a, b) for n, a, b in host if n == "window"]
        if not win:
            raise RuntimeError("the profiled window holds no bench.window span")
        self.t0, self.t1 = win[0]
        self.window_s = self.t1 - self.t0
        self.spans = [s for s in host if s[0] != "window"]
        self.kernels: dict = {}
        clipped = []
        for n, a, b in dev:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            s, c = self.kernels.get(n, (0.0, 0))
            self.kernels[n] = (s + b - a, c + 1)
            clipped.append((a, b))
        self.busy = _merge(clipped)
        self.busy_s = sum(b - a for a, b in self.busy)

    def device_s(self, *parts: str) -> float:
        """Device seconds of the kernels whose name holds any of ``parts``."""
        return sum(s for n, (s, _) in self.kernels.items() if any(p in n for p in parts))

    def calls(self, *parts: str) -> int:
        return sum(c for n, (_, c) in self.kernels.items() if any(p in n for p in parts))

    def top_ops(self, k: int = 10) -> list:
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:k]
        return [[n, s] for n, (s, _) in ranked]

    def _label(self, t: float) -> str:
        inside = [(b - a, n) for n, a, b in self.spans if a <= t < b]
        return min(inside)[1] if inside else "window"

    def idle_gaps(self, k: int = 10) -> list:
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self._label(t), g] for g, t in gaps[:k]]


@contextlib.contextmanager
def window(on_card: bool):
    """Profile the body; yields a dict that holds ``"trace"`` (a
    :class:`Trace`) once the body has ended.  The body's calls mark
    themselves with :func:`span`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    out: dict = {}
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            yield out
            if on_card:
                torch.cuda.synchronize()
    out["trace"] = Trace(prof.profiler.kineto_results.events())


def span(name: str):
    """A benchmark span around a call into the program (a no-op cost
    outside a profiled window)."""
    from torch.profiler import record_function

    return record_function("bench." + name)
