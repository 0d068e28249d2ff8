"""Device milliseconds per traced request of the work launched inside the
program's spans ``awt.flow.upsample``, ``awt.flow.cond`` (the cond
projections' GEMMs) and ``awt.flow.coupling`` (the couplings, W^-1 and the
early noise), matched to its launch by the profiler's correlation id, not
by kernel name (``benchmark/spans.py``); None where the program has none of
these spans."""

from benchmark import spans

NAMES = ("flow.upsample", "flow.cond", "flow.coupling")


def read(run):
    t = run.trace
    if not (isinstance(t, spans.ProgramTrace) and t.kernels
            and any(n in NAMES for n, _, _ in t.program)):
        return None
    return 1e3 * sum(t.device_launched_in(n) for n in NAMES) / run.window["trace_requests"]
