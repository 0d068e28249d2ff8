"""Every test of the benchmark sees the tiny counterparts of every cell:
the flow vocoder's and the mixture vocoder's training cell's are
registered by importing ``tests/flow_cells.py``."""

from benchmark.tests import flow_cells  # noqa: F401
