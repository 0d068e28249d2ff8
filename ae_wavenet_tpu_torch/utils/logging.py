"""Metrics as JSON lines, one record per log point.

Counterpart of ``ae_wavenet_tpu.utils.logging.MetricsLogger`` without the
TensorBoard writer (not ported yet, ROADMAP.md)."""

from __future__ import annotations

import json
import sys
from typing import IO


class MetricsLogger:
    def __init__(self, stream: IO | None = None):
        self.stream = stream if stream is not None else sys.stdout

    def log(self, step: int, metrics: dict) -> None:
        def coerce(v):
            try:
                return float(v)
            except (TypeError, ValueError):
                return v  # strings and paths pass through

        rec = {"step": step, **{k: coerce(v) for k, v in metrics.items()}}
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()
