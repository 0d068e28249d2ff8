"""Metrics as JSON lines, one record per log point, and optionally as
TensorBoard scalars.

Counterpart of ``ae_wavenet_tpu.utils.logging.MetricsLogger``.  With
``tb_logdir`` every numeric metric also goes to
``torch.utils.tensorboard.SummaryWriter``.  Where that writer cannot be
imported (it needs the ``tensorboard`` package), construction raises: the
reference turns TensorBoard off without a word there.
"""

from __future__ import annotations

import json
import sys
from typing import IO


class MetricsLogger:
    def __init__(self, stream: IO | None = None, tb_logdir: str | None = None):
        self.stream = stream if stream is not None else sys.stdout
        self._tb = None
        if tb_logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise RuntimeError(
                    f"tb_logdir={tb_logdir!r} needs torch.utils.tensorboard, which "
                    f"cannot be imported ({e}); install the tensorboard package or "
                    "leave --tb-logdir out") from e
            self._tb = SummaryWriter(tb_logdir)

    def log(self, step: int, metrics: dict) -> None:
        def coerce(v):
            try:
                return float(v)
            except (TypeError, ValueError):
                return v  # strings and paths pass through

        rec = {"step": step, **{k: coerce(v) for k, v in metrics.items()}}
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step" and isinstance(v, float):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
