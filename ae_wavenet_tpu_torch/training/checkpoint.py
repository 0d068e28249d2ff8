"""Checkpoints: async saves, retention, the LATEST and BEST pointers.

Counterpart of ``ae_wavenet_tpu.training.checkpoint`` in the export format
of ``training/weights.py``: one file ``step_XXXXXXXX.pt`` per step holding
``{"step", "run_config_json", "state"}`` (parameters, bottleneck state and
optimizer state by their dotted names), so the config travels inside the
file and a checkpoint loads in either package.  ``step`` is also the data
stream's position (the sampler is counter-based).

A file is written to ``*.tmp`` and renamed, so a file that exists is
complete and a crash mid-write leaves nothing loadable.  :class:`Saver`
writes on a background thread from a host snapshot the caller took, one
save in flight; the ``LATEST`` pointer and the ``BEST`` sidecar are written
after the file is complete, and retention prunes after that.
"""

from __future__ import annotations

import json
import os
import re
import threading

import torch

from ae_wavenet_tpu_torch.training import weights
from ae_wavenet_tpu_torch.utils import config as config_mod

_CKPT = re.compile(r"step_(\d{8})\.pt")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def _atomic_write(path: str, text: str) -> None:
    """tmp + rename: a sidecar that exists is fully written."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_sidecars(ckpt_dir: str, step: int,
                    best: tuple[int, float] | None = None) -> None:
    """LATEST, then BEST, both after the step's file is complete: neither
    ever points at a half-written file."""
    _atomic_write(os.path.join(ckpt_dir, "LATEST"), str(step))
    if best is not None:
        _atomic_write(os.path.join(ckpt_dir, "BEST"),
                      json.dumps({"step": best[0], "metric": best[1]}))


def complete_steps(ckpt_dir: str) -> set[int]:
    """Loadable steps: the files under their final name (a write in flight
    or interrupted is a ``*.tmp``, which the pattern skips)."""
    if not os.path.isdir(ckpt_dir):
        return set()
    return {int(m.group(1)) for f in os.listdir(ckpt_dir)
            if (m := _CKPT.fullmatch(f))}


def _pointed(ckpt_dir: str) -> int | None:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def prune(ckpt_dir: str, keep_last: int, protect=()) -> list[int]:
    """Delete all but the newest ``keep_last`` complete checkpoints.  Never
    removes the ``protect``-ed steps (the best-holdout checkpoint), the step
    the LATEST pointer names (a rollback-resume's intent) or a write in
    flight.  Call only after the current save's sidecars are written
    (:class:`Saver` does).  Returns the pruned steps."""
    if keep_last <= 0:
        return []
    complete = complete_steps(ckpt_dir)
    keep = set(sorted(complete)[-keep_last:]) | set(protect)
    pointed = _pointed(ckpt_dir)
    if pointed is not None:
        keep.add(pointed)
    pruned = []
    for step in sorted(complete - keep):
        try:
            os.remove(checkpoint_path(ckpt_dir, step))
        except OSError:
            continue
        pruned.append(step)
    return pruned


class Saver:
    """Async checkpoint writer; one save in flight at a time.

    ``save()`` returns once the write is handed to a background thread;
    ``state`` must be a host snapshot nothing else writes to
    (``weights.export_state``).  The previous save, if still writing, is
    finished first.  Call ``wait()`` before the process exits or before
    reading the step back; an error of the background write is raised
    there."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, ckpt_dir: str, step: int, state: dict,
             cfg: config_mod.RunConfig, blocking: bool = False,
             keep_last: int = 0, best: tuple[int, float] | None = None) -> str:
        """``keep_last`` > 0: after this save is complete, all but the newest
        ``keep_last`` checkpoints are pruned, except the ``best`` step
        (recorded in the ``BEST`` sidecar as {step, metric})."""
        self.wait()
        os.makedirs(ckpt_dir, exist_ok=True)
        path = checkpoint_path(ckpt_dir, step)

        def work():
            try:
                # overwrites: a preemption save and a final save may share a step
                weights.write_export(path, state, cfg, step)
                _write_sidecars(ckpt_dir, step, best)
                prune(ckpt_dir, keep_last, () if best is None else (best[0],))
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, name="checkpoint-writer")
        self._thread.start()
        if blocking:
            self.wait()
        return path

    def wait(self) -> None:
        """Block until the save in flight (if any) is complete with its
        sidecars and its pruning."""
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        error, self._error = self._error, None
        if error is not None:
            raise error

    close = wait


def save(ckpt_dir: str, step: int, state: dict, cfg: config_mod.RunConfig) -> str:
    """Blocking one-shot save."""
    return Saver().save(ckpt_dir, step, state, cfg, blocking=True)


def latest_step(ckpt_dir: str) -> int | None:
    """The step a resume should pick: the LATEST pointer if it names a
    loadable step (after a rollback-resume from an older step it must win
    over a newer, abandoned file), else the newest loadable step (pointer
    absent or stale), else None."""
    complete = complete_steps(ckpt_dir)
    pointed = _pointed(ckpt_dir)
    if pointed is not None and pointed in complete:
        return pointed
    return max(complete) if complete else None


def best_info(ckpt_dir: str) -> tuple[int, float] | None:
    """(step, metric) of the best-holdout checkpoint from the ``BEST``
    sidecar, or None when it is absent or its step is no longer loadable."""
    try:
        with open(os.path.join(ckpt_dir, "BEST")) as f:
            d = json.load(f)
        step, metric = int(d["step"]), float(d["metric"])
    except (OSError, ValueError, KeyError, TypeError):
        return None
    return (step, metric) if step in complete_steps(ckpt_dir) else None


def _resolve(ckpt_dir: str, step: int | None) -> int:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return step


def load_config(ckpt_dir: str, step: int | None = None):
    """-> (step, RunConfig) without reading the tensors (the file is
    memory-mapped)."""
    step = _resolve(ckpt_dir, step)
    payload = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu",
                         weights_only=True, mmap=True)
    return step, config_mod.from_json(payload["run_config_json"])


def load(ckpt_dir: str, step: int | None = None):
    """-> (step, {dotted name: tensor}, RunConfig); ``step`` defaults to
    :func:`latest_step`."""
    return weights.load_named(checkpoint_path(ckpt_dir, _resolve(ckpt_dir, step)))
