"""Host-to-device input pipeline for the training loop.

Counterpart of ``ae_wavenet_tpu.data.loader.device_batches``: a producer
thread draws the batches (``WindowSampler.batch_at``, pure in (seed,
step)), pins them in host memory and copies them to the device with
``non_blocking=True``, ``prefetch`` batches ahead of the consumer, so the
copy of batch s+1 overlaps the compute of batch s.  Batches stay int16;
the frontend runs on the device inside the step.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from ae_wavenet_tpu_torch.data.dataset import WindowSampler


def device_batches(sampler: WindowSampler, start_step: int, n_steps: int,
                   device, prefetch: int = 2, block: int = 1,
                   stats: dict | None = None) -> Iterator[tuple]:
    """Yield (step, (wav, spk)) with the tensors on ``device``.

    ``block`` K > 1 stages K consecutive batches as one [K, B, ...] pair
    and yields (first step, (wav block, spk block)); ``n_steps`` must be a
    multiple of K.  ``stats``, when given, accumulates the seconds the
    consumer waited for a batch under ``"loader_wait"``.  An early stop of
    the consumer (break, exception) stops the producer."""
    if n_steps % block:
        raise ValueError(f"n_steps={n_steps} not a multiple of block={block}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:  # the producer selects it
        device = torch.device("cuda", torch.cuda.current_device())
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def make_item(s):
        if block == 1:
            wav, spk = sampler.batch_at(s)
        else:
            ws, ks = zip(*(sampler.batch_at(s + i) for i in range(block)))
            wav, spk = np.stack(ws), np.stack(ks)
        return s, (put(wav), put(spk.astype(np.int64)))

    def producer():
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            for s in range(start_step, start_step + n_steps, block):
                item = make_item(s)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(None)
        except BaseException as e:  # surface in the consumer, never deadlock
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if stats is not None:
                stats["loader_wait"] = stats.get("loader_wait", 0.0) + (
                    time.perf_counter() - t0)
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5)
