"""16-bit mono wav files with the standard library's ``wave`` module."""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, x, sample_rate: int = 16000) -> None:
    """x: float array in [-1, 1] (scaled by 32767, rounded) or int16."""
    x = np.asarray(x)
    if x.dtype != np.int16:
        x = np.clip(np.rint(np.asarray(x, np.float64) * 32767),
                    -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(x.astype("<i2").tobytes())


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """-> (int16 samples, sample rate); several channels are averaged."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        ch = w.getnchannels()
    x = np.frombuffer(raw, dtype="<i2")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1).astype(np.int16)
    return x, sr
