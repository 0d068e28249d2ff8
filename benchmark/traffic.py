"""The one generator of the benchmark's inputs.

A traffic file (``benchmark/traffic/<name>.json``) names the loop that
drives the program (``benchmark/loops/<loop>.py``) and its parameters:
utterance lengths, the packed dataset's clips and speakers, batch, steps a
call, generated samples, temperature, which requests are greedy and how
many rows of a request the check compares.  The
utterances are seeded speech-like signals: segments of 0.1-0.25 s, voiced
(four harmonics of a speaker-dependent f0), noise bursts or near silence;
this is a frozen copy of the program's ``data/dataset.make_synthetic_dataset``
with the packed format's writer.
"""

from __future__ import annotations

import json
import os

import numpy as np


def utterance(rng: np.random.Generator, n: int, spk: int, sample_rate: int) -> np.ndarray:
    """One int16 utterance of ``n`` samples for speaker ``spk``."""
    x = np.zeros(n)
    pos = 0
    while pos < n:
        seg = min(int(rng.integers(sample_rate // 10, sample_rate // 4)), n - pos)
        kind, t = rng.random(), np.arange(seg) / sample_rate
        if kind < 0.45:
            f0 = (90.0 + 30.0 * spk) * rng.uniform(0.7, 2.2)
            s = sum(rng.uniform(0.1, 1.0) / k * np.sin(2 * np.pi * k * f0 * t)
                    for k in range(1, 5))
        elif kind < 0.8:
            s = rng.normal(size=seg) * rng.uniform(0.2, 0.7)
        else:
            s = 0.01 * rng.normal(size=seg)
        edge = np.minimum(np.arange(seg), seg - 1 - np.arange(seg))
        x[pos : pos + seg] = s * np.minimum(1.0, edge / 80.0)
        pos += seg
    x += 0.005 * rng.normal(size=n)
    return np.clip(np.rint(x / np.abs(x).max() * 12000), -32768, 32767).astype("<i2")


def clips(params: dict, seed: int):
    """(list of int16 clips, speaker of each) for ``params``: ``n_clips``
    clips of ``clip_len`` [lo, hi) samples, clip i spoken by speaker
    ``i % n_speakers``; the f0 of a speaker repeats every ``f0_classes``."""
    rng = np.random.default_rng([int(seed), 0x7A])
    lo, hi = params["clip_len"]
    n_spk, f0c = params["n_speakers"], params.get("f0_classes", 8)
    sr = params.get("sample_rate", 16000)
    out, spk = [], []
    for i in range(params["n_clips"]):
        s = i % n_spk
        out.append(utterance(rng, int(rng.integers(lo, hi)), s % f0c, sr))
        spk.append(s)
    return out, np.array(spk, np.int64)


def write_packed(prefix: str, data, speakers, n_speakers: int,
                 sample_rate: int = 16000) -> str:
    """Write ``data`` as a packed dataset at ``prefix`` (``.dat`` + ``.json``)."""
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    index, offset = [], 0
    with open(prefix + ".dat", "wb") as dat:
        for x, s in zip(data, speakers):
            dat.write(np.asarray(x, "<i2").tobytes())
            index.append({"offset": offset, "length": len(x), "speaker": int(s)})
            offset += len(x)
    with open(prefix + ".json", "w") as f:
        json.dump({"sample_rate": sample_rate, "n_speakers": n_speakers,
                   "speakers": [f"synth{j}" for j in range(n_speakers)],
                   "clips": index}, f)
    return prefix


def remove_packed(prefix: str) -> None:
    for ext in (".dat", ".json"):
        try:
            os.remove(prefix + ext)
        except FileNotFoundError:
            pass


def greedy(params: dict, i: int) -> bool:
    """Whether request i is decoded greedily (every ``greedy_every``-th,
    from the first)."""
    every = params.get("greedy_every", 0)
    return every > 0 and i % every == 0


def order(params: dict, seed: int, n_requests: int, pool: int, batch: int) -> np.ndarray:
    """[n_requests, batch] utterance indices: the pool in a seeded order,
    reshuffled each time it runs out."""
    rng = np.random.default_rng([int(seed), 0x0D])
    need, out = n_requests * batch, []
    while sum(len(o) for o in out) < need:
        out.append(rng.permutation(pool))
    return np.concatenate(out)[:need].reshape(n_requests, batch)
