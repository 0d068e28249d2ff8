"""Packed datasets: one int16 ``PREFIX.dat`` holding every clip back to back
and a ``PREFIX.json`` index.

The format is the reference's (``ae_wavenet_tpu.data.preprocess`` writes
it): the index holds ``sample_rate``, ``n_speakers``, ``speakers`` (names)
and ``clips``, a list of ``{"offset", "length", "speaker"}`` in samples.
Datasets written by either package read in the other.
"""

from __future__ import annotations

import json

import numpy as np


class PackedDataset:
    """Memory-mapped packed int16 wav and its index."""

    def __init__(self, prefix: str):
        with open(prefix + ".json") as f:
            self.index = json.load(f)
        self.data = np.memmap(prefix + ".dat", dtype="<i2", mode="r")
        self.sample_rate = self.index["sample_rate"]
        self.n_speakers = self.index["n_speakers"]
        clips = self.index["clips"]
        self.offsets = np.array([c["offset"] for c in clips], np.int64)
        self.lengths = np.array([c["length"] for c in clips], np.int64)
        self.speakers = np.array([c["speaker"] for c in clips], np.int32)

    def __len__(self) -> int:
        return len(self.offsets)

    def clip(self, i: int, max_len: int | None = None) -> np.ndarray:
        """Clip ``i`` as int16, cut to its first ``max_len`` samples."""
        n = int(self.lengths[i]) if max_len is None else min(int(self.lengths[i]), max_len)
        o = int(self.offsets[i])
        return np.array(self.data[o : o + n])


class WindowSampler:
    """Deterministic random-window batches: ``batch_at(step)``, as the
    reference's ``data/dataset.py`` WindowSampler.

    Clips shorter than the window are excluded; eligible clips are drawn
    in proportion to their number of valid window positions.  The batch
    at step s is a pure function of (seed, s) (``default_rng([seed, s])``),
    so a resume needs no iterator state.  The rows are gathered by the C
    helper (``data/native.gather_windows``), as the reference's are."""

    def __init__(self, ds: PackedDataset, u_len: int, batch_sz: int,
                 seed: int = 0, clip_indices=None):
        """clip_indices: optional subset of clip rows (train/holdout)."""
        self.ds = ds
        self.u_len = int(u_len)
        self.batch_sz = int(batch_sz)
        self.seed = int(seed)
        valid = ds.lengths - self.u_len + 1
        mask = valid > 0
        if clip_indices is not None:
            sub = np.zeros(len(ds), bool)
            sub[np.asarray(clip_indices, np.int64)] = True
            mask &= sub
        self.eligible = np.nonzero(mask)[0]
        if len(self.eligible) == 0:
            raise ValueError(
                f"no clip is >= the window length {u_len}; max clip length is "
                f"{int(ds.lengths.max()) if len(ds) else 0}")
        w = valid[self.eligible].astype(np.float64)
        self.probs = w / w.sum()

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (wav [B, u_len] int16, speaker [B] int32)."""
        rng = np.random.default_rng([self.seed, step])
        rows = rng.choice(self.eligible, size=self.batch_sz, p=self.probs)
        max_off = self.ds.lengths[rows] - self.u_len
        offs = self.ds.offsets[rows] + (
            rng.random(self.batch_sz) * (max_off + 1)).astype(np.int64)
        from ae_wavenet_tpu_torch.data import native

        return native.gather_windows(self.ds.data, offs, self.u_len), self.ds.speakers[rows]


def write_packed(prefix: str, clips, speakers, speaker_names,
                 sample_rate: int = 16000, extra: dict | None = None) -> dict:
    """Write int16 ``clips`` (one array each, any iterable: each is written
    as it comes) with their speaker indices; ``extra`` adds keys at the end
    of the index."""
    index_clips, offset = [], 0
    with open(prefix + ".dat", "wb") as dat:
        for x, spk in zip(clips, speakers):
            x = np.asarray(x, "<i2")
            dat.write(x.tobytes())
            index_clips.append({"offset": offset, "length": len(x), "speaker": int(spk)})
            offset += len(x)
    index = {"sample_rate": sample_rate, "n_speakers": len(speaker_names),
             "speakers": list(speaker_names), "clips": index_clips, **(extra or {})}
    with open(prefix + ".json", "w") as f:
        json.dump(index, f)
    return index


def make_synthetic_dataset(prefix: str, n_clips: int = 10, n_speakers: int = 4,
                           clip_len: tuple[int, int] = (40000, 80000),
                           sample_rate: int = 16000, seed: int = 0) -> dict:
    """A seeded speech-like fixture: segments of 0.1-0.25 s, each voiced
    (four harmonics of a speaker-dependent f0), a noise burst, or near
    silence.  Clip ``i`` belongs to speaker ``i % n_speakers``.  A smaller
    stand-in for the reference's fixture; the signals differ."""
    rng = np.random.default_rng(seed)
    clips, speakers = [], []
    for i in range(n_clips):
        spk = i % n_speakers
        n = int(rng.integers(*clip_len))
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
        clips.append(np.clip(np.rint(x / np.abs(x).max() * 12000), -32768, 32767))
        speakers.append(spk)
    return write_packed(prefix, clips, speakers,
                        [f"synth{j}" for j in range(n_speakers)], sample_rate)
