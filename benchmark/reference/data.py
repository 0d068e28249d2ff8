"""What the program derives from the raw packed dataset, worked out again:
the training windows of a step, the step's random draws, and the frame
statistics of ``SpecConfig.norm="dataset"``.  The arithmetic is the
published layout of the packed format and of the training loop (windows
a pure function of (seed, step); draws from a generator seeded by (seed,
step) in the bottleneck's order), restated in numpy and torch.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark.reference import mfcc
from benchmark.reference.vconv import Range


class Packed:
    """A packed int16 dataset (``PREFIX.dat`` and its ``PREFIX.json``)."""

    def __init__(self, prefix: str):
        with open(prefix + ".json") as f:
            index = json.load(f)
        self.data = np.memmap(prefix + ".dat", dtype="<i2", mode="r")
        clips = index["clips"]
        self.offsets = np.array([c["offset"] for c in clips], np.int64)
        self.lengths = np.array([c["length"] for c in clips], np.int64)
        self.speakers = np.array([c["speaker"] for c in clips], np.int32)

    def batch_at(self, u_len: int, batch: int, seed: int, step: int):
        """(wav [batch, u_len] int16, speaker [batch]) of training step
        ``step``: clips drawn in proportion to their valid positions, one
        uniform offset each, from ``default_rng([seed, step])``."""
        valid = self.lengths - u_len + 1
        eligible = np.nonzero(valid > 0)[0]
        w = valid[eligible].astype(np.float64)
        rng = np.random.default_rng([seed, step])
        rows = rng.choice(eligible, size=batch, p=w / w.sum())
        offs = self.offsets[rows] + (
            rng.random(batch) * (self.lengths[rows] - u_len + 1)).astype(np.int64)
        wav = np.stack([np.asarray(self.data[o : o + u_len]) for o in offs])
        return wav, self.speakers[rows]


def step_generator(seed: int, step: int, device):
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def vq_draws(bn_cfg, batch: int, tz: int, generator, device) -> dict:
    """The VQ bottleneck's draws of one step, in its order: restart
    candidates [G, K], then jitter uniforms [batch, 1, tz]."""
    out = {}
    if bn_cfg.vq_restart_thresh > 0.0:
        out["restart_idx"] = torch.randint(0, batch * tz, (bn_cfg.vq_groups, bn_cfg.vq_k),
                                           generator=generator, device=device)
    if bn_cfg.jitter_p > 0.0:
        out["jitter_u"] = torch.rand((batch, 1, tz), generator=generator, device=device)
    return out


def frame_stats(prefix: str, spec_cfg) -> tuple:
    """Per-channel mean and variance (float64 sums) of the MFCC stack over
    every clip long enough for one frame."""
    with open(prefix + ".json") as f:
        index = json.load(f)
    dat = np.memmap(prefix + ".dat", dtype="<i2", mode="r")
    n_ch = 3 * spec_cfg.n_mfcc
    s1, s2, count = np.zeros(n_ch), np.zeros(n_ch), 0
    min_len = len(spec_cfg.geometry().in_range(Range(0, 1)))
    for clip in index["clips"]:
        x = dat[clip["offset"] : clip["offset"] + clip["length"]]
        if len(x) < min_len:
            continue
        wav = torch.from_numpy(x.astype(np.float32) * (1.0 / 32768.0))
        frames = mfcc.mfcc_delta_stack(wav, spec_cfg).numpy().astype(np.float64)
        s1 += frames.sum(axis=-1)
        s2 += (frames ** 2).sum(axis=-1)
        count += frames.shape[-1]
    mean = s1 / count
    var = np.maximum(s2 / count - mean ** 2, 1e-12)
    return tuple(float(v) for v in mean), tuple(float(v) for v in var)
