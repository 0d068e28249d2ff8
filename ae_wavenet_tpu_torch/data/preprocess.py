"""Offline preprocessing: a catalog of clips -> a packed int16 dataset, the
reference's synthetic fixtures, and the dataset's frame statistics.

Counterpart of ``ae_wavenet_tpu.data.preprocess``.  The catalog has one
``<speaker_id> <audio_path>`` line per clip; each clip is decoded at the
target rate and written through ``data/dataset.write_packed``.  ``.wav``
files are read with the standard ``wave`` module (16-bit PCM; channels are
averaged) and resampled with ``scipy.signal.resample_poly``; anything else
goes through ``ffmpeg``, which must be on PATH for it.

The synthetic generators are numpy only and copy the reference's
arithmetic in its order, so the same arguments give the same ``.dat`` and
``.json`` bytes in either package.  (``data/dataset.make_synthetic_dataset``
is the port's own, smaller fixture with other signals.)
"""

from __future__ import annotations

import json
import shutil
import subprocess
import wave

import numpy as np

from ae_wavenet_tpu_torch.data.dataset import write_packed


def _decode_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        sw = w.getsampwidth()
        ch = w.getnchannels()
    if sw != 2:
        raise ValueError(f"{path}: only 16-bit PCM wav supported, got width {sw}")
    x = np.frombuffer(raw, dtype="<i2")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1).astype(np.int16)
    return x, sr


def _decode_ffmpeg(path: str, sample_rate: int) -> tuple[np.ndarray, int]:
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"cannot decode {path}: ffmpeg not available and file is not .wav")
    out = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", path, "-f", "s16le", "-ac", "1",
         "-ar", str(sample_rate), "-"],
        capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype="<i2"), sample_rate


def _resample(x: np.ndarray, sr: int, target: int) -> np.ndarray:
    if sr == target:
        return x
    from scipy.signal import resample_poly

    g = np.gcd(sr, target)
    y = resample_poly(x.astype(np.float32), target // g, sr // g)
    return np.clip(np.rint(y), -32768, 32767).astype(np.int16)


def load_clip(path: str, sample_rate: int = 16000) -> np.ndarray:
    """One audio file -> int16 mono samples at ``sample_rate``."""
    if path.lower().endswith(".wav"):
        x, sr = _decode_wav(path)
    else:
        x, sr = _decode_ffmpeg(path, sample_rate)
    return _resample(x, sr, sample_rate)


def preprocess_catalog(catalog_path: str, out_prefix: str,
                       sample_rate: int = 16000) -> dict:
    """Catalog lines ``<speaker_id> <audio_path>`` (blank lines and ``#``
    comments skipped) -> ``<out_prefix>.dat`` and ``.json``; speakers are
    numbered in sorted order of their ids.  Clips are decoded one at a
    time as they are written."""
    entries = []
    with open(catalog_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            spk, path = line.split(None, 1)
            entries.append((spk, path))
    speakers = sorted({spk for spk, _ in entries})
    spk_id = {s: i for i, s in enumerate(speakers)}
    return write_packed(out_prefix, (load_clip(p, sample_rate) for _, p in entries),
                        [spk_id[s] for s, _ in entries], speakers, sample_rate)


# the reference's generator versions, stored in the index as
# "fixture_version": v2 has 50 Hz random-walk innovations, v3 100 Hz
# sample-and-hold innovations
SYNTH_FIXTURE_VERSION = 2
SYNTH_FIXTURE_VERSION_V3 = 31
_STYLE_VERSIONS = {"v2": SYNTH_FIXTURE_VERSION, "v3": SYNTH_FIXTURE_VERSION_V3}


def synthetic_fixture_current(prefix: str, style: str = "v2") -> bool:
    """True iff a fixture at ``prefix`` exists and was written by the
    current generator of ``style``."""
    try:
        with open(prefix + ".json") as f:
            return json.load(f).get("fixture_version") == _STYLE_VERSIONS[style]
    except (OSError, ValueError):
        return False


def make_synthetic_dataset(out_prefix: str, n_clips: int = 10, n_speakers: int = 4,
                           clip_len: tuple[int, int] = (40000, 80000),
                           sample_rate: int = 16000, seed: int = 0,
                           style: str = "v2") -> dict:
    """The reference's seeded speech-like fixture: segments of 0.1-0.25 s,
    voiced (harmonics of a speaker-dependent f0), band-passed noise or near
    silence.  ``style="v2"``: pitch, harmonic amplitudes and noise envelope
    follow random walks with fresh innovations at 50 Hz, interpolated to
    the sample rate.  ``style="v3"``: an 8-band noise bed and per-harmonic
    amplitudes redrawn in every 100 Hz block (sample-and-hold), which the
    past audio cannot predict but the MFCC frames show.  Clip ``i``
    belongs to speaker ``i % n_speakers``; every clip is scaled to a peak
    of 12,000."""
    gen_clip = {"v2": _synth_clip_v2, "v3": _synth_clip_v3}[style]
    rng = np.random.default_rng(seed)

    def clips():
        for i in range(n_clips):
            n = int(rng.integers(*clip_len))
            x = gen_clip(rng, n, i % n_speakers, sample_rate)
            yield np.clip(np.rint(x / np.max(np.abs(x)) * 12000), -32768,
                          32767).astype("<i2")

    return write_packed(out_prefix, clips(), [i % n_speakers for i in range(n_clips)],
                        [f"synth{j}" for j in range(n_speakers)], sample_rate,
                        extra={"fixture_version": _STYLE_VERSIONS[style]})


def _synth_clip_v2(rng, n: int, spk: int, sample_rate: int) -> np.ndarray:
    x = np.zeros(n)
    pos = 0
    f0_base = 90.0 + 30.0 * spk
    hop = sample_rate // 50  # innovation rate: the latent frame rate

    def walk(seg: int, sigma: float) -> np.ndarray:
        """exp(random walk) at 50 Hz, interpolated to the sample rate,
        starting at 1.0."""
        nfr = seg // hop + 2
        w = np.cumsum(rng.normal(0.0, sigma, size=nfr))
        w -= w[0]
        return np.exp(np.interp(np.arange(seg) / hop, np.arange(nfr), w))

    while pos < n:
        seg = int(rng.integers(sample_rate // 10, sample_rate // 4))
        seg = min(seg, n - pos)
        kind = rng.random()
        if kind < 0.45:  # voiced: harmonics, drifting f0 and amplitudes
            f0 = f0_base * rng.uniform(0.7, 2.2)
            ph = rng.uniform(0, 2 * np.pi)
            phase = 2.0 * np.pi * np.cumsum(f0 * walk(seg, 0.035)) / sample_rate
            s = np.zeros(seg)
            for k in range(1, 5):
                a_k = (rng.uniform(0.1, 1.0) / k) * walk(seg, 0.12)
                s += a_k * np.sin(k * phase + ph * k)
            s *= rng.uniform(0.3, 1.0)
        elif kind < 0.8:  # unvoiced: band-passed noise burst with an envelope
            w = rng.normal(size=seg)
            fc = rng.uniform(500, 6000)
            bw = rng.uniform(300, 1500)
            spec = np.fft.rfft(w)
            f = np.fft.rfftfreq(seg, 1 / sample_rate)
            spec *= np.exp(-0.5 * ((f - fc) / bw) ** 2)
            s = np.fft.irfft(spec, seg) * walk(seg, 0.18)
            s *= rng.uniform(0.2, 0.7) / (np.std(s) + 1e-9)
        else:  # near silence
            s = 0.01 * rng.normal(size=seg)
        # short fades at the segment edges
        env = np.minimum(1.0, np.minimum(np.arange(seg), seg - 1 - np.arange(seg)) / 80.0)
        x[pos : pos + seg] = s * env
        pos += seg
    x += 0.005 * rng.normal(size=n)
    return x


V3_N_BANDS = 8          # noise-bed bands, each with its own per-block gain
V3_GAIN_SPREAD = 1.5    # per-band log-gain ~ U(-spread, +spread)
V3_SMOOTH = 25          # samples of smoothing at each hold transition


def _hold(rng, n_blocks: int, hop: int, seg: int, lo: float, hi: float,
          log: bool = True) -> np.ndarray:
    """Per-block i.i.d. draws held over each block of ``hop`` samples,
    smoothed over V3_SMOOTH samples (two box passes)."""
    if log:
        v = np.exp(rng.uniform(np.log(lo), np.log(hi), size=n_blocks))
    else:
        v = rng.uniform(lo, hi, size=n_blocks)
    y = np.repeat(v, hop)[:seg].astype(np.float64)
    k = V3_SMOOTH
    box = np.ones(k) / k
    y = np.pad(y, (k, k), mode="edge")
    return np.convolve(np.convolve(y, box, "same"), box, "same")[k:-k]


def _synth_clip_v3(rng, n: int, spk: int, sample_rate: int) -> np.ndarray:
    x = np.zeros(n)
    pos = 0
    f0_base = 90.0 + 30.0 * spk
    hop = sample_rate // 100  # innovation rate: the MFCC frame rate
    edges = np.geomspace(300.0, 7000.0, V3_N_BANDS + 1)

    while pos < n:
        seg = int(rng.integers(sample_rate // 10, sample_rate // 4))
        seg = min(seg, n - pos)
        nb = seg // hop + 1
        kind = rng.random()
        if kind < 0.9:  # speech-like: noise bed and, mostly, harmonics
            f = np.fft.rfftfreq(seg, 1 / sample_rate)
            s = np.zeros(seg)
            for b in range(V3_N_BANDS):
                spec = np.fft.rfft(rng.normal(size=seg))
                spec *= (f >= edges[b]) & (f < edges[b + 1])
                nz = np.fft.irfft(spec, seg)
                nz /= nz.std() + 1e-9
                g = np.exp(V3_GAIN_SPREAD)
                s += _hold(rng, nb, hop, seg, 1.0 / g, g) * nz
            s *= rng.uniform(0.15, 0.5) / V3_N_BANDS ** 0.5
            if kind < 0.55:  # voiced: a harmonic stack over the bed
                f0 = f0_base * rng.uniform(0.7, 2.2)
                ph = rng.uniform(0, 2 * np.pi)
                nfr = nb + 1
                w = np.cumsum(rng.normal(0.0, 0.02, size=nfr))
                drift = np.exp(np.interp(np.arange(seg) / hop,
                                         np.arange(nfr), w - w[0]))
                phase = 2.0 * np.pi * np.cumsum(f0 * drift) / sample_rate
                h = np.zeros(seg)
                for k in range(1, 5):
                    a_k = _hold(rng, nb, hop, seg, 0.05, 1.0) / k
                    h += a_k * np.sin(k * phase + ph * k)
                s += h * rng.uniform(0.4, 1.0)
        else:  # near silence
            s = 0.01 * rng.normal(size=seg)
        env = np.minimum(1.0, np.minimum(np.arange(seg), seg - 1 - np.arange(seg)) / 80.0)
        x[pos : pos + seg] = s * env
        pos += seg
    x += 0.005 * rng.normal(size=n)
    return x


def dataset_frame_stats(prefix: str, spec_cfg) -> tuple:
    """Per-channel mean and variance of the MFCC stack over every clip of
    the packed dataset at ``prefix`` that covers one frame: the fixed
    statistics of ``SpecConfig.norm="dataset"``.  The frames come from
    ``audio/mfcc.mfcc_delta_stack`` on the CPU, one clip at a time; the
    sums are float64.  -> (mean, var) as tuples of 3 * n_mfcc floats."""
    import torch

    from ae_wavenet_tpu_torch.audio.mfcc import mfcc_delta_stack
    from ae_wavenet_tpu_torch.geometry.vconv import Range

    with open(prefix + ".json") as f:
        index = json.load(f)
    dat = np.memmap(prefix + ".dat", dtype="<i2", mode="r")
    n_ch = 3 * spec_cfg.n_mfcc
    s1 = np.zeros(n_ch, np.float64)
    s2 = np.zeros(n_ch, np.float64)
    count = 0
    min_len = len(spec_cfg.geometry().in_range(Range(0, 1)))
    for clip in index["clips"]:
        x = dat[clip["offset"] : clip["offset"] + clip["length"]]
        if len(x) < min_len:
            continue
        wav = torch.from_numpy(x.astype(np.float32) * (1.0 / 32768.0))
        frames = mfcc_delta_stack(wav, spec_cfg).numpy().astype(np.float64)
        s1 += frames.sum(axis=-1)
        s2 += (frames ** 2).sum(axis=-1)
        count += frames.shape[-1]
    if count == 0:
        raise ValueError(f"no clip under {prefix} is long enough for stats")
    mean = s1 / count
    var = np.maximum(s2 / count - mean ** 2, 1e-12)
    return tuple(float(v) for v in mean), tuple(float(v) for v in var)
