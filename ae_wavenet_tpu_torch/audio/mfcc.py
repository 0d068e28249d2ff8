"""MFCC (+delta, +delta-delta) frontend as matmuls on torch tensors.

Counterpart of ``ae_wavenet_tpu.audio.mfcc``: valid frames only (no
centering), a real DFT as two matmuls, Slaney mel filterbank, orthonormal
DCT-II and regression deltas as valid convolutions along time.  The
constant matrices are built by numpy exactly as the reference builds them.
:func:`features` gives a configuration's conditioning frames: the MFCC
stack, or at ``n_mfcc`` = 0 (``SpecConfig.log_mel``) the log-mel bands
alone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ae_wavenet_tpu_torch.utils.config import SpecConfig


def mel_filterbank(cfg: SpecConfig) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, n_fft//2 + 1]."""
    fmax = cfg.mel_fmax if cfg.mel_fmax is not None else cfg.sample_rate / 2.0
    log_step = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3.0)
        return np.where(f >= 1000.0,
                        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / log_step,
                        mel)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)),
                        m * (200.0 / 3.0))

    n_bins = cfg.n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, n_bins)
    mel_pts = mel_to_hz(
        np.linspace(hz_to_mel(cfg.mel_fmin), hz_to_mel(fmax), cfg.n_mels + 2)
    )
    fb = np.zeros((cfg.n_mels, n_bins))
    for i in range(cfg.n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))
    return fb.astype(np.float32)


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_mfcc, n_mels]."""
    k = np.arange(n_mfcc)[:, None]
    n = np.arange(n_mels)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels)) * np.sqrt(2.0 / n_mels)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


def delta_kernel(wing: int) -> np.ndarray:
    """Regression delta filter, width 2*wing+1."""
    n = np.arange(-wing, wing + 1, dtype=np.float32)
    return n / np.sum(n * n)


def _dft_matrices(win_sz: int, n_fft: int):
    """Real DFT of a zero-padded window as [win, bins] cos/sin matrices."""
    if win_sz > n_fft:
        raise ValueError(
            f"win_sz {win_sz} > n_fft {n_fft}: the DFT matmul would alias "
            f"samples modulo n_fft instead of truncating like rfft(n=...)"
        )
    n_bins = n_fft // 2 + 1
    ang = (-2.0 * np.pi * np.arange(win_sz)[:, None]
           * np.arange(n_bins)[None, :] / n_fft)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.cache
def _constants(cfg: SpecConfig, device: str):
    """Frontend matrices on ``device`` (built once per config and device,
    and never evicted: a captured training step, training/chassis.py, reads
    them by address)."""
    cosm, sinm = _dft_matrices(cfg.win_sz, cfg.n_fft)
    arrays = {
        "window": np.hanning(cfg.win_sz + 1)[:-1].astype(np.float32),
        "cos": cosm, "sin": sinm,
        "mel_t": np.ascontiguousarray(mel_filterbank(cfg).T),
    }
    if not cfg.log_mel:  # the bands alone take no DCT
        arrays["dct_t"] = np.ascontiguousarray(dct_matrix(cfg.n_mfcc, cfg.n_mels).T)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _log_mel(wav: torch.Tensor, cfg: SpecConfig, c: dict) -> torch.Tensor:
    """wav [..., T] -> log-mel frames [..., F, n_mels] (valid frames)."""
    frames = wav.unfold(-1, cfg.win_sz, cfg.hop_sz)  # [..., F, win]
    fw = frames * c["window"]
    power = torch.square(fw @ c["cos"]) + torch.square(fw @ c["sin"])
    return torch.log(torch.clamp(power @ c["mel_t"], min=1e-10))


def log_mel_frames(wav: torch.Tensor, cfg: SpecConfig) -> torch.Tensor:
    """wav [..., T] float32 -> log-mel spectrogram [..., n_mels, F]: the
    MFCC frontend stopped before the DCT (the quality metric's
    representation, eval/quality.py)."""
    return _log_mel(wav, cfg, _constants(cfg, str(wav.device))).transpose(-1, -2)


def mfcc_frames(wav: torch.Tensor, cfg: SpecConfig) -> torch.Tensor:
    """wav [..., T] float32 -> MFCC [..., n_mfcc, F] with
    F = (T - win_sz)//hop + 1 (valid frames, no padding)."""
    c = _constants(cfg, str(wav.device))
    return (_log_mel(wav, cfg, c) @ c["dct_t"]).transpose(-1, -2)


def _delta(x: torch.Tensor, wing: int) -> torch.Tensor:
    """Valid regression delta along the last axis: [..., C, F] ->
    [..., C, F - 2*wing]."""
    k = delta_kernel(wing)
    n = x.shape[-1] - 2 * wing
    out = float(k[0]) * x[..., 0:n]
    for i in range(1, 2 * wing + 1):
        out = out + float(k[i]) * x[..., i : i + n]
    return out


def mfcc_delta_stack(wav: torch.Tensor, cfg: SpecConfig) -> torch.Tensor:
    """wav [..., T] -> [..., 3*n_mfcc, F'] aligned stack of MFCC, delta and
    delta-delta, all on the delta-delta frame lattice."""
    w = cfg.delta_wing
    mf = mfcc_frames(wav, cfg)
    d1 = _delta(mf, w)
    d2 = _delta(d1, w)
    return torch.cat(
        [mf[..., 2 * w : mf.shape[-1] - 2 * w], d1[..., w : d1.shape[-1] - w], d2],
        dim=-2,
    )


def features(wav: torch.Tensor, cfg: SpecConfig) -> torch.Tensor:
    """wav [..., T] -> the conditioning frames [..., n_out_channels, F]:
    :func:`log_mel_frames` with ``cfg.log_mel``, else
    :func:`mfcc_delta_stack`."""
    return log_mel_frames(wav, cfg) if cfg.log_mel else mfcc_delta_stack(wav, cfg)
