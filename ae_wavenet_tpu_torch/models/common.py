"""Shared model plumbing: window spec, the loss, frame normalization and
the generation driver.

Counterpart of ``ae_wavenet_tpu.models.common``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ae_wavenet_tpu_torch.geometry.vconv import Chain, PlanStep, Range
from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float
from ae_wavenet_tpu_torch.models import wavenet
from ae_wavenet_tpu_torch.ops import fastgen
from ae_wavenet_tpu_torch.ops.fastgen_cuda import generate_auto
from ae_wavenet_tpu_torch.utils.config import RunConfig
from ae_wavenet_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Static training-window layout (see the reference's
    models/autoencoder.py docstring)."""

    u_len: int                      # loader window length (wav samples)
    fb: int                         # frontend input = U[fb:fe]
    fe: int
    w0: int                         # decoder AR input start = U[w0 : w0+t_in]
    t_in: int                       # decoder input length
    rf: int                         # decoder receptive field (left context)
    n_win: int                      # loss samples per window
    n_frames: int                   # frontend frames fed downstream
    up_steps: Tuple[PlanStep, ...]  # upsample-chain trims

    @property
    def tgt_b(self) -> int:
        return self.w0 + 1 + self.rf


def btq_layout(cfg: RunConfig) -> bool:
    """True when training logits are time-major [B, T, Q]: the fused
    stack's layout.  Drives both ``wavenet.apply(btq=...)`` and
    :func:`mu_ce`."""
    return (cfg.wavenet.use_pallas_stack
            and cfg.train.compute_dtype == "bfloat16")


def compute_dtype(cfg: RunConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def mu_ce(logits: torch.Tensor, targets: torch.Tensor,
          btq: bool = False) -> torch.Tensor:
    """Mean mu-law cross-entropy in f32.  btq: logits [B, T, Q]
    (logsumexp minus the picked logit); otherwise [B, Q, T]
    (log-softmax over Q)."""
    lg = logits.float()
    if btq:
        picked = lg.gather(-1, targets[..., None].long())[..., 0]
        return (torch.logsumexp(lg, -1) - picked).mean()
    logp = torch.log_softmax(lg, 1)
    return -logp.gather(1, targets[:, None, :].long()).mean()


def mol_nll(params: torch.Tensor, x: torch.Tensor, n_quant: int,
            log_scale_min: float, btq: bool = False) -> torch.Tensor:
    """Mean negative log-likelihood in f32 of samples x [B, T] in [-1, 1]
    under a discretized mixture of logistics: PixelCNN++'s
    (arXiv:1701.05517) over ``n_quant`` levels, bins of half-width
    1 / (n_quant - 1).  params [B, T, 3K] with ``btq``, else [B, 3K, T],
    laid out [logits | means | log_scales]; log-scales clamped at
    ``log_scale_min``.  The levels at -1 and 1 take the tails (x < -0.999,
    x > 0.999); a bin whose mass is 1e-5 or less takes the pdf at its
    middle times its width."""
    p = params.float() if btq else params.float().transpose(1, 2)
    k = p.shape[-1] // 3
    logit, mean = p[..., :k], p[..., k : 2 * k]
    log_s = torch.clamp(p[..., 2 * k :], min=log_scale_min)
    x = x.float()[..., None]
    centered = x - mean
    inv_s = torch.exp(-log_s)
    half = 1.0 / (n_quant - 1)
    plus_in = inv_s * (centered + half)
    min_in = inv_s * (centered - half)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_s * centered
    log_pdf_mid = mid_in - log_s - 2.0 * F.softplus(mid_in)
    inner = torch.where(cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
                        log_pdf_mid - math.log((n_quant - 1) / 2))
    inner = torch.where(x > 0.999, log_one_minus_cdf_min, inner)
    log_probs = torch.where(x < -0.999, log_cdf_plus, inner)
    log_probs = log_probs + torch.log_softmax(logit, -1)
    return -torch.logsumexp(log_probs, -1).mean()


def to_int16(x: torch.Tensor) -> torch.Tensor:
    """Samples in [-1, 1] -> 16-bit PCM (x * 32768, rounded, clipped)."""
    return torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int16)


def make_window_spec(cfg: RunConfig, chain: Chain, n_win: int | None,
                     what: str) -> WindowSpec:
    """Build the static window layout for a cond chain ``frontend + ... +
    upsample`` whose net stride must be 1."""
    n_win = cfg.train.n_win if n_win is None else n_win
    rf = wavenet.receptive_field(cfg.wavenet)
    t_in = n_win + rf
    num, den = chain.total_stride()
    if (num, den) != (1, 1):
        raise ValueError(
            f"{what} cond chain resamples by {num}/{den}; upsample strides "
            f"must invert the frontend stride exactly"
        )
    steps = chain.plan(Range(0, t_in))
    f_in = steps[0].in_want
    if f_in.b < 0:
        raise ValueError(f"cond chain plan reaches before window start: {f_in}")
    r0 = chain.in_range(Range(0, 1))
    c_off = (r0.b + r0.e) // 2
    u_len = max(f_in.e, c_off + t_in + 1)
    n_front = len(cfg.spec.geometry().layers)
    if n_front < len(steps):
        if (steps[n_front - 1].out_want.as_tuple()
                != steps[n_front].in_want.as_tuple()):
            raise ValueError("geometry bug: frontend/encoder plan discontinuity")
        enc_in = steps[n_front].in_want
    else:
        enc_in = steps[-1].out_want
    n_up = len(cfg.wavenet.lc_upsample_strides)
    return WindowSpec(
        u_len=u_len, fb=f_in.b, fe=f_in.e, w0=c_off, t_in=t_in, rf=rf,
        n_win=n_win, n_frames=len(enc_in),
        up_steps=tuple(steps[len(steps) - n_up:]),
    )


@functools.cache
def _dataset_stats(mean: tuple, var: tuple, device: str) -> tuple:
    """The stored statistics as [C, 1] tensors on ``device``, made once: a
    captured training step (training/chassis.py) reads them by address, so
    they are never evicted."""
    return (torch.tensor(mean, device=device)[:, None],
            torch.tensor(var, device=device)[:, None])


def normalize_frames(frames: torch.Tensor, n_ref: int | None = None,
                     spec=None) -> torch.Tensor:
    """Normalization of the MFCC stack, per ``spec.norm``: ``"window"``
    uses the mean/var over the frames (over a centered ``n_ref``-frame
    slice when given, to match training windows); ``"dataset"`` uses the
    per-channel statistics stored in the config."""
    if spec is not None and spec.norm == "dataset":
        if not spec.stats_mean:
            raise ValueError('spec.norm="dataset" but stats_mean/stats_var '
                             "are unset in the config")
        mean, var = _dataset_stats(spec.stats_mean, spec.stats_var, str(frames.device))
        return (frames - mean) * torch.rsqrt(var + 1e-6)
    t = frames.shape[-1]
    ref = frames
    if n_ref is not None and t > n_ref:
        b = (t - n_ref) // 2
        ref = frames[..., b : b + n_ref]
    mean = ref.mean(-1, keepdim=True)
    var = ref.var(-1, unbiased=False, keepdim=True)
    return (frames - mean) * torch.rsqrt(var + 1e-6)


def _lap(timings: dict | None, key: str, t0: float, device) -> float:
    """Record seconds since t0 under ``key`` (after the device finishes)."""
    if timings is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    timings[key] = now - t0
    return now


@dataclasses.dataclass(frozen=True)
class GenPrep:
    """Primed generation state + the alignment lattice.  Generation runs
    ``n`` steps over ``gen_cond``; the output aligns with the input's AR
    inputs ``ids[..., start : start + n]``."""

    state: fastgen.GenState
    cond: torch.Tensor               # full conditioning [B, C, tc]
    ids: torch.Tensor                # AR inputs of the full input [B, U']:
                                     # mu-law ids, or samples (n_mix > 0)
    c_off: int                       # cond frame 0 = input sample c_off
    rf: int
    n: int

    @property
    def gen_cond(self) -> torch.Tensor:
        return self.cond[..., self.rf : self.rf + self.n]

    @property
    def start(self) -> int:
        return self.c_off + self.rf + 1


EncodeFn = Callable[[torch.nn.Module, RunConfig, torch.Tensor],
                    Tuple[torch.Tensor, int]]


@torch.no_grad()
def prime_for_generation(encode_fn: EncodeFn, model: torch.nn.Module,
                         cfg: RunConfig, wav_i16: torch.Tensor,
                         spk: torch.Tensor, n_samples: int | None = None,
                         timings: dict | None = None) -> GenPrep:
    """Encode a whole utterance with ``encode_fn(model, cfg, wav_i16) ->
    (cond, c_off)``, turn the ground truth into AR inputs (mu-law ids, or
    the samples themselves with a mixture output) and prime the queues on
    real left context.  ``timings``, when given, receives the seconds of
    "encode" and "prime"."""
    t = time.perf_counter()
    with span("serve.encode"):
        cond, c_off = encode_fn(model, cfg, wav_i16)
        t = _lap(timings, "encode", t, wav_i16.device)
    rf = wavenet.receptive_field(cfg.wavenet)
    tc = int(cond.shape[-1])
    if tc <= rf + 1:
        raise ValueError(f"utterance too short: {tc} cond frames <= rf+1")
    n = tc - rf - 1 if n_samples is None else min(n_samples, tc - rf - 1)
    with span("serve.prime"):
        ids = wavenet.decoder_inputs(cfg.wavenet, int16_to_float(wav_i16))
        ctx = ids[..., c_off : c_off + rf + 1]
        state = fastgen.init_state(cfg.wavenet, wav_i16.shape[0], device=wav_i16.device)
        state = fastgen.prime(model.wavenet, cfg.wavenet, state, ctx, cond, spk)
        _lap(timings, "prime", t, wav_i16.device)
    return GenPrep(state=state, cond=cond, ids=ids, c_off=c_off, rf=rf, n=n)


@torch.no_grad()
def reconstruct(encode_fn: EncodeFn, model: torch.nn.Module, cfg: RunConfig,
                wav_i16: torch.Tensor, spk: torch.Tensor,
                generator: torch.Generator | None = None,
                temperature: float = 1.0, n_samples: int | None = None,
                timings: dict | None = None, quantized=False):
    """:func:`prime_for_generation`, then sample autoregressively with the
    fused sampler (``quantized``: False, True/'int8' or 'int4' weights).
    Returns (mu-law ids [B, n], start), or with a mixture output
    (``cfg.wavenet.n_mix``) 16-bit samples [B, n] int16 in place of the ids:
    the output corresponds to input positions [start, start + n).
    ``timings`` also receives the seconds of "generate"."""
    prep = prime_for_generation(encode_fn, model, cfg, wav_i16, spk,
                                n_samples, timings)
    t = time.perf_counter()
    with span("serve.generate"):
        out, _ = generate_auto(model.wavenet, cfg.wavenet, prep.state,
                               prep.gen_cond, generator, gc_ids=spk,
                               temperature=temperature, quantized=quantized)
        if cfg.wavenet.n_mix:
            out = to_int16(out)
        _lap(timings, "generate", t, wav_i16.device)
    return out, prep.start
