"""The assembled WaveNet autoencoder: teacher-forced loss and
reconstruction.

Counterpart of ``ae_wavenet_tpu.models.autoencoder``: encoder ->
bottleneck -> upsampled local conditioning -> WaveNet decoder, trained
teacher-forced (:func:`forward`, :func:`loss_fn`) and sampled
autoregressively (:func:`reconstruct`).  Parameters carry the reference's
dotted names with the ``params.`` prefix dropped; bottleneck state sits
under ``bottleneck.`` (see training/weights.py).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ae_wavenet_tpu_torch.geometry.vconv import Chain, Range
from ae_wavenet_tpu_torch.audio import mfcc
from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float, mu_encode
from ae_wavenet_tpu_torch.models import bottlenecks, common, encoder, wavenet
from ae_wavenet_tpu_torch.models.common import (WindowSpec, btq_layout,
                                                 compute_dtype, mu_ce,
                                                 normalize_frames)
from ae_wavenet_tpu_torch.utils import device as device_mod
from ae_wavenet_tpu_torch.utils.config import RunConfig


def cond_chain(cfg: RunConfig) -> Chain:
    """wav -> cond lattice: frontend + encoder + upsampling."""
    return (cfg.spec.geometry() + encoder.geometry(cfg.encoder)
            + wavenet.upsample_geometry(cfg.wavenet))


def make_window_spec(cfg: RunConfig, n_win: int | None = None) -> WindowSpec:
    return common.make_window_spec(cfg, cond_chain(cfg), n_win, "autoencoder")


def aux_frame_active(cfg: RunConfig) -> bool:
    """The latent->MFCC aux head exists when weighted and conditioning
    exists (a training head; kept so checkpoints round-trip)."""
    return cfg.train.aux_frame_weight > 0 and cfg.bottleneck.kind != "zero"


def frame_align(cfg: RunConfig) -> tuple[int, int]:
    """Latent position t <-> encoder-input frame c0 + s*t (receptive-field
    centre of the encoder geometry)."""
    ch = encoder.geometry(cfg.encoder)
    r0, r1 = ch.in_range(Range(0, 1)), ch.in_range(Range(1, 2))
    c0 = (r0.b + r0.e - 1) // 2
    return c0, max((r1.b + r1.e - 1) // 2 - c0, 1)


class AutoEncoder(nn.Module):
    def __init__(self, cfg: RunConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = encoder.Encoder(cfg.encoder, generator)
        self.wavenet = wavenet.WaveNet(cfg.wavenet, generator)
        self.bottleneck = bottlenecks.make(cfg.bottleneck, generator)
        if aux_frame_active(cfg):
            n_ch, d = 3 * cfg.spec.n_mfcc, cfg.bottleneck.n_dim
            self.aux_frame = nn.ParameterDict({
                "w": nn.Parameter(torch.randn(n_ch, d, generator=generator)
                                  / math.sqrt(d)),
                "b": nn.Parameter(torch.zeros(n_ch)),
            })


def init(cfg: RunConfig, generator: torch.Generator | None = None,
         device="cuda") -> AutoEncoder:
    """Random weights drawn from ``generator`` (a CPU generator), with the
    reference's shapes and scales, then moved to ``device``: the card,
    unless the caller passes ``"cpu"`` (no card raises)."""
    return AutoEncoder(cfg, generator).to(device_mod.resolve(device))


@torch.no_grad()
def encode(model: AutoEncoder, cfg: RunConfig, wav_i16: torch.Tensor):
    """Full-utterance conditioning: wav [B, T] int16 -> (cond [B, C, Tc],
    c_off).  cond column t conditions the AR step that consumes wav
    position t + c_off."""
    chain = cond_chain(cfg)
    r0 = chain.in_range(Range(0, 1))
    c_off = (r0.b + r0.e) // 2
    frames = mfcc.mfcc_delta_stack(int16_to_float(wav_i16), cfg.spec)
    # statistics over a train-window-length slice, as in training
    frames = normalize_frames(frames, n_ref=make_window_spec(cfg).n_frames,
                              spec=cfg.spec)
    zq = model.bottleneck(model.encoder(frames))
    up_chain = wavenet.upsample_geometry(cfg.wavenet)
    steps = up_chain.plan(Range(0, up_chain.out_len(zq.shape[-1])))
    return wavenet.upsample_apply(model.wavenet, cfg.wavenet, zq, steps), c_off


def reconstruct(model: AutoEncoder, cfg: RunConfig, wav_i16: torch.Tensor,
                spk: torch.Tensor, generator: torch.Generator | None = None,
                temperature: float = 1.0, n_samples: int | None = None,
                timings: dict | None = None, quantized=False):
    """Autoencode a whole utterance: encode -> prime on real left context ->
    sample.  Returns (ids [B, n], start); see models/common.reconstruct."""
    return common.reconstruct(encode, model, cfg, wav_i16, spk, generator,
                              temperature, n_samples, timings, quantized)


def forward(model: AutoEncoder, cfg: RunConfig, spec: WindowSpec,
            wav_i16: torch.Tensor, spk: torch.Tensor, step, train: bool,
            generator: torch.Generator | None = None, draws: dict | None = None):
    """One teacher-forcing pass over training windows wav_i16 [B, u_len]
    int16.  Returns (logits, targets, aux): logits [B, Q, n_win] ([B,
    n_win, Q] under ``btq_layout``), targets [B, n_win].  With ``train``
    the bottleneck's state updates in place; its draws come from ``draws``
    or ``generator`` (see models/bottlenecks.py)."""
    dtype = compute_dtype(cfg)
    wav = int16_to_float(wav_i16)
    frames = mfcc.mfcc_delta_stack(wav[..., spec.fb : spec.fe], cfg.spec)
    frames = normalize_frames(frames, spec=cfg.spec)
    z = model.encoder(frames, dtype=dtype)
    zq, aux = model.bottleneck.train_apply(z, step, train, generator, draws)
    # the aux head reads the pre-jitter latents (jitter regularises the
    # decoder; jittered targets would be label noise)
    zq_clean = aux.pop("zq_pre_jitter", zq)
    if aux_frame_active(cfg):
        c0, s = frame_align(cfg)
        tz = zq_clean.shape[-1]
        tgt = frames[..., c0 : c0 + s * tz : s].detach()
        head = model.aux_frame
        pred = (torch.einsum("bdt,cd->bct", zq_clean.float(), head["w"])
                + head["b"][None, :, None])
        mse = (pred - tgt.float()).square().mean()
        aux["aux_frame_mse"] = mse
        aux["aux_frame_loss"] = cfg.train.aux_frame_weight * mse
    cond = wavenet.upsample_apply(model.wavenet, cfg.wavenet, zq, spec.up_steps,
                                  dtype=dtype)
    ids = mu_encode(wav, cfg.wavenet.n_quant)
    x_ids = ids[..., spec.w0 : spec.w0 + spec.t_in]
    logits = wavenet.apply(model.wavenet, cfg.wavenet, x_ids, cond, spk,
                           dtype=dtype, btq=btq_layout(cfg))
    targets = ids[..., spec.tgt_b : spec.tgt_b + spec.n_win]
    return logits, targets, aux


def loss_fn(model: AutoEncoder, cfg: RunConfig, spec: WindowSpec,
            wav_i16: torch.Tensor, spk: torch.Tensor, step, train: bool = True,
            generator: torch.Generator | None = None, draws: dict | None = None):
    """-> (total loss, metrics): ``loss``, ``recon_ce`` and the
    bottleneck's and aux head's terms (``bn_loss``, ``commitment``,
    ``perplexity``, ``restarts``, ``aux_frame_mse``, ``aux_frame_loss``,
    ... as the kind gives them), all 0-d tensors."""
    logits, targets, aux = forward(model, cfg, spec, wav_i16, spk, step, train,
                                   generator, draws)
    recon = mu_ce(logits, targets, btq=btq_layout(cfg))
    total = recon + aux["bn_loss"] + aux.get("aux_frame_loss", 0.0)
    return total, {"loss": total, "recon_ce": recon, **aux}
