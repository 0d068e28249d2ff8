"""The assembled WaveNet autoencoder for reconstruction.

Counterpart of ``ae_wavenet_tpu.models.autoencoder`` on the serving path:
encoder -> bottleneck (eval) -> upsampled local conditioning -> WaveNet
decoder sampled autoregressively.  Parameters carry the reference's dotted
names with the ``params.`` prefix dropped; bottleneck state sits under
``bottleneck.`` (see training/weights.py).  The teacher-forced forward and
loss belong to the training slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ae_wavenet_tpu_torch.geometry.vconv import Chain, Range
from ae_wavenet_tpu_torch.audio import mfcc
from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float
from ae_wavenet_tpu_torch.models import bottlenecks, common, encoder, wavenet
from ae_wavenet_tpu_torch.models.common import WindowSpec, normalize_frames
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
         device=None) -> AutoEncoder:
    """Random weights drawn from ``generator`` (a CPU generator), with the
    reference's shapes and scales, then moved to ``device``."""
    return AutoEncoder(cfg, generator).to(device)


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
                timings: dict | None = None):
    """Autoencode a whole utterance: encode -> prime on real left context ->
    sample.  Returns (ids [B, n], start); see models/common.reconstruct."""
    return common.reconstruct(encode, model, cfg, wav_i16, spk, generator,
                              temperature, n_samples, timings)
