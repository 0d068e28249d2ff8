"""MFCC inverter: the WaveNet decoder conditioned directly on the MFCC
stack, with no encoder and no bottleneck (the vocoder baseline).

Counterpart of ``ae_wavenet_tpu.models.mfcc_inverter``.  It shares the
decoder, the window bookkeeping and the generation driver
(``models/common.py``) with the autoencoder; its conditioning chain is the
frontend and the upsampler alone, so the upsampler must invert the hop by
itself (strides (5, 4, 4, 2) for hop 160).  The fused stack runs as in the
autoencoder: cond is ``n_lc_out + n_global_embed`` channels either way.
Parameters sit under ``wavenet.`` (the reference's ``params.wavenet.*``);
there is no bottleneck state.

The port's own variants, which the reference's schema lacks: conditioning
on the log-mel bands alone (``spec.n_mfcc`` = 0) and a mixture-of-logistics
output over 16-bit samples (``wavenet.n_mix``), as in the WaveNet vocoder of
Tacotron 2 (arXiv:1712.05884 §2.3).
"""

from __future__ import annotations

import torch
from torch import nn

from ae_wavenet_tpu_torch.audio import mfcc
from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float
from ae_wavenet_tpu_torch.geometry.vconv import Chain, Range
from ae_wavenet_tpu_torch.models import common, wavenet
from ae_wavenet_tpu_torch.models.common import (WindowSpec, btq_layout, mol_nll, mu_ce,
                                                 normalize_frames)
from ae_wavenet_tpu_torch.utils import device as device_mod
from ae_wavenet_tpu_torch.utils.config import RunConfig


def cond_chain(cfg: RunConfig) -> Chain:
    """wav -> cond lattice: frontend + upsampling."""
    return cfg.spec.geometry() + wavenet.upsample_geometry(cfg.wavenet)


def make_window_spec(cfg: RunConfig, n_win: int | None = None) -> WindowSpec:
    return common.make_window_spec(cfg, cond_chain(cfg), n_win, "mfcc_inverter")


class MfccInverter(nn.Module):
    def __init__(self, cfg: RunConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.wavenet = wavenet.WaveNet(cfg.wavenet, generator,
                                       n_lc_in=cfg.spec.n_out_channels)


def init(cfg: RunConfig, generator: torch.Generator | None = None,
         device="cuda") -> MfccInverter:
    """Random weights drawn from ``generator`` (a CPU generator), then moved
    to ``device``: the card, unless the caller passes ``"cpu"``."""
    return MfccInverter(cfg, generator).to(device_mod.resolve(device))


@torch.no_grad()
def encode(model: MfccInverter, cfg: RunConfig, wav_i16: torch.Tensor):
    """Full-utterance conditioning: wav [B, T] int16 -> (cond [B, C, Tc],
    c_off), as ``autoencoder.encode``; the frame statistics are taken over
    a slice as long as this model's training window's frames."""
    r0 = cond_chain(cfg).in_range(Range(0, 1))
    c_off = (r0.b + r0.e) // 2
    frames = mfcc.features(int16_to_float(wav_i16), cfg.spec)
    frames = normalize_frames(frames, n_ref=make_window_spec(cfg).n_frames,
                              spec=cfg.spec)
    up_chain = wavenet.upsample_geometry(cfg.wavenet)
    steps = up_chain.plan(Range(0, up_chain.out_len(frames.shape[-1])))
    return wavenet.upsample_apply(model.wavenet, cfg.wavenet, frames, steps), c_off


def reconstruct(model: MfccInverter, cfg: RunConfig, wav_i16: torch.Tensor,
                spk: torch.Tensor, generator: torch.Generator | None = None,
                temperature: float = 1.0, n_samples: int | None = None,
                timings: dict | None = None, quantized=False):
    """Vocode a whole utterance from its own frames: the contract of
    ``autoencoder.reconstruct`` (``models/common.reconstruct``; 16-bit
    samples in place of mu-law ids with a mixture output)."""
    return common.reconstruct(encode, model, cfg, wav_i16, spk, generator,
                              temperature, n_samples, timings, quantized)


def forward(model: MfccInverter, cfg: RunConfig, spec: WindowSpec,
            wav_i16: torch.Tensor, spk: torch.Tensor, step=None, train: bool = True,
            generator: torch.Generator | None = None, draws: dict | None = None,
            group=None):
    """One teacher-forcing pass over training windows wav_i16 [B, u_len]
    int16 -> (logits, targets, aux) as ``autoencoder.forward``; aux is
    empty.  With a mixture output the logits are the mixture parameters
    and the targets the samples in [-1, 1].  ``step``, ``train``,
    ``generator``, ``draws`` and ``group`` are taken for the shared
    signature: nothing here draws or keeps state, so under data parallelism
    only the gradients are averaged."""
    del step, train, generator, draws, group
    dtype = common.compute_dtype(cfg)
    wav = int16_to_float(wav_i16)
    frames = mfcc.features(wav[..., spec.fb : spec.fe], cfg.spec)
    frames = normalize_frames(frames, spec=cfg.spec)
    cond = wavenet.upsample_apply(model.wavenet, cfg.wavenet, frames, spec.up_steps,
                                  dtype=dtype)
    ids = wavenet.decoder_inputs(cfg.wavenet, wav)
    x_ids = ids[..., spec.w0 : spec.w0 + spec.t_in]
    logits = wavenet.apply(model.wavenet, cfg.wavenet, x_ids, cond, spk,
                           dtype=dtype, btq=btq_layout(cfg))
    return logits, ids[..., spec.tgt_b : spec.tgt_b + spec.n_win], {}


def draws(model: MfccInverter, cfg: RunConfig, spec: WindowSpec, batch: int,
          generator: torch.Generator, device) -> dict:
    """The inverter's training step draws nothing."""
    return {}


def loss_fn(model: MfccInverter, cfg: RunConfig, spec: WindowSpec,
            wav_i16: torch.Tensor, spk: torch.Tensor, step=None, train: bool = True,
            generator: torch.Generator | None = None, draws: dict | None = None,
            group=None):
    """-> (recon CE, {"loss", "recon_ce"}): the model has no bottleneck
    terms and no aux head.  With a mixture output the reconstruction term
    is the mixture's negative log-likelihood (``common.mol_nll``)."""
    logits, targets, _ = forward(model, cfg, spec, wav_i16, spk, step, train,
                                 generator, draws)
    wn = cfg.wavenet
    if wn.n_mix:
        recon = mol_nll(logits, targets, wn.n_quant, wn.log_scale_min, btq=btq_layout(cfg))
    else:
        recon = mu_ce(logits, targets, btq=btq_layout(cfg))
    return recon, {"loss": recon, "recon_ce": recon}
