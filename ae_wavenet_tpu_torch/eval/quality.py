"""Generated-audio quality metrics.

Counterpart of ``ae_wavenet_tpu.eval.quality``.  Two numbers, both computed
on free-running generation (the model fed its own samples, so compounding
autoregressive error is captured, which teacher-forced CE cannot see):

* **free-running NLL**: mean -log p(ground-truth sample | generated past)
  under the per-step predictive distributions of the AR stream;
* **log-mel spectral distance**: mean per-frame L2 distance between the
  log-mel spectrograms (audio/mfcc framing, before the DCT) of the
  reconstruction and the source segment.

The rollout is the f32 sampler ``ops/fastgen.generate`` (on the card a CUDA
graph replayed once a sample, the counterpart of the reference's jitted
scan; it returns the per-step logits); the lattice is
``models/common.prime_for_generation``'s, shared with ``reconstruct``.
"""

from __future__ import annotations

import numpy as np
import torch

from ae_wavenet_tpu_torch.audio.mfcc import log_mel_frames
from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float, mu_decode
from ae_wavenet_tpu_torch.models import common
from ae_wavenet_tpu_torch.models import wavenet as wn
from ae_wavenet_tpu_torch.ops import fastgen
from ae_wavenet_tpu_torch.utils.config import RunConfig, SpecConfig


def log_mel_distance(x, y, spec: SpecConfig) -> float:
    """Mean per-frame L2 distance between log-mel spectrograms.

    x, y: float wav tensors or arrays [..., T] on the same sample lattice
    (trimmed to the shorter length; both must cover one analysis window)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32).to(x.device)
    n = min(x.shape[-1], y.shape[-1])
    if n < spec.win_sz:
        raise ValueError(f"need >= {spec.win_sz} samples, got {n}")
    a = log_mel_frames(x[..., :n], spec)
    b = log_mel_frames(y[..., :n], spec)
    return float(torch.linalg.vector_norm(a - b, dim=-2).mean())


#: the JSON-reported scalar metrics of a quality record, in report order
QUALITY_KEYS = ("free_nll", "free_nll_early", "teacher_nll", "spectral_l2",
                "spectral_l2_vs_silence")


def _prime(model, cfg, wav_i16, spk, n_samples, encode_fn):
    """Encode and prime the queues (the temperature-invariant part, shared
    across a divergence sweep)."""
    if encode_fn is None:
        from ae_wavenet_tpu_torch.models import registry

        encode_fn = registry.get(cfg.model_kind).encode
    return common.prime_for_generation(encode_fn, model, cfg, wav_i16, spk,
                                       n_samples)


def _nll(logits: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Per-position NLL [B, n] of truth [B, n] under logits [B, Q, n]."""
    logp = torch.log_softmax(logits.float(), 1)
    return -logp.gather(1, truth[:, None, :].long())[:, 0]


@torch.no_grad()
def _score_rollout(prep, model, cfg, wav_i16, spk, generator, temperature,
                   nll_buckets):
    """One rollout at ``temperature`` and its scores."""
    wcfg = cfg.wavenet
    n, start = prep.n, prep.start
    # the sampler writes the queues in place: roll a copy, so a sweep
    # starts every temperature from the same primed state
    state = fastgen.GenState(tuple(b.clone() for b in prep.state.bufs),
                             prep.state.prev_id, prep.state.t)
    gen_ids, _, logits = fastgen.generate(
        model.wavenet, wcfg, state, prep.gen_cond, generator, gc_ids=spk,
        temperature=temperature, return_logits=True)
    per_pos_nll = _nll(logits, prep.ids[..., start : start + n])
    curve = None
    if nll_buckets > 0:
        # never more buckets than positions (an empty segment means NaN)
        seg = np.array_split(per_pos_nll.mean(0).cpu().numpy(), min(nll_buckets, n))
        curve = [round(float(s.mean()), 4) for s in seg]
    recon = mu_decode(gen_ids, wcfg.n_quant)
    src = int16_to_float(wav_i16)[..., start : start + n]
    rep = {
        "free_nll": float(per_pos_nll.mean()),
        # ground truth is a valid conditional target only until the rollout's
        # phase decorrelates: the first 64 samples are the comparable number
        "free_nll_early": float(per_pos_nll[..., : min(64, n)].mean()),
        "spectral_l2": log_mel_distance(recon, src, cfg.spec),
        "temperature": temperature,
        "n_scored": n,
        "ids": gen_ids,
        "start": start,
    }
    if curve is not None:
        rep["free_nll_curve"] = curve
    return rep


@torch.no_grad()
def _teacher_and_silence(prep, model, cfg, wav_i16, spk):
    """Teacher-forced NLL at the same positions (feed the real past, score
    the same targets) and the distance of the source to silence (the scale
    a reconstruction must beat).  Temperature-invariant."""
    rf, n, ids, start = prep.rf, prep.n, prep.ids, prep.start
    t_in = rf + n
    x_ids = ids[..., start - 1 - rf : start - 1 - rf + t_in]
    tf_logits = wn.apply(model.wavenet, cfg.wavenet, x_ids,
                         prep.cond[..., :t_in], spk)
    teacher = float(_nll(tf_logits, ids[..., start : start + n]).mean())
    src = int16_to_float(wav_i16)[..., start : start + n]
    return {"teacher_nll": teacher,
            "spectral_l2_vs_silence": log_mel_distance(torch.zeros_like(src), src,
                                                       cfg.spec)}


def free_running_report(model, cfg: RunConfig, wav_i16: torch.Tensor,
                        spk: torch.Tensor,
                        generator: torch.Generator | None = None,
                        n_samples: int | None = None, encode_fn=None,
                        temperature: float = 1.0, nll_buckets: int = 0) -> dict:
    """Free-running quality on whole utterances wav_i16 [B, T] int16.

    Encodes the source, primes the queues on real left context, rolls the
    sampler forward feeding its own samples, and scores:

    * ``free_nll``: mean ground-truth NLL under the rollout's per-step
      distributions (nats);
    * ``free_nll_early``: the same over the first 64 samples;
    * ``teacher_nll``: the same positions, teacher forcing (the baseline);
    * ``spectral_l2``: log-mel distance, reconstruction against source;
    * ``spectral_l2_vs_silence``: the source against silence;
    * ``n_scored``: samples scored per utterance.

    ``temperature`` shapes the rollout only (greedy at 0); ground truth is
    always scored under the untempered softmax.  ``nll_buckets`` > 0 adds
    ``free_nll_curve``: mean NLL over that many equal rollout segments.
    Returns the metrics plus the generated ``ids`` and ``start``."""
    prep = _prime(model, cfg, wav_i16, spk, n_samples, encode_fn)
    rep = _score_rollout(prep, model, cfg, wav_i16, spk, generator, temperature,
                         nll_buckets)
    rep.update(_teacher_and_silence(prep, model, cfg, wav_i16, spk))
    return rep


def clip_quality_record(model, cfg: RunConfig, ds, clip: int,
                        generator: torch.Generator | None = None, *,
                        n_samples: int = 16000, max_input: int = 64000,
                        encode_fn=None, step: int | None = None,
                        device=None) -> dict:
    """One dataset clip -> the JSON-ready free-running quality record (the
    single source of the record's schema).  ``device`` defaults to the
    model's."""
    if device is None:
        device = next(model.parameters()).device
    wav = torch.from_numpy(ds.clip(clip, max_input))[None].to(device)
    spk = torch.from_numpy(ds.speakers[clip : clip + 1].astype(np.int64)).to(device)
    rep = free_running_report(model, cfg, wav, spk, generator,
                              n_samples=n_samples, encode_fn=encode_fn)
    rec: dict = {} if step is None else {"step": step}
    rec["clip"] = clip
    rec.update({k: round(float(rep[k]), 4) for k in QUALITY_KEYS})
    rec["n_scored"] = int(rep["n_scored"])
    return rec


def divergence_report(model, cfg: RunConfig, wav_i16: torch.Tensor,
                      spk: torch.Tensor,
                      generator: torch.Generator | None = None,
                      n_samples: int | None = None, encode_fn=None,
                      temperatures=(1.0, 0.9, 0.8, 0.0),
                      nll_buckets: int = 8) -> dict:
    """Rollout-divergence diagnosis: sweep the sampling temperature and
    bucket free_nll by rollout position.  A gap that shrinks at lower
    temperature points at sampling noise; early buckets near teacher_nll
    with late buckets high at every temperature point at trajectory
    decorrelation; flat-high from bucket 0 points at the model itself."""
    prep = _prime(model, cfg, wav_i16, spk, n_samples, encode_fn)
    out = {"temperatures": {}, "n_scored": prep.n,
           **_teacher_and_silence(prep, model, cfg, wav_i16, spk)}
    for t in temperatures:
        rep = _score_rollout(prep, model, cfg, wav_i16, spk, generator, t,
                             nll_buckets)
        key = "greedy" if t == 0.0 else f"{t:g}"
        out["temperatures"][key] = {
            k: rep[k] for k in ("free_nll", "free_nll_early", "spectral_l2",
                                "free_nll_curve") if k in rep}
    return out


#: the int8 gate of the reference (``tests_tpu/test_quality_tpu.py``):
#: GATE_STEPS training steps, GATE_SAMPLES free-running samples, and
#: d8 <= GATE_RATIO * d16 + GATE_SLACK
GATE_STEPS, GATE_SAMPLES = 300, 16384
GATE_RATIO, GATE_SLACK = 1.20, 0.15


def quantized_quality_gate(workdir: str, device="cuda", on_trained=None) -> dict:
    """The reference's int8 sampling-quality gate: train the flagship dims
    (VQ, the fused stack, B = 4, n_win = 8,000, 4 steps a call, every 5th
    clip held out) for GATE_STEPS steps on the reference's v2 fixture (6
    clips, seed 2), then reconstruct GATE_SAMPLES free-running samples of
    clip 0's first 40,000 samples at temperature 1 with the bf16, int8 and
    int4 samplers, and score each by its log-mel distance to the source.
    ``on_trained(chassis, history)`` runs between training and sampling.
    -> {"d16", "d8", "d4", "silence", "passed" (d8 <= GATE_RATIO * d16 +
    GATE_SLACK; int4 has no gate), "history", "n"}."""
    import io
    import os

    from ae_wavenet_tpu_torch.data.dataset import PackedDataset
    from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.training.chassis import Chassis
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, TrainConfig,
                                                   WaveNetConfig)

    os.makedirs(workdir, exist_ok=True)
    prefix = os.path.join(workdir, "gate")
    make_synthetic_dataset(prefix, n_clips=6, n_speakers=4, seed=2,
                           clip_len=(60000, 90000))
    cfg = RunConfig(bottleneck=BottleneckConfig(kind="vq"),
                    wavenet=WaveNetConfig(use_pallas_stack=True),
                    train=TrainConfig(batch_sz=4, n_win=8000, steps_per_call=4,
                                      log_every=100, holdout_every=5))
    ch = Chassis(cfg, prefix, device=device, log_stream=io.StringIO())
    history = ch.train(GATE_STEPS)
    ch.close()
    if on_trained is not None:
        on_trained(ch, history)
    ds = PackedDataset(prefix)
    clip = 0  # holdout_every=5 holds out clips 0 and 5
    wav = torch.from_numpy(ds.clip(clip, 40000))[None].to(ch.device)
    spk = torch.from_numpy(ds.speakers[clip : clip + 1].astype(np.int64)).to(ch.device)
    model = ch.model.eval()
    out = {"history": history}
    for key, quantized in (("d16", False), ("d8", "int8"), ("d4", "int4")):
        ids, start = ae.reconstruct(model, ch.cfg, wav, spk,
                                    torch.Generator().manual_seed(0), temperature=1.0,
                                    n_samples=GATE_SAMPLES, quantized=quantized)
        recon = mu_decode(ids, ch.cfg.wavenet.n_quant)
        src = int16_to_float(wav)[..., start : start + recon.shape[-1]]
        out[key] = log_mel_distance(recon, src, ch.cfg.spec)
        out["n"] = int(recon.shape[-1])
    out["silence"] = log_mel_distance(torch.zeros_like(src), src, ch.cfg.spec)
    out["passed"] = bool(np.isfinite(out["d16"]) and np.isfinite(out["d8"])
                         and out["d8"] <= GATE_RATIO * out["d16"] + GATE_SLACK)
    return out
