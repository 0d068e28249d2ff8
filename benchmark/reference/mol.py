"""The WaveNet vocoder of Tacotron 2 in plain float32 PyTorch.

Shen et al. 2018, "Natural TTS Synthesis by Conditioning WaveNet on Mel
Spectrogram Predictions" (arXiv:1712.05884) §2.3: 80-band log-mel frames
upsampled by a conditioning stack of two transposed convolutions, 30
dilated causal convolution layers in 3 cycles (layer k's dilation 2^(k mod
10)) with WaveNet's gated units (arXiv:1609.03499 eq. 2, conditioned:
tanh(W_f x + V_f c) * sigmoid(W_g x + V_g c)), and a 10-component mixture of
logistics over 16-bit samples at 24 kHz, scored by PixelCNN++'s discretized
logistic likelihood (arXiv:1701.05517).  Restated here from those papers,
not from the program: the frontend, the upsampler, the stack, the post-net,
the likelihood (:func:`mol_nll`), the teacher-forced mixture parameters of
served samples (:func:`teacher_params`) and the sampler's draws beside them
(:func:`draws`, :func:`component_draws`).

Departures from arXiv:1712.05884, all of the configuration
(``configs/wavenet_mol_24k.json``, its ``assumed``):

* the widths are r9y9/wavenet_vocoder's ``hparams.py`` (the paper gives
  none): 512 residual channels, 512 gate channels split into the tanh and
  sigmoid halves (256 each), 256 skip channels, 80 conditioning channels;
* the filter width is 2 (WaveNet's Fig. 3), where r9y9 takes 3;
* the post-net is WaveNet's two 1x1 layers (ReLU, 1x1 to n_post, ReLU, 1x1
  to 3 x 10), where the paper describes one projection;
* the frames are the log of the mel power (the paper: of the magnitude, a
  factor 2 that the per-channel normalisation over the dataset absorbs),
  Hann-windowed valid frames of 1,200 samples (50 ms) every 300 (12.5 ms),
  a 2,048-point DFT, a Slaney filterbank from 125 Hz to 7.6 kHz;
* the conditioning stack's layers are each followed by a ReLU; the stack
  has no speaker input.

Parameters carry the program's names (``wavenet.in0.w``,
``wavenet.layers.3.w_cond.b``, ``wavenet.post2.w``), so the benchmark's
seeded weights load into both sides.  Every product the program computes in
bf16 takes its operands and output through ``q`` (``precision.py``).
Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import config as ref_config
from benchmark.reference import mfcc, sampling
from benchmark.reference.conv1d import tconv1d
from benchmark.reference.models import GatedLayer, _conv, _dense, dilations, receptive_field
from benchmark.reference.precision import exact
from benchmark.reference.vconv import Chain, Conv, Range, TConv


@dataclasses.dataclass(frozen=True)
class Vocoder:
    """A configuration file's reference config with the keys the reference
    schema lacks: the mixture's components and log-scale floor."""
    cfg: ref_config.RunConfig
    n_mix: int
    log_scale_min: float


def from_json(s: str) -> Vocoder:
    d = json.loads(s)
    if d["spec"]["n_mfcc"] != 0:
        raise ValueError("the vocoder's reference takes log-mel conditioning (n_mfcc 0)")
    wn = d["wavenet"]
    return Vocoder(ref_config.from_json(s), int(wn["n_mix"]),
                   float(wn.get("log_scale_min", math.log(1e-14))))


# ------------------------------------------------------------------ geometry
def cond_chain(cfg) -> Chain:
    """wav -> conditioning lattice: the STFT frames, then the upsampler."""
    sp, wn = cfg.spec, cfg.wavenet
    return Chain([Conv(sp.win_sz, stride=sp.hop_sz, name="stft_frame")]
                 + [TConv(f, stride=s, name=f"up{i}") for i, (f, s) in
                    enumerate(zip(wn.lc_upsample_filters, wn.lc_upsample_strides))])


def c_offset(cfg) -> int:
    """Cond column t conditions the step that consumes sample t + c_off."""
    r0 = cond_chain(cfg).in_range(Range(0, 1))
    return (r0.b + r0.e) // 2


# ---------------------------------------------------------------- the model
class WaveNet(nn.Module):
    def __init__(self, cfg, n_mix: int):
        super().__init__()
        wn = cfg.wavenet
        self.in0 = _dense(wn.n_res, 1)
        ups, cin = [], cfg.spec.n_mels
        for f in wn.lc_upsample_filters:
            ups.append(_conv(wn.n_lc_out, cin, f))
            cin = wn.n_lc_out
        self.upsample = nn.ModuleList(ups)
        self.layers = nn.ModuleList([GatedLayer(wn) for _ in dilations(wn)])
        self.post1 = _dense(wn.n_post, wn.n_skp)
        self.post2 = _dense(3 * n_mix, wn.n_post)


class Model(nn.Module):
    def __init__(self, voc: Vocoder):
        super().__init__()
        if voc.cfg.wavenet.n_global_embed:
            raise ValueError("the vocoder has no speaker input")
        self.wavenet = WaveNet(voc.cfg, voc.n_mix)


def build(voc: Vocoder, weights: dict, device) -> Model:
    """The model with ``weights`` ({name: tensor}) copied in as float32 on
    ``device``; TF32 off, so every product is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = Model(voc)
    model = model.to_empty(device=device)
    named = dict(model.named_parameters())
    differ = sorted(set(named) ^ set(weights))
    if differ:
        raise KeyError(f"weights and the reference's vocoder differ in {differ[:8]}")
    with torch.no_grad():
        for k, t in named.items():
            t.copy_(weights[k].to(device=device, dtype=torch.float32))
    return model


# ------------------------------------------------------------------ forward
@functools.cache
def _bands(spec, device: str) -> dict:
    """The frontend's matrices up to the mel bands (``mfcc``'s, without the
    DCT), on ``device``."""
    cosm, sinm = mfcc._dft_matrices(spec.win_sz, spec.n_fft)
    arrays = {"window": np.hanning(spec.win_sz + 1)[:-1].astype(np.float32),
              "cos": cosm, "sin": sinm,
              "mel_t": np.ascontiguousarray(mfcc.mel_filterbank(spec).T)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def log_mel(wav: torch.Tensor, spec) -> torch.Tensor:
    """float wav [..., T] -> log mel power [..., n_mels, F] (valid frames)."""
    return mfcc._log_mel(wav, spec, _bands(spec, str(wav.device))).transpose(-1, -2)


def frame_stats(prefix: str, spec) -> tuple:
    """Per-channel mean and variance (float64 sums) of the log-mel frames
    over every clip of the packed dataset long enough for one frame."""
    with open(prefix + ".json") as f:
        index = json.load(f)
    dat = np.memmap(prefix + ".dat", dtype="<i2", mode="r")
    s1, s2, count = np.zeros(spec.n_mels), np.zeros(spec.n_mels), 0
    for clip in index["clips"]:
        x = dat[clip["offset"] : clip["offset"] + clip["length"]]
        if len(x) < spec.win_sz:
            continue
        wav = torch.from_numpy(x.astype(np.float32) * (1.0 / 32768.0))
        frames = log_mel(wav, spec).numpy().astype(np.float64)
        s1 += frames.sum(axis=-1)
        s2 += (frames ** 2).sum(axis=-1)
        count += frames.shape[-1]
    mean = s1 / count
    var = np.maximum(s2 / count - mean ** 2, 1e-12)
    return tuple(float(v) for v in mean), tuple(float(v) for v in var)


def with_stats(voc: Vocoder, prefix: str) -> Vocoder:
    """``voc`` with its dataset's frame statistics (``norm`` "dataset")."""
    sp = voc.cfg.spec
    if sp.norm != "dataset":
        return voc
    mean, var = frame_stats(prefix, sp)
    cfg = dataclasses.replace(voc.cfg, spec=dataclasses.replace(
        sp, stats_mean=mean, stats_var=var))
    return dataclasses.replace(voc, cfg=cfg)


def normalize(frames: torch.Tensor, spec, n_ref: int | None = None) -> torch.Tensor:
    if spec.norm == "dataset":
        mean = torch.tensor(spec.stats_mean, device=frames.device)[:, None]
        var = torch.tensor(spec.stats_var, device=frames.device)[:, None]
        return (frames - mean) * torch.rsqrt(var + 1e-6)
    ref = frames
    if n_ref is not None and frames.shape[-1] > n_ref:
        b = (frames.shape[-1] - n_ref) // 2
        ref = frames[..., b : b + n_ref]
    mean = ref.mean(-1, keepdim=True)
    var = ref.var(-1, unbiased=False, keepdim=True)
    return (frames - mean) * torch.rsqrt(var + 1e-6)


def upsample(wn_p: WaveNet, wn, frames, steps=None, q=exact):
    """frames [B, n_mels, F] -> conditioning [B, n_lc_out, T]: each
    transposed convolution, then a ReLU; ``steps`` trims as a plan says."""
    x = frames
    for i, p in enumerate(wn_p.upsample):
        x = F.relu(q.result(tconv1d(q.operand(x), q.operand(p["w"]), p["b"],
                                    stride=wn.lc_upsample_strides[i])))
        if steps is not None:
            x = x[..., steps[i].trim_l : steps[i].trim_l + steps[i].keep]
    return x


def encode(model: Model, voc: Vocoder, wav_i16, q=exact):
    """Whole-utterance conditioning [B, n_lc_out, Tc] and c_off; the frame
    statistics of ``norm`` "window" over as many frames as a training
    window's."""
    cfg = voc.cfg
    frames = log_mel(wav_i16.float() * (1.0 / 32768.0), cfg.spec)
    frames = normalize(frames, cfg.spec, n_ref=window(voc).n_frames)
    chain = Chain(cond_chain(cfg).layers[1:])
    steps = chain.plan(Range(0, chain.out_len(frames.shape[-1])))
    return upsample(model.wavenet, cfg.wavenet, frames, steps, q), c_offset(cfg)


def stack(wn_p: WaveNet, wn, x, cond, q=exact):
    """Teacher-forced mixture parameters [B, 3K, T_in - rf] of samples x
    [B, T_in] in [-1, 1] under cond [B, n_lc_out, T_in]."""
    def mm(p, v):
        y = torch.einsum("oc,bct->bot", q.operand(p["w"]), q.operand(v))
        return q.result(y + p["b"][None, :, None])

    t_in = x.shape[-1]
    t_out = t_in - receptive_field(wn)
    h = x[:, None, :] * wn_p.in0["w"][None, :, :] + wn_p.in0["b"][None, :, None]
    skip = torch.zeros(x.shape[0], wn.n_skp, t_out, device=x.device)
    offset = 0
    for layer, d in zip(wn_p.layers, dilations(wn)):
        dd = d * (wn.filter_sz - 1)
        cur, prev = h[..., dd:], h[..., : h.shape[-1] - dd]
        offset += dd
        y = mm(layer.w_prev, prev) + mm(layer.w_cur, cur) + mm(layer.w_cond,
                                                               cond[..., offset:t_in])
        f, g = y.chunk(2, 1)
        z = torch.tanh(f) * torch.sigmoid(g)
        h = cur + mm(layer.w_res, z)
        skip = skip + mm(layer.w_skip, z[..., z.shape[-1] - t_out :])
    return mm(wn_p.post2, F.relu(mm(wn_p.post1, F.relu(skip))))


@dataclasses.dataclass(frozen=True)
class Window:
    u_len: int
    fb: int
    fe: int
    w0: int
    t_in: int
    rf: int
    n_win: int
    n_frames: int
    up_steps: tuple


def window(voc: Vocoder, n_win: int | None = None) -> Window:
    """A training window's layout: the frontend's input, the decoder's
    input and the loss targets within a loader window."""
    cfg = voc.cfg
    chain = cond_chain(cfg)
    n_win = cfg.train.n_win if n_win is None else n_win
    rf = receptive_field(cfg.wavenet)
    t_in = n_win + rf
    steps = chain.plan(Range(0, t_in))
    f_in = steps[0].in_want
    c_off = c_offset(cfg)
    return Window(u_len=max(f_in.e, c_off + t_in + 1), fb=f_in.b, fe=f_in.e, w0=c_off,
                  t_in=t_in, rf=rf, n_win=n_win, n_frames=len(steps[0].out_want),
                  up_steps=tuple(steps[1:]))


def mol_nll(params, x, n_levels: int, log_scale_min: float):
    """Mean negative log-likelihood of samples x [B, T] under params [B, 3K,
    T] = [logits | means | log_scales] (PixelCNN++'s discretized logistic
    mixture): each of ``n_levels`` levels is a bin of half-width 1 /
    (n_levels - 1) with the tails at the edges (x < -0.999: the CDF at the
    bin's top; x > 0.999: one less the CDF at its bottom); a bin of mass
    1e-5 or less takes the density at its middle times its width."""
    k = params.shape[1] // 3
    logit, mean = params[:, :k], params[:, k : 2 * k]
    log_s = torch.clamp(params[:, 2 * k :], min=log_scale_min)
    x = x[:, None, :]
    inv_s = torch.exp(-log_s)
    half = 1.0 / (n_levels - 1)
    top = inv_s * (x - mean + half)
    bottom = inv_s * (x - mean - half)
    mass = torch.sigmoid(top) - torch.sigmoid(bottom)
    mid = inv_s * (x - mean)
    log_density = mid - log_s - 2.0 * F.softplus(mid)
    log_bin = torch.where(mass > 1e-5, torch.log(torch.clamp(mass, min=1e-12)),
                          log_density + math.log(2.0 / (n_levels - 1)))
    log_bin = torch.where(x > 0.999, -F.softplus(bottom), log_bin)
    log_bin = torch.where(x < -0.999, F.logsigmoid(top), log_bin)
    return -torch.logsumexp(log_bin + F.log_softmax(logit, 1), 1).mean()


def window_loss(model: Model, voc: Vocoder, win: Window, wav_i16, q=exact):
    """The mixture's mean NLL over training windows wav_i16 [B, u_len]."""
    cfg = voc.cfg
    wav = wav_i16.float() * (1.0 / 32768.0)
    frames = normalize(log_mel(wav[..., win.fb : win.fe], cfg.spec), cfg.spec)
    cond = upsample(model.wavenet, cfg.wavenet, frames, win.up_steps, q)
    x = wav[..., win.w0 : win.w0 + win.t_in]
    tgt = wav[..., win.w0 + 1 + win.rf : win.w0 + 1 + win.rf + win.n_win]
    params = stack(model.wavenet, cfg.wavenet, x, cond, q)
    return mol_nll(params, tgt, cfg.wavenet.n_quant, voc.log_scale_min)


def teacher_params(model: Model, voc: Vocoder, wav_i16, served, n: int, q=exact):
    """Mixture parameters [B, n, 3K] at each served position: the decoder
    reads the input's receptive field before the first generated sample,
    then the served samples ([B, n] int16, or floats in [-1, 1])."""
    cond, c_off = encode(model, voc, wav_i16, q)
    rf = receptive_field(voc.cfg.wavenet)
    ctx = wav_i16[..., c_off : c_off + rf + 1].float() * (1.0 / 32768.0)
    got = served[:, : n - 1]
    got = got.float() * (1.0 / 32768.0) if not got.is_floating_point() else got.float()
    x = torch.cat([ctx, got], 1)
    return stack(model.wavenet, voc.cfg.wavenet, x, cond[..., : rf + n], q).permute(0, 2, 1)


# ----------------------------------------------------------------- sampling
def draws(seed: int, rows: torch.Tensor, t0: int, n: int, n_mix: int):
    """The sampler's draws of batch rows ``rows`` at absolute steps t0 ..
    t0 + n - 1 (``sampling``'s Philox stream): (Gumbel noise [R, n, K] of
    columns 0 .. K - 1, the logistic's uniform [R, n] of column K clamped
    to [1e-5, 0.99999])."""
    dev = rows.device
    col = torch.arange(n_mix + 1, device=dev)
    shape = (rows.shape[0], n, n_mix + 1)
    c0 = (col >> 2).expand(shape)
    c1 = rows.long()[:, None, None].expand(shape)
    c2 = torch.arange(t0, t0 + n, device=dev)[None, :, None].expand(shape)
    words = sampling.philox(c0, c1, c2, torch.zeros_like(c2), seed, 0)
    w = (col & 3).expand(shape)
    bits = torch.where(w == 0, words[0], torch.where(w == 1, words[1],
                       torch.where(w == 2, words[2], words[3])))
    u = (bits >> 8).float() * (1.0 / (1 << 24))
    g = -torch.log(-torch.log(u[..., :n_mix] + 1e-12) + 1e-12)
    return g, torch.clamp(u[..., n_mix], 1e-5, 0.99999)


def scores(params, n_mix: int, temperature: float, g=None):
    """Each component's score [.., K]: its logit over the temperature plus
    its Gumbel draw, or the logit alone at temperature 0."""
    logit = params[..., :n_mix]
    return logit if temperature == 0.0 else logit * (1.0 / temperature) + g


def component_draws(params, n_mix: int, log_scale_min: float, temperature: float,
                    v=None):
    """Each component's sample [.., K] with the logistic's uniform v [..]:
    clamp(mean + exp(max(log_s, floor)) (log v - log(1 - v)), -1, 1), or the
    clamped mean at temperature 0."""
    mean = params[..., n_mix : 2 * n_mix]
    if temperature == 0.0:
        return torch.clamp(mean, -1.0, 1.0)
    log_s = torch.clamp(params[..., 2 * n_mix :], min=log_scale_min)
    noise = (torch.log(v) - torch.log(1.0 - v))[..., None]
    return torch.clamp(mean + torch.exp(log_s) * noise, -1.0, 1.0)


def served_gaps(sc, xk, served, mix_scale: float, value_scale: float):
    """(mix gap, value gap) [..] of served samples (floats in [-1, 1]) given
    the reference's component scores sc and draws xk [.., K].  A served
    sample does not name its component, and near the clipped ends several
    components' draws agree, so the served component is taken to be the one
    that comes nearest to being consistent on both counts: the least, over
    the components, of the larger of its gap over ``mix_scale`` and its
    distance over ``value_scale`` (a cell's two limits).  The mix gap is how
    far its score lies below the best, the value gap how far its draw lies
    from the served sample."""
    dist = (xk - served[..., None]).abs()
    gap = sc.max(-1, keepdim=True).values - sc
    k = torch.maximum(gap / mix_scale, dist / value_scale).argmin(-1, keepdim=True)
    return gap.gather(-1, k)[..., 0], dist.gather(-1, k)[..., 0]
