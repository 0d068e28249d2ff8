"""WaveGlow in plain float32 PyTorch.

Prenger, Valle and Catanzaro 2018, "WaveGlow: A Flow-based Generative
Network for Speech Synthesis" (arXiv:1811.00002), restated from the paper
and from NVIDIA's reference code (github.com/NVIDIA/waveglow ``glow.py``),
not from the program: the log-mel frontend (:func:`log_mel`), the mel upsampler (one ``ConvTranspose1d``, its
last filter - stride outputs cut), the fold of 8 samples into one row and
of the upsampled mel into the 640-channel conditioning, the WN stacks
written with ``conv1d(padding=d, dilation=d)`` as ``glow.py`` writes them
(the cond projection of the whole flow, then per layer tanh(f) sigmoid(g)
of the in-layer plus its slice, res and skip products, the last layer's
skip alone), the affine coupling in both directions, ``Invertible1x1Conv``
in both directions (the inverse from ``torch.linalg.inv`` of W in float64)
and the early outputs (channels that leave every n_early_every flows, and
join again, as fresh noise, on the way back).

Departures from arXiv:1811.00002, all of the configuration
(``configs/waveglow_22k.json``, its ``assumed``):

* weight norm is folded into the weights (the benchmark draws the folded
  weights);
* 256 channels throughout the WN (residual, gate halves and skip), as the
  released ``waveglow_256channels`` checkpoint has, where the paper's text
  says 512 residual and 256 skip channels;
* the conditioning frames are the log of the mel power over valid Hann
  frames (the port's frontend's definition, as for Tacotron 2's vocoder),
  where NVIDIA takes log(clamp(magnitude, 1e-5)) over centred frames; the
  model itself does not depend on which.

The noise of a request is one draw z [B, n_group, T / n_group] (already
scaled by sigma): its first channels start the audio, each early flow met
on the way back prepends the next n_early_size.  Parameters carry the
program's names (``upsample.w`` [n_mels, n_mels, filter] in the transposed
convolution's layout, ``flows.k.W``, ``flows.k.start.w``, ``flows.k.cond.w``,
``flows.k.layers.i.w_in`` [2 n_dil, n_res, 3], ``.b_in``, ``.w_rs``, ``.b_rs``,
``flows.k.end.w``), so the benchmark's seeded weights load into both sides.
Every product takes its operands and output through ``q``
(``precision.py``).  Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.config import SpecConfig
from benchmark.reference.mfcc import mel_filterbank
from benchmark.reference.precision import exact


@dataclasses.dataclass(frozen=True)
class Glow:
    """The widths a configuration file gives."""
    n_mels: int
    hop: int
    filt: int
    n_res: int
    n_dil: int
    n_skp: int
    n_layers: int
    n_flows: int
    n_group: int
    n_early_every: int
    n_early_size: int
    sigma: float

    @property
    def n_cond(self) -> int:
        return self.n_mels * self.n_group

    def channels(self) -> list:
        """Each flow's audio channels, k = 0 .. n_flows - 1."""
        n, out = self.n_group, []
        for k in range(self.n_flows):
            if k % self.n_early_every == 0 and k > 0:
                n -= self.n_early_size
            out.append(n)
        return out


#: NVIDIA's config.json waveglow_config, for a flow key a file leaves out
PUBLISHED = {"n_flows": 12, "n_group": 8, "n_early_every": 4, "n_early_size": 2, "sigma": 0.6}


def from_json(s: str) -> Glow:
    d = json.loads(s)
    wn, fl = d["wavenet"], {**PUBLISHED, **d.get("flow", {})}
    if d.get("model_kind") != "waveglow" or wn["filter_sz"] != 3:
        raise ValueError("not a WaveGlow configuration (model_kind 'waveglow', filter_sz 3)")
    return Glow(n_mels=d["spec"]["n_mels"], hop=wn["lc_upsample_strides"][0],
                filt=wn["lc_upsample_filters"][0], n_res=wn["n_res"], n_dil=wn["n_dil"],
                n_skp=wn["n_skp"], n_layers=wn["n_block_layers"] * wn["n_blocks"],
                n_flows=fl["n_flows"], n_group=fl["n_group"],
                n_early_every=fl["n_early_every"], n_early_size=fl["n_early_size"],
                sigma=float(fl["sigma"]))


def log_mel(wav, spec: dict):
    """wav [B, T] float32 in [-1, 1] -> log-mel frames [B, n_mels, F] over
    the valid frames, F = (T - win) // hop + 1: a periodic Hann window of
    ``win_sz``, ``torch.fft.rfft`` at ``n_fft``, the power through the
    Slaney mel matrix (``mfcc.mel_filterbank``), log clamped at 1e-10.
    ``spec`` is the configuration's ``spec`` group."""
    sp = SpecConfig(**{k: spec[k] for k in ("sample_rate", "win_sz", "hop_sz", "n_fft",
                                            "n_mels", "mel_fmin", "mel_fmax")})
    window = torch.hann_window(sp.win_sz, periodic=True, device=wav.device)
    frames = wav.float().unfold(-1, sp.win_sz, sp.hop_sz) * window
    power = torch.fft.rfft(frames, n=sp.n_fft).abs().square()
    mel = power @ torch.from_numpy(mel_filterbank(sp)).t().to(wav.device)
    return torch.log(torch.clamp(mel, min=1e-10)).transpose(1, 2)


def _pd(**shapes) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(torch.empty(*v)) for k, v in shapes.items()})


class Layer(nn.Module):
    def __init__(self, g: Glow, last: bool):
        super().__init__()
        n_out = g.n_skp if last else g.n_res + g.n_skp
        self.w_in = nn.Parameter(torch.empty(2 * g.n_dil, g.n_res, 3))
        self.b_in = nn.Parameter(torch.empty(2 * g.n_dil))
        self.w_rs = nn.Parameter(torch.empty(n_out, g.n_dil))
        self.b_rs = nn.Parameter(torch.empty(n_out))


class Flow(nn.Module):
    def __init__(self, g: Glow, n_ch: int):
        super().__init__()
        half = n_ch // 2
        self.W = nn.Parameter(torch.empty(n_ch, n_ch))
        self.start = _pd(w=(g.n_res, half), b=(g.n_res,))
        self.cond = _pd(w=(2 * g.n_dil * g.n_layers, g.n_cond), b=(2 * g.n_dil * g.n_layers,))
        self.layers = nn.ModuleList([Layer(g, i == g.n_layers - 1) for i in range(g.n_layers)])
        self.end = _pd(w=(2 * half, g.n_skp), b=(2 * half,))


class Model(nn.Module):
    def __init__(self, g: Glow):
        super().__init__()
        self.upsample = _pd(w=(g.n_mels, g.n_mels, g.filt), b=(g.n_mels,))
        self.flows = nn.ModuleList([Flow(g, c) for c in g.channels()])


def build(g: Glow, weights: dict, device) -> Model:
    """The model with ``weights`` ({name: tensor}) copied in as float32 on
    ``device``; TF32 off, so every product is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = Model(g)
    model = model.to_empty(device=device)
    named = dict(model.named_parameters())
    differ = sorted(set(named) ^ set(weights))
    if differ:
        raise KeyError(f"weights and the reference's WaveGlow differ in {differ[:8]}")
    with torch.no_grad():
        for k, t in named.items():
            t.copy_(weights[k].to(device=device, dtype=torch.float32))
    return model


def _conv(x, w, b, q, **kw):
    """conv1d of x [B, C, T] by w [O, C, k] (or [O, C] as 1x1), then b."""
    if w.dim() == 2:
        w = w[..., None]
    return q.result(F.conv1d(q.operand(x), q.operand(w), **kw) + b[None, :, None])


def upsample(model: Model, g: Glow, mel, q=exact):
    """mel [B, n_mels, F] -> c [B, n_mels x n_group, F x hop / n_group]:
    ``ConvTranspose1d(n_mels, n_mels, filt, stride=hop)``, its last filt -
    hop outputs cut (``glow.py``: ``time_cutoff``), then ``unfold(2,
    n_group, n_group)`` into channels m x n_group + j."""
    u = model.upsample
    up = q.result(F.conv_transpose1d(q.operand(mel), q.operand(u["w"]), u["b"], stride=g.hop))
    up = up[..., : up.shape[-1] - (g.filt - g.hop)]
    up = up.unfold(2, g.n_group, g.n_group).permute(0, 2, 1, 3)
    return up.reshape(up.shape[0], up.shape[1], -1).permute(0, 2, 1)


def wn(fl: Flow, g: Glow, a0, c, q=exact):
    """WN(a0 [B, half, T], c [B, n_cond, T]) -> [B, 2 half, T] = [b | log s]."""
    x = _conv(a0, fl.start["w"], fl.start["b"], q)
    cond = _conv(c, fl.cond["w"], fl.cond["b"], q)
    out = 0.0
    for i, layer in enumerate(fl.layers):
        d = 2 ** i
        acts = _conv(x, layer.w_in, layer.b_in, q, padding=d, dilation=d)
        acts = acts + cond[:, i * 2 * g.n_dil : (i + 1) * 2 * g.n_dil]
        h = torch.tanh(acts[:, : g.n_dil]) * torch.sigmoid(acts[:, g.n_dil :])
        rs = _conv(h, layer.w_rs, layer.b_rs, q)
        if i < g.n_layers - 1:
            x = x + rs[:, : g.n_res]
            out = out + rs[:, g.n_res :]
        else:
            out = out + rs
    return _conv(out, fl.end["w"], fl.end["b"], q)


def inverse_1x1(fl: Flow, audio):
    """``Invertible1x1Conv(reverse=True)``: W^-1 (float64, then float32)."""
    w_inv = torch.linalg.inv(fl.W.double()).float()
    return torch.einsum("oc,bct->bot", w_inv, audio)


def infer(model: Model, g: Glow, mel, z, q=exact):
    """``glow.py``'s ``infer``: mel [B, n_mels, F], the request's noise z [B,
    n_group, F x hop / n_group] (sigma included) -> audio [B, F x hop]."""
    c = upsample(model, g, mel, q)
    chans = g.channels()
    used = chans[-1]
    audio = z[:, :used]
    for k in reversed(range(g.n_flows)):
        half = audio.shape[1] // 2
        a0, a1 = audio[:, :half], audio[:, half:]
        out = wn(model.flows[k], g, a0, c, q)
        a1 = (a1 - out[:, :half]) / torch.exp(out[:, half:])
        audio = inverse_1x1(model.flows[k], torch.cat([a0, a1], 1))
        if k % g.n_early_every == 0 and k > 0:
            audio = torch.cat([z[:, used : used + g.n_early_size], audio], 1)
            used += g.n_early_size
    return audio.permute(0, 2, 1).reshape(audio.shape[0], -1)


def forward(model: Model, g: Glow, audio, c, q=exact):
    """``glow.py``'s training direction: audio [B, T], c [B, n_cond, T /
    n_group] -> (z [B, n_group, T / n_group] in the noise's channel order,
    [log s of each flow], [log det W_k of each flow])."""
    x = audio.unfold(1, g.n_group, g.n_group).permute(0, 2, 1)
    early, log_s, log_det = [], [], []
    for k, fl in enumerate(model.flows):
        if k % g.n_early_every == 0 and k > 0:
            early.append(x[:, : g.n_early_size])
            x = x[:, g.n_early_size :]
        x = torch.einsum("oc,bct->bot", fl.W, x)
        log_det.append(x.shape[0] * x.shape[2] * torch.logdet(fl.W))
        half = x.shape[1] // 2
        out = wn(fl, g, x[:, :half], c, q)
        log_s.append(out[:, half:])
        x = torch.cat([x[:, :half], torch.exp(out[:, half:]) * x[:, half:] + out[:, :half]], 1)
    return torch.cat([x] + early[::-1], 1), log_s, log_det
