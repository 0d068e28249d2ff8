"""WaveGlow: a flow-based vocoder (Prenger, Valle and Catanzaro 2018,
"WaveGlow: A Flow-based Generative Network for Speech Synthesis",
arXiv:1811.00002), the port's own family (``model_kind`` 'waveglow'); the
JAX package has none.

Mel frames [B, n_mels, F] go through one transposed convolution (filter
``lc_upsample_filters[0]``, stride ``lc_upsample_strides[0]``, no ReLU)
whose last filter - stride outputs are cut, so F frames give F x stride
samples; the result is folded into groups of ``flow.n_group`` samples, the
conditioning c [B, T / n_group, n_mels x n_group] (channel m x n_group + j).
Generation is non-autoregressive: the audio starts as sigma N(0, 1) on
the channels that remain after the early outputs, and each of the
``flow.n_flows`` flows, k from the last down to 0, inverts one affine
coupling and one invertible 1x1 convolution:

    (b, log s) = WN_k(a0, c);   a1 <- (a1 - b) exp(-log s)
    audio <- W_k^-1 [a0 | a1];  at k % n_early_every == 0, k > 0:
                                 n_early_size fresh channels prepended

and the rows unfold back into samples.  One WN is a 1x1 ``start`` from
the half's channels to n_res, ``n_block_layers`` non-causal gated layers
(filter 3: taps at t - d, t and t + d with zero padding, dilation 2^i;
``model_kind`` 'waveglow' implies them and the upsampler without ReLU), each conditioned through its slice of one 1x1
``cond`` projection of c a flow, with res and skip products (the last
layer's skip alone), and a 1x1 ``end`` from the summed skip to [b | log s].

The served path (:func:`vocode`) runs time-major ([B, rows, channels]):
the upsampler in bf16, one GEMM a flow for the cond projection (bf16, its
bias folded into the layers' b_in), each layer through K1b's three-tap
mode (``ops/gated_cuda.gated_layer_fused`` with ``cond`` None and the
layer's slice of the projection as the addend of y), and start, end, the
coupling and W_k^-1 (computed once in float64) in f32.  :func:`forward` is
the training direction in float32 PyTorch, for the CPU tests' round trip.

The noise is one draw z [B, n_group, T / n_group] = sigma N(0, 1) from the
caller's generator: its first channels start the audio, the next
n_early_size join at the first early flow met (k = 8 at the published
widths), and so on.

Parameters: ``upsample.{w,b}`` (w [n_mels, n_mels, filter], the transposed
convolution's layout), and per flow ``flows.k.W`` [n, n] (orthogonal),
``flows.k.start.{w,b}``, ``flows.k.cond.{w,b}`` (w [layers x 2 n_dil,
n_cond]), ``flows.k.layers.i.{w_in [2 n_dil, n_res, 3], b_in, w_rs, b_rs}``
(w_rs [n_res + n_skp, n_dil], the last layer's [n_skp, n_dil]) and
``flows.k.end.{w,b}`` [2 x half, n_skp].  Weight norm is folded.  The model
has no training step yet: the three-tap layer has no backward kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ae_wavenet_tpu_torch.audio import mfcc
from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float
from ae_wavenet_tpu_torch.models.common import to_int16
from ae_wavenet_tpu_torch.models.wavenet import _dense
from ae_wavenet_tpu_torch.ops import gated_cuda
from ae_wavenet_tpu_torch.utils import device as device_mod
from ae_wavenet_tpu_torch.utils.config import RunConfig
from ae_wavenet_tpu_torch.utils.profiling import span

BF16 = torch.bfloat16
#: counters of the served path (:func:`vocode`): flows run, and rows of
#: n_group samples generated (B x T / n_group a call)
flows = 0
positions = 0


def check_config(cfg: RunConfig) -> None:
    wn, fl = cfg.wavenet, cfg.flow
    if wn.filter_sz != 3 or wn.n_blocks != 1:
        raise ValueError("waveglow takes one block of non-causal filter-3 layers "
                         "(filter_sz 3, n_blocks 1)")
    if len(wn.lc_upsample_strides) != 1 or wn.n_lc_out != cfg.spec.n_mels:
        raise ValueError("waveglow's upsampler is one transposed convolution that "
                         "keeps the n_mels channels (n_lc_out = n_mels)")
    if wn.lc_upsample_strides[0] % fl.n_group or not cfg.spec.log_mel:
        raise ValueError("waveglow takes log-mel frames (n_mfcc 0) and a hop that "
                         "n_group divides")
    if flow_channels(cfg)[-1] < 2 or flow_channels(cfg)[-1] % 2:
        raise ValueError(f"the flows' channels {flow_channels(cfg)} must stay even")


def flow_channels(cfg: RunConfig) -> list:
    """The audio channels of each flow, k = 0 .. n_flows - 1 (the forward
    direction sheds n_early_size at every n_early_every-th flow)."""
    fl, n, out = cfg.flow, cfg.flow.n_group, []
    for k in range(fl.n_flows):
        if k % fl.n_early_every == 0 and k > 0:
            n -= fl.n_early_size
        out.append(n)
    return out


def n_cond(cfg: RunConfig) -> int:
    return cfg.wavenet.n_lc_out * cfg.flow.n_group


def orthogonal(n: int, gen=None) -> torch.Tensor:
    """A random orthogonal [n, n] with determinant +1 (QR of a normal draw,
    its first column negated where the determinant is -1), as WaveGlow's
    ``Invertible1x1Conv`` starts."""
    q = torch.linalg.qr(torch.randn(n, n, generator=gen))[0]
    if torch.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


class WNLayer(nn.Module):
    def __init__(self, wn, last: bool, gen):
        super().__init__()
        self.w_in = nn.Parameter(torch.randn(2 * wn.n_dil, wn.n_res, 3, generator=gen)
                                 / math.sqrt(3 * wn.n_res))
        self.b_in = nn.Parameter(torch.zeros(2 * wn.n_dil))
        n_out = wn.n_skp if last else wn.n_res + wn.n_skp
        self.w_rs = nn.Parameter(torch.randn(n_out, wn.n_dil, generator=gen)
                                 / math.sqrt(wn.n_dil))
        self.b_rs = nn.Parameter(torch.zeros(n_out))


class Flow(nn.Module):
    """One flow: the invertible 1x1 ``W`` and the coupling's WN."""

    def __init__(self, cfg: RunConfig, n_ch: int, gen):
        super().__init__()
        wn, half, layers = cfg.wavenet, n_ch // 2, cfg.wavenet.n_block_layers
        self.W = nn.Parameter(orthogonal(n_ch, gen))
        self.start = _dense(gen, wn.n_res, half)
        self.cond = _dense(gen, 2 * wn.n_dil * layers, n_cond(cfg))
        self.layers = nn.ModuleList([WNLayer(wn, i == layers - 1, gen) for i in range(layers)])
        # zero, as NVIDIA's WN starts: every coupling the identity
        self.end = _dense(gen, 2 * half, wn.n_skp, 0.0)


class WaveGlow(nn.Module):
    def __init__(self, cfg: RunConfig, generator: torch.Generator | None = None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        n, f = cfg.spec.n_mels, cfg.wavenet.lc_upsample_filters[0]
        self.upsample = nn.ParameterDict({
            "w": nn.Parameter(torch.randn(n, n, f, generator=generator)
                              / math.sqrt(n * f / cfg.wavenet.lc_upsample_strides[0])),
            "b": nn.Parameter(torch.zeros(n))})
        self.flows = nn.ModuleList([Flow(cfg, c, generator) for c in flow_channels(cfg)])


def init(cfg: RunConfig, generator: torch.Generator | None = None, device="cuda") -> WaveGlow:
    """Random weights drawn from ``generator`` (a CPU generator), then moved
    to ``device``: the card, unless the caller passes ``"cpu"``."""
    return WaveGlow(cfg, generator).to(device_mod.resolve(device))


# ----------------------------------------------------------- conditioning
@torch.no_grad()
def encode(model: WaveGlow, cfg: RunConfig, wav_i16: torch.Tensor) -> torch.Tensor:
    """wav [B, T] int16 -> log-mel frames [B, n_mels, F] (valid frames;
    WaveGlow takes them unnormalised)."""
    return mfcc.log_mel_frames(int16_to_float(wav_i16), cfg.spec)


def upsample(model: WaveGlow, cfg: RunConfig, mel: torch.Tensor, dtype=torch.float32):
    """mel [B, n_mels, F] -> c [B, F x hop / n_group, n_mels x n_group]
    time-major, in ``dtype`` (operands and output)."""
    hop, g = cfg.wavenet.lc_upsample_strides[0], cfg.flow.n_group
    b, n, f = mel.shape
    u = model.upsample
    up = F.conv_transpose1d(mel.to(dtype), u["w"].to(dtype), u["b"].to(dtype), stride=hop)
    up = up[..., : f * hop]
    return up.reshape(b, n, f * hop // g, g).permute(0, 2, 1, 3).reshape(b, f * hop // g, n * g)


def noise(cfg: RunConfig, batch: int, rows: int, generator: torch.Generator | None,
          device) -> torch.Tensor:
    """z [B, n_group, rows] = sigma N(0, 1): the one draw of a request."""
    z = torch.randn(batch, cfg.flow.n_group, rows, generator=generator, device=device)
    return z * cfg.flow.sigma


# --------------------------------------------------------- the WN stacks
def _taps(x: torch.Tensor, d: int) -> torch.Tensor:
    """[x[g-d] | x[g] | x[g+d]] of x [B, P, C], zero outside [0, P)."""
    prev = F.pad(x, (0, 0, d, 0))[:, : x.shape[1]]
    nxt = F.pad(x, (0, 0, 0, d))[:, d:]
    return torch.cat([prev, x, nxt], -1)


def wn_plain(cfg: RunConfig, fl: Flow, a0: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One WN in float32: a0 [B, P, half], c [B, P, n_cond] -> [B, P, 2 half]
    = [b | log s]."""
    wn = cfg.wavenet
    x = a0 @ fl.start["w"].t() + fl.start["b"]
    add = c @ fl.cond["w"].t() + fl.cond["b"]
    skip = 0.0
    for i, (layer, d) in enumerate(zip(fl.layers, wn.dilations)):
        w_in = layer.w_in.permute(2, 1, 0).reshape(3 * wn.n_res, 2 * wn.n_dil)
        y = _taps(x, d) @ w_in + layer.b_in + add[..., i * 2 * wn.n_dil : (i + 1) * 2 * wn.n_dil]
        yf, yg = y.chunk(2, -1)
        rs = (torch.tanh(yf) * torch.sigmoid(yg)) @ layer.w_rs.t() + layer.b_rs
        if i < len(fl.layers) - 1:
            x = x + rs[..., : wn.n_res]
        skip = skip + rs[..., -wn.n_skp :]
    return skip @ fl.end["w"].t() + fl.end["b"]


class PackedFlow(NamedTuple):
    """One flow's weights as the served path reads them."""
    w_inv_t: torch.Tensor   # (W^-1)^T f32 [n, n], from float64
    start_w: torch.Tensor   # [half, n_res] f32
    start_b: torch.Tensor
    cond_w: torch.Tensor    # [layers, n_cond, 2 n_dil] bf16
    layers: tuple           # per layer (w_in [3 n_res, 2 n_dil], b_in + b_cond, w_out, b_out)
    end_w: torch.Tensor     # [n_skp, 2 half] f32
    end_b: torch.Tensor


@torch.no_grad()
def pack(model: WaveGlow) -> list:
    """The served path's weights, per flow (:class:`PackedFlow`): w_in as
    the taps' rows (x[g-d], x[g], x[g+d]), the cond projection split by
    layer with its bias folded into the layer's b_in, the last layer's
    out product with zero res columns, and W^-1 computed once in float64."""
    wn = model.cfg.wavenet
    r, dd, s = wn.n_res, wn.n_dil, wn.n_skp
    out = []
    for fl in model.flows:
        n_l = len(fl.layers)
        cond_w = fl.cond["w"].t().reshape(-1, n_l, 2 * dd).permute(1, 0, 2).to(BF16).contiguous()
        cond_b = fl.cond["b"].reshape(n_l, 2 * dd)
        layers = []
        for i, layer in enumerate(fl.layers):
            w_in = layer.w_in.permute(2, 1, 0).reshape(3 * r, 2 * dd).contiguous()
            w_out, b_out = layer.w_rs.t(), layer.b_rs
            if i == n_l - 1:
                w_out = torch.cat([w_out.new_zeros(dd, r), w_out], 1)
                b_out = torch.cat([b_out.new_zeros(r), b_out])
            layers.append(gated_cuda._cast_weights(w_in, layer.b_in + cond_b[i],
                                                   w_out.contiguous(), b_out))
        w_inv = torch.linalg.inv(fl.W.double()).float()
        out.append(PackedFlow(w_inv.t().contiguous(), fl.start["w"].t().contiguous(),
                              fl.start["b"].clone(), cond_w, tuple(layers),
                              fl.end["w"].t().contiguous(), fl.end["b"].clone()))
    return out


def wn_fused(cfg: RunConfig, pk: PackedFlow, a0: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One WN on the served path: a0 [B, P, half] f32, c [B, P, n_cond]
    bf16 -> [B, P, 2 half] f32 (spans ``awt.flow.cond``, the projection's
    GEMM, and ``awt.flow.wn``: start, the layers' K1b launches, end)."""
    b, p, _ = a0.shape
    dils = cfg.wavenet.dilations
    with span("flow.cond"):
        add = torch.matmul(c.reshape(1, b * p, -1), pk.cond_w).view(len(dils), b, p, -1)
    with span("flow.wn"):
        x = (a0 @ pk.start_w + pk.start_b).to(BF16)
        skip = a0.new_zeros(b, p, cfg.wavenet.n_skp)
        for i, d in enumerate(dils):
            x, skip = gated_cuda.gated_layer_fused(x, None, skip, *pk.layers[i], dd=d, r0=0,
                                                   addend=add[i])
        return skip @ pk.end_w + pk.end_b


# ------------------------------------------------------------ generation
def inverse_step(cfg: RunConfig, pk: PackedFlow, audio: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """One flow inverted on audio [B, P, n] (f32): the coupling's a1 <- (a1 -
    b) exp(-log s) with (b, log s) = :func:`wn_fused` (a0, c), then W^-1."""
    half = audio.shape[-1] // 2
    a0, a1 = audio[..., :half], audio[..., half:]
    out = wn_fused(cfg, pk, a0, c)
    with span("flow.coupling"):
        audio = torch.cat([a0, (a1 - out[..., :half]) * torch.exp(-out[..., half:])], -1)
        return audio @ pk.w_inv_t


def infer(cfg: RunConfig, c: torch.Tensor, z: torch.Tensor, packed: list) -> torch.Tensor:
    """The flows inverted on the served path: c [B, P, n_cond] bf16, z [B,
    n_group, P] (:func:`noise`), ``packed`` (:func:`pack`) -> audio [B, P x
    n_group] f32."""
    fl_cfg = cfg.flow
    zt = z.transpose(1, 2).float()
    used = flow_channels(cfg)[-1]
    audio = zt[..., :used]
    for k in reversed(range(fl_cfg.n_flows)):
        audio = inverse_step(cfg, packed[k], audio, c)
        with span("flow.coupling"):
            if k % fl_cfg.n_early_every == 0 and k > 0:
                audio = torch.cat([zt[..., used : used + fl_cfg.n_early_size], audio], -1)
                used += fl_cfg.n_early_size
    return audio.reshape(audio.shape[0], -1)


def forward(model: WaveGlow, cfg: RunConfig, audio: torch.Tensor, c: torch.Tensor):
    """The training direction in float32: audio [B, T] in [-1, 1], c [B, T /
    n_group, n_cond] -> (z [B, n_group, T / n_group] in :func:`noise`'s
    channel order, [log s of each flow], [log det W_k of each flow])."""
    fl_cfg = cfg.flow
    b = audio.shape[0]
    x = audio.reshape(b, -1, fl_cfg.n_group)
    early, log_s, log_det = [], [], []
    for k, fl in enumerate(model.flows):
        if k % fl_cfg.n_early_every == 0 and k > 0:
            early.append(x[..., : fl_cfg.n_early_size])
            x = x[..., fl_cfg.n_early_size :]
        x = x @ fl.W.t()
        log_det.append(x.shape[0] * x.shape[1] * torch.logdet(fl.W))
        half = x.shape[-1] // 2
        a0, a1 = x[..., :half], x[..., half:]
        out = wn_plain(cfg, fl, a0, c.float())
        a1 = torch.exp(out[..., half:]) * a1 + out[..., :half]
        log_s.append(out[..., half:])
        x = torch.cat([a0, a1], -1)
    z = torch.cat([x] + early[::-1], -1)
    return z.transpose(1, 2), log_s, log_det


@torch.no_grad()
def vocode(model: WaveGlow, cfg: RunConfig, mel: torch.Tensor,
           generator: torch.Generator | None = None, packed: list | None = None,
           z: torch.Tensor | None = None) -> torch.Tensor:
    """mel [B, n_mels, F] -> int16 samples [B, F x hop] on the served path:
    the upsampler in bf16 (span ``awt.flow.upsample``), the noise
    (:func:`noise`, from ``generator``, unless ``z`` is given; span
    ``awt.flow.coupling``, as the couplings, W^-1 and the early channels),
    the flows (:func:`infer`).  ``packed``: :func:`pack`'s weights, packed here when
    None.  Counts the flows run (:data:`flows`) and the rows of n_group
    samples generated (:data:`positions`)."""
    global flows, positions
    packed = pack(model) if packed is None else packed
    with span("flow.upsample"):
        c = upsample(model, cfg, mel, BF16)
    if z is None:
        with span("flow.coupling"):
            z = noise(cfg, c.shape[0], c.shape[1], generator, c.device)
    out = to_int16(infer(cfg, c, z, packed))
    flows += cfg.flow.n_flows
    positions += c.shape[0] * c.shape[1]
    return out


def reconstruct(model: WaveGlow, cfg: RunConfig, wav_i16: torch.Tensor, spk=None,
                generator: torch.Generator | None = None, temperature: float = 1.0,
                n_samples: int | None = None, timings: dict | None = None, quantized=False):
    """Vocode an utterance from its own mel frames: -> (int16 [B, F x hop],
    start), start the input position of the first sample (the first
    frame's centre less half a hop).  ``temperature`` scales sigma (1: the
    configuration's); ``spk`` and ``quantized`` are taken for the shared
    signature (WaveGlow has no speaker input and no quantized path);
    ``n_samples`` trims the output.  ``timings`` gets ``encode`` (the mel),
    ``prime`` (0: nothing is primed) and ``generate``."""
    import time

    del spk
    if quantized:
        raise NotImplementedError("waveglow has no quantized path")
    dev = wav_i16.device
    t0 = time.perf_counter()
    mel = encode(model, cfg, wav_i16)
    t1 = time.perf_counter()
    rows = mel.shape[-1] * cfg.wavenet.lc_upsample_strides[0] // cfg.flow.n_group
    gen_dev = dev if generator is None else generator.device
    z = noise(cfg, mel.shape[0], rows, generator, gen_dev).to(dev) * temperature
    out = vocode(model, cfg, mel, z=z)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    if timings is not None:
        timings.update(encode=t1 - t0, prime=0.0, generate=t2 - t1)
    if n_samples is not None:
        out = out[:, :n_samples]
    sp = cfg.spec
    return out, (sp.win_sz - sp.hop_sz) // 2


def make_window_spec(cfg: RunConfig, n_win: int | None = None):
    raise NotImplementedError("waveglow has no training step yet: the three-tap gated "
                              "layer has no backward kernel")


def draws(model, cfg, spec, batch, generator, device) -> dict:
    return {}


def loss_fn(model, cfg, spec, wav_i16, spk, step=None, train=True, generator=None,
            draws=None, group=None):
    raise NotImplementedError("waveglow has no training step yet: the three-tap gated "
                              "layer (ops/gated_cuda.gated_layer_fused with cond None) "
                              "has no backward kernel")
