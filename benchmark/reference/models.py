"""The two model families in plain float32 PyTorch.

Parameters and buffers carry the program's names (``encoder.stem.w``,
``wavenet.layers.3.w_cond.b``, ``bottleneck.codebook``, ``aux_frame.w``,
...), so one set of weights made by the benchmark loads into both sides.
Every product the program computes in bf16 (the encoder's and upsampler's
convolutions, the gated stack's and post-net's products) takes its operands
and output through ``q`` (``precision.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import mfcc
from benchmark.reference.config import EncoderConfig, RunConfig, WaveNetConfig
from benchmark.reference.conv1d import conv1d, tconv1d
from benchmark.reference.mulaw import int16_to_float, mu_encode
from benchmark.reference.precision import exact
from benchmark.reference.vconv import Chain, Conv, PlanStep, Range, TConv


# ------------------------------------------------------------------ geometry
def dilations(cfg: WaveNetConfig) -> Tuple[int, ...]:
    return tuple(2**i for _ in range(cfg.n_blocks) for i in range(cfg.n_block_layers))


def receptive_field(cfg: WaveNetConfig) -> int:
    return (cfg.filter_sz - 1) * sum(dilations(cfg))


def upsample_geometry(cfg: WaveNetConfig) -> Chain:
    return Chain([TConv(f, stride=s, name=f"up{i}") for i, (f, s) in
                  enumerate(zip(cfg.lc_upsample_filters, cfg.lc_upsample_strides))])


def encoder_geometry(cfg: EncoderConfig) -> Chain:
    layers = []
    for i in range(cfg.n_pre_res):
        layers += [Conv(3, name=f"pre{i}a"), Conv(3, name=f"pre{i}b")]
    layers.append(Conv(cfg.down_filter, stride=cfg.down_stride, name="down"))
    for i in range(cfg.n_post_res):
        layers += [Conv(3, name=f"post{i}a"), Conv(3, name=f"post{i}b")]
    layers.append(Conv(1, name="head"))
    return Chain(layers)


def cond_chain(cfg: RunConfig) -> Chain:
    if cfg.model_kind == "mfcc_inverter":
        return cfg.spec.geometry() + upsample_geometry(cfg.wavenet)
    return (cfg.spec.geometry() + encoder_geometry(cfg.encoder)
            + upsample_geometry(cfg.wavenet))


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    u_len: int
    fb: int
    fe: int
    w0: int
    t_in: int
    rf: int
    n_win: int
    n_frames: int
    up_steps: Tuple[PlanStep, ...]

    @property
    def tgt_b(self) -> int:
        return self.w0 + 1 + self.rf


def window_spec(cfg: RunConfig, n_win: int | None = None) -> WindowSpec:
    """The training window's layout: where the frontend's input, the
    decoder's input and the loss targets sit in a loader window."""
    chain = cond_chain(cfg)
    n_win = cfg.train.n_win if n_win is None else n_win
    rf = receptive_field(cfg.wavenet)
    t_in = n_win + rf
    if chain.total_stride() != (1, 1):
        raise ValueError("the cond chain must have a net stride of 1")
    steps = chain.plan(Range(0, t_in))
    f_in = steps[0].in_want
    r0 = chain.in_range(Range(0, 1))
    c_off = (r0.b + r0.e) // 2
    u_len = max(f_in.e, c_off + t_in + 1)
    n_front = len(cfg.spec.geometry().layers)
    enc_in = steps[n_front].in_want if n_front < len(steps) else steps[-1].out_want
    n_up = len(cfg.wavenet.lc_upsample_strides)
    return WindowSpec(u_len=u_len, fb=f_in.b, fe=f_in.e, w0=c_off, t_in=t_in, rf=rf,
                      n_win=n_win, n_frames=len(enc_in),
                      up_steps=tuple(steps[len(steps) - n_up:]))


def frame_align(cfg: RunConfig) -> tuple[int, int]:
    ch = encoder_geometry(cfg.encoder)
    r0, r1 = ch.in_range(Range(0, 1)), ch.in_range(Range(1, 2))
    c0 = (r0.b + r0.e - 1) // 2
    return c0, max((r1.b + r1.e - 1) // 2 - c0, 1)


def aux_frame_active(cfg: RunConfig) -> bool:
    return (cfg.model_kind != "mfcc_inverter" and cfg.train.aux_frame_weight > 0
            and cfg.bottleneck.kind != "zero")


# -------------------------------------------------------------- parameters
def _dense(cout: int, cin: int) -> nn.ParameterDict:
    return nn.ParameterDict({"w": nn.Parameter(torch.empty(cout, cin)),
                             "b": nn.Parameter(torch.empty(cout))})


def _conv(cout: int, cin: int, f: int) -> nn.ParameterDict:
    return nn.ParameterDict({"w": nn.Parameter(torch.empty(cout, cin, f)),
                             "b": nn.Parameter(torch.empty(cout))})


def _ln(c: int) -> nn.ParameterDict:
    return nn.ParameterDict({"g": nn.Parameter(torch.empty(c)),
                             "o": nn.Parameter(torch.empty(c))})


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        c = cfg.n_ch

        def pair():
            return nn.ModuleDict({"a": _conv(c, c, 3), "b": _conv(c, c, 3), "ln": _ln(c)})

        self.stem = _conv(c, cfg.n_in, 1)
        self.pre = nn.ModuleList([pair() for _ in range(cfg.n_pre_res)])
        self.down = _conv(c, c, cfg.down_filter)
        self.down_ln = _ln(c)
        self.post = nn.ModuleList([pair() for _ in range(cfg.n_post_res)])
        self.head = _conv(cfg.n_out, c, 1)


class GatedLayer(nn.Module):
    def __init__(self, cfg: WaveNetConfig):
        super().__init__()
        n_cond = cfg.n_lc_out + cfg.n_global_embed
        self.w_prev = _dense(2 * cfg.n_dil, cfg.n_res)
        self.w_cur = _dense(2 * cfg.n_dil, cfg.n_res)
        self.w_cond = _dense(2 * cfg.n_dil, n_cond)
        self.w_res = _dense(cfg.n_res, cfg.n_dil)
        self.w_skip = _dense(cfg.n_skp, cfg.n_dil)


class WaveNet(nn.Module):
    def __init__(self, cfg: WaveNetConfig, n_lc_in: int):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(cfg.n_quant, cfg.n_res))
        self.gc_embed = nn.Parameter(torch.empty(cfg.n_speakers, cfg.n_global_embed))
        ups, cin = [], n_lc_in
        for f in cfg.lc_upsample_filters:
            ups.append(_conv(cfg.n_lc_out, cin, f))
            cin = cfg.n_lc_out
        self.upsample = nn.ModuleList(ups)
        self.layers = nn.ModuleList([GatedLayer(cfg) for _ in dilations(cfg)])
        self.post1 = _dense(cfg.n_post, cfg.n_skp)
        self.post2 = _dense(cfg.n_quant, cfg.n_post)


class VQState(nn.Module):
    """The EMA codebook's state (buffers; G = 1 keeps ungrouped shapes)."""

    def __init__(self, cfg):
        super().__init__()
        g = cfg.vq_groups
        shape = (cfg.vq_k, cfg.n_dim) if g == 1 else (g, cfg.vq_k, cfg.n_dim // g)
        self.register_buffer("codebook", torch.empty(shape))
        self.register_buffer("ema_counts", torch.empty(shape[:-1]))
        self.register_buffer("ema_sums", torch.empty(shape))


class Model(nn.Module):
    """The autoencoder (``encoder``, ``bottleneck``, ``wavenet``,
    ``aux_frame``) or the MFCC inverter (``wavenet`` alone)."""

    def __init__(self, cfg: RunConfig):
        super().__init__()
        if cfg.model_kind == "mfcc_inverter":
            self.wavenet = WaveNet(cfg.wavenet, 3 * cfg.spec.n_mfcc)
            return
        if cfg.bottleneck.kind != "vq":
            raise NotImplementedError("the reference restates the VQ bottleneck only")
        self.encoder = Encoder(cfg.encoder)
        self.wavenet = WaveNet(cfg.wavenet, cfg.wavenet.n_lc_in)
        self.bottleneck = VQState(cfg.bottleneck)
        if aux_frame_active(cfg):
            n_ch, d = 3 * cfg.spec.n_mfcc, cfg.bottleneck.n_dim
            self.aux_frame = nn.ParameterDict({"w": nn.Parameter(torch.empty(n_ch, d)),
                                               "b": nn.Parameter(torch.empty(n_ch))})


def build(cfg: RunConfig, weights: dict, device) -> Model:
    """The model with ``weights`` ({name: tensor}, every parameter and
    buffer) copied in as float32 on ``device``."""
    with torch.device("meta"):
        model = Model(cfg)
    model = model.to_empty(device=device)
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    missing = sorted(set(named) ^ set(weights))
    if missing:
        raise KeyError(f"weights and the reference's model differ in {missing[:8]}")
    with torch.no_grad():
        for k, t in named.items():
            t.copy_(weights[k].to(device=device, dtype=torch.float32))
    return model


# ------------------------------------------------------------------ forward
def _lnorm(p, x):
    mean = x.mean(1, keepdim=True)
    var = x.var(1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6) * p["g"][None, :, None] + p["o"][None, :, None]


def encoder_apply(enc: Encoder, cfg: EncoderConfig, x, q=exact):
    """MFCC stack [B, n_in, F] -> latents [B, n_out, Tz]."""
    def conv(p, v, **kw):
        return q.result(conv1d(q.operand(v), q.operand(p["w"]), p["b"], **kw))

    def res_pair(p, v):
        h = F.relu(conv(p["a"], v))
        h = conv(p["b"], h)
        return _lnorm(p["ln"], F.relu(v[..., 2:-2] + h))

    x = F.relu(conv(enc.stem, x))
    for p in enc.pre:
        x = res_pair(p, x)
    x = _lnorm(enc.down_ln, F.relu(conv(enc.down, x, stride=cfg.down_stride)))
    for p in enc.post:
        x = res_pair(p, x)
    return conv(enc.head, x)


def upsample_apply(wn: WaveNet, cfg: WaveNetConfig, z, steps=None, q=exact):
    x = z
    for i, p in enumerate(wn.upsample):
        x = F.relu(q.result(tconv1d(q.operand(x), q.operand(p["w"]), p["b"],
                                    stride=cfg.lc_upsample_strides[i])))
        if steps is not None:
            x = x[..., steps[i].trim_l : steps[i].trim_l + steps[i].keep]
    return x


def with_gc(wn: WaveNet, cfg: WaveNetConfig, cond, gc_ids):
    b, _, t = cond.shape
    g = wn.gc_embed[gc_ids][:, :, None].expand(b, cfg.n_global_embed, t)
    return torch.cat([cond, g], 1)


def stack_apply(wn: WaveNet, cfg: WaveNetConfig, x_ids, cond, gc_ids, q=exact):
    """Teacher-forced logits [B, n_quant, T_in - rf] of ids x_ids [B, T_in]
    under cond [B, n_lc_out, T_in]."""
    def mm(p, v):
        y = torch.einsum("oc,bct->bot", q.operand(p["w"]), q.operand(v))
        return q.result(y + p["b"][None, :, None])

    t_in = x_ids.shape[-1]
    t_out = t_in - receptive_field(cfg)
    x = wn.embed[x_ids].permute(0, 2, 1)
    cond = with_gc(wn, cfg, cond, gc_ids)
    skip = torch.zeros(x.shape[0], cfg.n_skp, t_out, device=x.device)
    offset = 0
    for layer, d in zip(wn.layers, dilations(cfg)):
        dd = d * (cfg.filter_sz - 1)
        cur, prev = x[..., dd:], x[..., : x.shape[-1] - dd]
        offset += dd
        y = mm(layer.w_prev, prev) + mm(layer.w_cur, cur) + mm(layer.w_cond,
                                                               cond[..., offset:t_in])
        f, g = y.chunk(2, 1)
        h = torch.tanh(f) * torch.sigmoid(g)
        x = cur + mm(layer.w_res, h)
        skip = skip + mm(layer.w_skip, h[..., h.shape[-1] - t_out:])
    h = F.relu(mm(wn.post1, F.relu(skip)))
    return mm(wn.post2, h)


def normalize_frames(frames, spec, n_ref=None):
    if spec.norm == "dataset":
        mean = torch.tensor(spec.stats_mean, device=frames.device)[:, None]
        var = torch.tensor(spec.stats_var, device=frames.device)[:, None]
        return (frames - mean) * torch.rsqrt(var + 1e-6)
    ref = frames
    t = frames.shape[-1]
    if n_ref is not None and t > n_ref:
        b = (t - n_ref) // 2
        ref = frames[..., b : b + n_ref]
    mean = ref.mean(-1, keepdim=True)
    var = ref.var(-1, unbiased=False, keepdim=True)
    return (frames - mean) * torch.rsqrt(var + 1e-6)


def nearest(zf, codebook):
    """Nearest code of each row of zf [N, D] in codebook [K, D]."""
    d2 = (zf.square().sum(1, keepdim=True) - 2.0 * zf @ codebook.t()
          + codebook.square().sum(1)[None, :])
    return d2.argmin(1)


def jitter(zq, u, p: float):
    left = torch.cat([zq[..., :1], zq[..., :-1]], -1)
    right = torch.cat([zq[..., 1:], zq[..., -1:]], -1)
    out = torch.where(u < p / 2, left, zq)
    return torch.where(u > 1.0 - p / 2, right, out)


def encode(model: Model, cfg: RunConfig, wav_i16):
    """Whole-utterance conditioning [B, n_lc_out, Tc] and its offset c_off
    (cond column t conditions the step that consumes sample t + c_off)."""
    chain = cond_chain(cfg)
    r0 = chain.in_range(Range(0, 1))
    c_off = (r0.b + r0.e) // 2
    frames = mfcc.mfcc_delta_stack(int16_to_float(wav_i16), cfg.spec)
    frames = normalize_frames(frames, cfg.spec, n_ref=window_spec(cfg).n_frames)
    if cfg.model_kind == "mfcc_inverter":
        z = frames
    else:
        if cfg.bottleneck.vq_groups != 1:
            raise NotImplementedError("grouped VQ")
        ze = encoder_apply(model.encoder, cfg.encoder, frames)
        b, d, t = ze.shape
        zf = ze.permute(0, 2, 1).reshape(b * t, d)
        cb = model.bottleneck.codebook
        z = cb[nearest(zf, cb)].reshape(b, t, d).permute(0, 2, 1)
    up = upsample_geometry(cfg.wavenet)
    steps = up.plan(Range(0, up.out_len(z.shape[-1])))
    return upsample_apply(model.wavenet, cfg.wavenet, z, steps), c_off


def window_row(model: Model, cfg: RunConfig, spec: WindowSpec, wav_i16, spk,
               jitter_u, q=exact) -> dict:
    """One training window (a batch of one row): the row's mean CE, its VQ
    commitment, aux MSE, detached latents and EMA statistics, so that the
    caller can combine rows into the batch's loss and the codebook's
    update.  The codebook read is the one before this step's update."""
    wav = int16_to_float(wav_i16)
    frames = normalize_frames(mfcc.mfcc_delta_stack(wav[..., spec.fb : spec.fe], cfg.spec),
                              cfg.spec)
    out = {}
    if cfg.model_kind == "mfcc_inverter":
        zq = frames
    else:
        bn = cfg.bottleneck
        z = encoder_apply(model.encoder, cfg.encoder, frames, q)
        b, d, t = z.shape
        zf = z.permute(0, 2, 1).reshape(b * t, d)
        cb = model.bottleneck.codebook
        with torch.no_grad():
            idx = nearest(zf.detach(), cb)
            onehot = F.one_hot(idx, bn.vq_k).float()
            out["counts"] = onehot.sum(0)
            out["sums"] = onehot.t() @ zf.detach()
            out["zf"] = zf.detach()
        qv = cb[idx]
        out["commitment"] = (zf - qv).square().sum(1).mean()
        zq = (zf + (qv - zf).detach()).reshape(b, t, d).permute(0, 2, 1)
        clean = zq
        if bn.jitter_p > 0.0:
            zq = jitter(zq, jitter_u, bn.jitter_p)
        if aux_frame_active(cfg):
            c0, s = frame_align(cfg)
            tz = clean.shape[-1]
            tgt = frames[..., c0 : c0 + s * tz : s].detach()
            head = model.aux_frame
            pred = torch.einsum("bdt,cd->bct", clean, head["w"]) + head["b"][None, :, None]
            out["aux_frame_mse"] = (pred - tgt).square().mean()
    cond = upsample_apply(model.wavenet, cfg.wavenet, zq, spec.up_steps, q)
    ids = mu_encode(wav, cfg.wavenet.n_quant)
    logits = stack_apply(model.wavenet, cfg.wavenet, ids[..., spec.w0 : spec.w0 + spec.t_in],
                         cond, spk, q)
    tgt = ids[..., spec.tgt_b : spec.tgt_b + spec.n_win]
    logp = torch.log_softmax(logits, 1)
    out["recon_ce"] = -logp.gather(1, tgt[:, None, :]).mean()
    return out


def smoothed_codebook(cfg, counts, sums):
    """The codebook that EMA counts [K] and sums [K, D] give: the sums over
    the Laplace-smoothed counts."""
    n = counts.sum()
    smoothed = (counts + cfg.ema_eps) / (n + cfg.vq_k * cfg.ema_eps) * n
    return sums / smoothed[:, None]


def ema_update(state: VQState, cfg, counts, sums, zf_all, restart_idx):
    """The EMA codebook update from the batch's counts [K] and sums [K, D]
    (Laplace smoothing, dead-code restarts from the batch's latents)."""
    cnt, sm = state.ema_counts, state.ema_sums
    decay = cfg.ema_decay
    new_counts = decay * cnt + (1.0 - decay) * counts
    new_sums = decay * sm + (1.0 - decay) * sums
    new_codebook = smoothed_codebook(cfg, new_counts, new_sums)
    if cfg.vq_restart_thresh > 0.0:
        cand = zf_all[restart_idx.reshape(-1).long()]
        dead = new_counts < cfg.vq_restart_thresh
        new_codebook = torch.where(dead[:, None], cand, new_codebook)
        new_sums = torch.where(dead[:, None], cand, new_sums)
        new_counts = torch.where(dead, torch.ones_like(new_counts), new_counts)
    state.codebook.copy_(new_codebook)
    state.ema_sums.copy_(new_sums)
    state.ema_counts.copy_(new_counts)


def perplexity(counts) -> torch.Tensor:
    avg = counts / torch.clamp(counts.sum(), min=1.0)
    return torch.exp(-(avg * torch.log(torch.clamp(avg, min=1e-10))).sum())


def teacher_logits(model: Model, cfg: RunConfig, wav_i16, spk, served, n: int,
                   q=exact):
    """Logits [B, n, n_quant] of the reference at each served position: the
    decoder reads the input's receptive field before the first generated
    sample, then the served ids, under the utterance's own conditioning.
    ``served`` [B, n] are the ids the program emitted."""
    cond, c_off = encode(model, cfg, wav_i16)
    rf = receptive_field(cfg.wavenet)
    ids = mu_encode(int16_to_float(wav_i16), cfg.wavenet.n_quant)
    ctx = ids[..., c_off : c_off + rf + 1]
    x = torch.cat([ctx, served[:, : n - 1].long()], 1)
    logits = stack_apply(model.wavenet, cfg.wavenet, x, cond[..., : rf + n], spk, q)
    return logits.permute(0, 2, 1)
