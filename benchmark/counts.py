"""Operations and bytes of the work a cell asks for, from its shapes.

One multiply-accumulate is 2 operations; only products and convolutions
are counted (gates, softmax, EMA and the optimizer are O(activations) and
O(parameters)), and a product's backward is twice its forward.  The
training step's count is a frozen copy of the program's
``utils/flops.py`` (equal to the JAX package's count, integer for
integer); the gated stack's and the sampler's counts are the least work of
their kernels, with every input byte read once and every output byte
written once, as the card's roofline takes them.
"""

from __future__ import annotations

from benchmark.reference.models import aux_frame_active, dilations, receptive_field


def _mm(t: int, cout: int, cin: int, k: int = 1) -> int:
    return 2 * t * cout * cin * k


def _encoder(cfg, t: int) -> tuple[int, int]:
    enc = cfg.encoder
    e = _mm(t, enc.n_ch, enc.n_in)
    for _ in range(enc.n_pre_res):
        e += _mm(t - 2, enc.n_ch, enc.n_ch, 3) + _mm(t - 4, enc.n_ch, enc.n_ch, 3)
        t -= 4
    t_down = (t - enc.down_filter) // enc.down_stride + 1
    e += _mm(t_down, enc.n_ch, enc.n_ch, enc.down_filter)
    t = t_down
    for _ in range(enc.n_post_res):
        e += _mm(t - 2, enc.n_ch, enc.n_ch, 3) + _mm(t - 4, enc.n_ch, enc.n_ch, 3)
        t -= 4
    return e + _mm(t, enc.n_out, enc.n_ch), t


def _frontend(cfg, n_samples: int) -> tuple[int, int]:
    """The MFCC frontend's operations over ``n_samples``, and its frames."""
    sp = cfg.spec
    f0 = (n_samples - sp.win_sz) // sp.hop_sz + 1
    n_bins = sp.n_fft // 2 + 1
    ops = (2 * _mm(f0, n_bins, sp.win_sz) + _mm(f0, sp.n_mels, n_bins)
           + _mm(f0, sp.n_mfcc, sp.n_mels))
    return ops, f0 - 4 * sp.delta_wing


def layer_macs(wn) -> int:
    """Multiply-accumulates of one gated layer at one position: the two taps
    and the conditioning into 2 n_dil, then h into the residual and skip."""
    n_cond = wn.n_lc_out + wn.n_global_embed
    return (2 * wn.n_res + n_cond) * 2 * wn.n_dil + wn.n_dil * (wn.n_res + wn.n_skp)


def train_step_flops(cfg, spec, batch: int) -> int:
    """Forward and backward operations of one training step of ``batch``
    windows (``utils/flops.py``'s count)."""
    sp, wn, bn = cfg.spec, cfg.wavenet, cfg.bottleneck
    fwd = _frontend(cfg, spec.fe - spec.fb)[0]
    if cfg.model_kind == "mfcc_inverter":
        t_up, cin = spec.n_frames, 3 * sp.n_mfcc
    else:
        e, tz = _encoder(cfg, spec.n_frames)
        fwd += e + (_mm(tz, bn.vq_k, bn.n_dim) if bn.kind == "vq" else 0)
        fwd += _mm(tz, 3 * sp.n_mfcc, bn.n_dim) if aux_frame_active(cfg) else 0
        t_up, cin = tz, wn.n_lc_in
    for i, f in enumerate(wn.lc_upsample_filters):
        fwd += _mm(t_up, wn.n_lc_out, cin, f)
        cin, t_up = wn.n_lc_out, spec.up_steps[i].keep
    n_cond = wn.n_lc_out + wn.n_global_embed
    t_l = spec.t_in
    for dil in dilations(wn):
        t_l -= dil * (wn.filter_sz - 1)
        fwd += 2 * _mm(t_l, 2 * wn.n_dil, wn.n_res) + _mm(t_l, 2 * wn.n_dil, n_cond)
        fwd += _mm(t_l, wn.n_res, wn.n_dil) + _mm(spec.n_win, wn.n_skp, wn.n_dil)
    fwd += _mm(spec.n_win, wn.n_post, wn.n_skp) + _mm(spec.n_win, wn.n_quant, wn.n_post)
    return 3 * fwd * batch


def stack_step(cfg, spec, batch: int) -> tuple[int, int]:
    """(operations, bytes) of the gated stack's forward and backward in one
    training step: each layer's products over the n_win loss positions of
    every row, once forward and twice backward; bytes: the stack's input
    (bf16 residual stream and conditioning), its bf16 weights and f32
    skip output forward, and backward the same read again with the input's
    and conditioning's gradients written and the weights' f32 gradients."""
    wn = cfg.wavenet
    n_layers = len(dilations(wn))
    ops = 3 * 2 * batch * spec.n_win * layer_macs(wn) * n_layers
    n_cond = wn.n_lc_out + wn.n_global_embed
    stream = batch * spec.t_in * (wn.n_res + n_cond) * 2
    w = n_layers * layer_macs(wn)
    fwd = stream + 2 * w + batch * spec.n_win * wn.n_skp * 4
    bwd = fwd + stream + 4 * w
    return ops, fwd + bwd


def sampler_step_macs(wn) -> int:
    return len(dilations(wn)) * layer_macs(wn) + wn.n_skp * wn.n_post + wn.n_post * wn.n_quant


def sampler_launch(cfg, batch: int, steps: int) -> tuple[int, int]:
    """(operations, bytes) of one sampler launch of ``steps`` generated
    samples on ``batch`` rows: every layer's and the post-net's products
    a step and row; bytes: the bf16 weights read once, each step's
    conditioning column read and id written, the ring state read and
    written once."""
    wn = cfg.wavenet
    n_cond = wn.n_lc_out + wn.n_global_embed
    ops = 2 * batch * steps * sampler_step_macs(wn)
    weights = 2 * sampler_step_macs(wn) + 4 * wn.n_quant * wn.n_res
    ring = 2 * 2 * batch * receptive_field(wn) * wn.n_res
    return ops, weights + steps * batch * (2 * n_cond + 4) + ring


def request_flops(cfg, in_samples: int, gen_samples: int, batch: int) -> int:
    """Model operations of one reconstruction of ``batch`` utterances of
    ``in_samples``: the frontend, the encoder and VQ lookup (autoencoder),
    the upsampler, prime over the receptive field and the generated
    samples."""
    wn, sp = cfg.wavenet, cfg.spec
    ops, frames = _frontend(cfg, in_samples)
    if cfg.model_kind == "mfcc_inverter":
        t, cin = frames, 3 * sp.n_mfcc
    else:
        e, t = _encoder(cfg, frames)
        ops += e + _mm(t, cfg.bottleneck.vq_k, cfg.bottleneck.n_dim)
        cin = wn.n_lc_in
    for s, f in zip(wn.lc_upsample_strides, wn.lc_upsample_filters):
        ops += _mm(t, wn.n_lc_out, cin, f)
        cin, t = wn.n_lc_out, (t - 1) * s + 1 - (f - 1)
    ops += 2 * receptive_field(wn) * (len(dilations(wn)) * layer_macs(wn))
    ops += 2 * gen_samples * sampler_step_macs(wn)
    return ops * batch
