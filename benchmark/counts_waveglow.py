"""Operations and bytes of WaveGlow's served request
(``configs/waveglow_22k.json``, ``reference/waveglow.py``), from its shapes,
as ``counts.py`` counts the others: one multiply-accumulate is 2
operations, only products and convolutions count (the couplings, the
gates and the noise are O(activations)), and a kernel's bytes are its
inputs read once and its outputs written once.
"""

from __future__ import annotations


def layer_launch(g, batch: int, rows: int) -> tuple[int, int]:
    """(operations, bytes) of one three-tap gated layer (K1b's three-tap
    mode) on ``batch`` x ``rows`` rows: the three taps into 2 n_dil and h
    into res and skip (the last layer's res columns are zero and counted:
    the kernel computes them); bytes: x read and x' written (bf16), the f32
    skip read and written, the bf16 addend read, the bf16 weights and f32
    biases read once."""
    n = batch * rows
    macs = 3 * g.n_res * 2 * g.n_dil + g.n_dil * (g.n_res + g.n_skp)
    weights = 2 * (3 * g.n_res * 2 * g.n_dil + g.n_dil * (g.n_res + g.n_skp)) + 4 * (
        2 * g.n_dil + g.n_res + g.n_skp)
    streams = n * (2 * 2 * g.n_res + 2 * 4 * g.n_skp + 2 * 2 * g.n_dil)
    return 2 * n * macs, weights + streams


def request_flops(g, batch: int, frames: int) -> int:
    """Model operations of vocoding ``batch`` clips of ``frames`` mel frames:
    the upsampler, and in each flow the start, the cond projection, every
    gated layer, the end and the inverse 1x1 convolution."""
    t = frames * g.hop
    rows = t // g.n_group
    ops = 2 * frames * g.n_mels * g.n_mels * g.filt  # every input frame meets every tap
    for n_ch in g.channels():
        half = n_ch // 2
        ops += 2 * rows * (g.n_res * half + g.n_cond * 2 * g.n_dil * g.n_layers
                           + 2 * half * g.n_skp + n_ch * n_ch)
        ops += g.n_layers * layer_launch(g, 1, rows)[0]
    return ops * batch
