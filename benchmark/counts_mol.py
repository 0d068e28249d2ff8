"""Operations and bytes of the vocoder cells with a mixture-of-logistics
output (``reference/mol.py``), from their shapes, as ``counts.py`` counts
the others: one multiply-accumulate is 2 operations, only products and
convolutions count, and a kernel's bytes are its inputs read once and its
outputs written once.  The differences from the mu-law vocoder: the
frontend stops at the log-mel bands (no DCT, no deltas), the post-net's
second product gives 3 n_mix values, the input is the rank-1 map of a
sample (n_res products a row and step), and there is no speaker
embedding.
"""

from __future__ import annotations

from benchmark.counts import _mm, layer_macs
from benchmark.reference.models import dilations, receptive_field


def step_macs(wn, n_mix: int) -> int:
    """Multiply-accumulates of one generated step of one row: the input
    map, every gated layer and the post-net."""
    return (wn.n_res + len(dilations(wn)) * layer_macs(wn) + wn.n_skp * wn.n_post
            + wn.n_post * 3 * n_mix)


def sampler_launch(voc, batch: int, steps: int) -> tuple[int, int]:
    """(operations, bytes) of one sampler launch of ``steps`` samples on
    ``batch`` rows: bytes are the bf16 weights read once (the input map's
    two f32 vectors), each step's bf16 conditioning column read and f32
    sample written, and the bf16 ring state read and written once.  The
    layers whose shares stay in global memory are read again every step
    through L2; that is not counted: the bound is the least work."""
    wn = voc.cfg.wavenet
    macs = step_macs(wn, voc.n_mix)
    ops = 2 * batch * steps * macs
    weights = 2 * (macs - wn.n_res) + 2 * 4 * wn.n_res
    ring = 2 * 2 * batch * receptive_field(wn) * wn.n_res
    return ops, weights + steps * batch * (2 * wn.n_lc_out + 4) + ring


def request_flops(voc, in_samples: int, gen_samples: int, batch: int) -> int:
    """Model operations of vocoding ``batch`` utterances of ``in_samples``:
    the log-mel frontend, the upsampler, prime over the receptive field and
    the generated samples."""
    sp, wn = voc.cfg.spec, voc.cfg.wavenet
    t = (in_samples - sp.win_sz) // sp.hop_sz + 1
    n_bins = sp.n_fft // 2 + 1
    ops = 2 * _mm(t, n_bins, sp.win_sz) + _mm(t, sp.n_mels, n_bins)
    cin = sp.n_mels
    for s, f in zip(wn.lc_upsample_strides, wn.lc_upsample_filters):
        ops += _mm(t, wn.n_lc_out, cin, f)
        cin, t = wn.n_lc_out, (t - 1) * s + 1 - (f - 1)
    ops += 2 * receptive_field(wn) * (wn.n_res + len(dilations(wn)) * layer_macs(wn))
    ops += 2 * gen_samples * step_macs(wn, voc.n_mix)
    return ops * batch
