"""Analytic FLOP count of the training step, and the card's peak, for MFU.

Counterpart of ``ae_wavenet_tpu.utils.flops``.  One multiply-accumulate is
2 FLOPs, and only the matmul and conv FLOPs are counted (gates, softmax-CE,
EMA updates and the optimizer are O(activations) or O(parameters), under
1% of the dilated stack's products at the flagship shapes).  A product's
backward costs twice its forward (the data and the weight gradients), so
a training step is 3x the forward count.  Every sequence length is the
model's own VALID-window arithmetic.

For the autoencoder the counts equal the reference's, integer for
integer.  For the MFCC inverter the count is the inverter's own graph:
the frontend, the upsampler from ``3 * n_mfcc`` channels (``n_mels`` with
log-mel conditioning, which has no DCT), the decoder.
(The reference charges the inverter the autoencoder's encoder, bottleneck
and an upsampler from ``n_lc_in`` channels: a quirk not copied.)
"""

from __future__ import annotations

from ae_wavenet_tpu_torch.models.common import WindowSpec
from ae_wavenet_tpu_torch.utils.config import RunConfig

# Peak dense bf16 FLOP/s (without sparsity) of the NVIDIA H100 variants,
# from NVIDIA's H100 data sheet, by a part of the name CUDA reports for the
# card; the first part found in the name decides.
H100_PEAK_BF16_FLOPS = (
    ("pcie", 756e12),   # "NVIDIA H100 PCIe"
    ("nvl", 835e12),    # "NVIDIA H100 NVL"
    ("sxm", 989e12),    # "NVIDIA H100 SXM5 94GB"
    ("hbm3", 989e12),   # "NVIDIA H100 80GB HBM3", the SXM part
)


def peak_bf16_flops(device_kind: str | None = None) -> float | None:
    """Peak dense bf16 FLOP/s for ``device_kind`` (default: the name of CUDA
    card 0), or None when the card is unknown or there is no card."""
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(0)
    dk = device_kind.lower().replace(" ", "")
    if "h100" not in dk:
        return None
    return next((v for part, v in H100_PEAK_BF16_FLOPS if part in dk), None)


def _mm(t: int, cout: int, cin: int, k: int = 1) -> int:
    """FLOPs of a length-t 1-D conv as a matmul: [cout, cin*k] x [cin*k, t]."""
    return 2 * t * cout * cin * k


def _encoder(cfg: RunConfig, t: int) -> tuple[int, int]:
    """The encoder's FLOPs over ``t`` frames, and its latent length."""
    enc = cfg.encoder
    e = _mm(t, enc.n_ch, enc.n_in)                      # stem
    for _ in range(enc.n_pre_res):
        e += _mm(t - 2, enc.n_ch, enc.n_ch, 3)
        e += _mm(t - 4, enc.n_ch, enc.n_ch, 3)
        t -= 4
    t_down = (t - enc.down_filter) // enc.down_stride + 1
    e += _mm(t_down, enc.n_ch, enc.n_ch, enc.down_filter)
    t = t_down
    for _ in range(enc.n_post_res):
        e += _mm(t - 2, enc.n_ch, enc.n_ch, 3)
        e += _mm(t - 4, enc.n_ch, enc.n_ch, 3)
        t -= 4
    e += _mm(t, enc.n_out, enc.n_ch)                    # head
    return e, t


def forward_flops(cfg: RunConfig, spec: WindowSpec) -> dict:
    """Per-item (batch element) forward FLOPs by component: ``mfcc``,
    ``encoder``, ``bottleneck``, ``aux_frame``, ``upsample``, ``decoder``
    and ``total`` (the inverter's encoder, bottleneck and aux head are 0)."""
    from ae_wavenet_tpu_torch.models import autoencoder as ae_mod

    sp, wn, bn = cfg.spec, cfg.wavenet, cfg.bottleneck
    out: dict[str, int] = {}

    # MFCC frontend: DFT (cos and sin), mel filterbank and DCT as matmuls
    # over the frames of the raw window U[fb:fe]
    f0 = (spec.fe - spec.fb - sp.win_sz) // sp.hop_sz + 1
    n_bins = sp.n_fft // 2 + 1
    out["mfcc"] = (2 * _mm(f0, n_bins, sp.win_sz) + _mm(f0, sp.n_mels, n_bins)
                   + (0 if sp.log_mel else _mm(f0, sp.n_mfcc, sp.n_mels)))

    if cfg.model_kind == "mfcc_inverter":
        out["encoder"] = out["bottleneck"] = out["aux_frame"] = 0
        t_up, cin = spec.n_frames, sp.n_out_channels
    else:
        out["encoder"], tz = _encoder(cfg, spec.n_frames)
        # the VQ distance matrix is the bottleneck's only GEMM
        out["bottleneck"] = _mm(tz, bn.vq_k, bn.n_dim) if bn.kind == "vq" else 0
        out["aux_frame"] = (_mm(tz, 3 * sp.n_mfcc, bn.n_dim)
                            if ae_mod.aux_frame_active(cfg) else 0)
        t_up, cin = tz, wn.n_lc_in

    # transposed convs: each input position feeds `filter` taps; t is the
    # previous layer's length after its plan trim
    u = 0
    for i, f in enumerate(wn.lc_upsample_filters):
        u += _mm(t_up, wn.n_lc_out, cin, f)
        cin = wn.n_lc_out
        t_up = spec.up_steps[i].keep
    out["upsample"] = u

    # dilated gated stack: per layer the two taps and the cond projection
    # and the residual over the layer's VALID output, the skip over n_win
    n_cond = wn.n_lc_out + wn.n_global_embed
    t_out = spec.n_win
    d = 0
    t_l = spec.t_in
    for dil in wn.dilations:
        t_l -= dil * (wn.filter_sz - 1)
        d += 2 * _mm(t_l, 2 * wn.n_dil, wn.n_res)      # w_prev + w_cur
        d += _mm(t_l, 2 * wn.n_dil, n_cond)            # w_cond
        d += _mm(t_l, wn.n_res, wn.n_dil)              # w_res
        d += _mm(t_out, wn.n_skp, wn.n_dil)            # w_skip
    d += _mm(t_out, wn.n_post, wn.n_skp)               # post1
    d += _mm(t_out, wn.n_out, wn.n_post)               # post2
    out["decoder"] = d

    out["total"] = sum(out.values())
    return out


def train_step_flops_per_item(cfg: RunConfig, spec: WindowSpec) -> int:
    """Forward + backward matmul FLOPs per batch item (3x the forward)."""
    return 3 * forward_flops(cfg, spec)["total"]


def train_step_flops_per_sample(cfg: RunConfig, spec: WindowSpec) -> float:
    """Training FLOPs per loss sample."""
    return train_step_flops_per_item(cfg, spec) / spec.n_win

