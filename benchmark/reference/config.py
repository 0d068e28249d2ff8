"""Run configuration: the port's ``utils/config.py`` schema (the same
fields, defaults and JSON format) and its JSON reader, frozen here for the
reference; the presets and the writer are left out.  The kernel knobs stay
in the schema so that a configuration file reads as it is; nothing here
acts on them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

from benchmark.reference.vconv import Chain, Conv


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    sample_rate: int = 16000
    win_sz: int = 400          # 25 ms
    hop_sz: int = 160          # 10 ms
    n_fft: int = 512
    n_mels: int = 40
    n_mfcc: int = 13
    delta_wing: int = 2        # delta window = 2*wing + 1 frames
    mel_fmin: float = 0.0
    mel_fmax: float | None = None  # default sample_rate / 2
    # frame normalization: "window" = per-training-window statistics (the
    # reference behavior; generation approximates them with a centered
    # slice), "dataset" = fixed per-channel statistics computed over the
    # whole dataset at Chassis init and persisted in the checkpointed
    # config — train and generation then normalize IDENTICALLY.
    norm: str = "window"
    stats_mean: Tuple[float, ...] = ()   # per-channel, len 3*n_mfcc
    stats_var: Tuple[float, ...] = ()

    @property
    def n_out_channels(self) -> int:
        return 3 * self.n_mfcc  # mfcc + delta + delta-delta

    def geometry(self) -> Chain:
        """wav -> aligned 39-ch frame lattice (valid frames only)."""
        dw = 2 * self.delta_wing + 1
        return Chain(
            [
                Conv(self.win_sz, stride=self.hop_sz, name="stft_frame"),
                Conv(dw, name="delta"),
                Conv(dw, name="delta2"),
            ]
        )


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Chorowski-style MFCC encoder (reference ``encoder.py`` [M])."""

    n_in: int = 39            # 13 MFCC + deltas + delta-deltas
    n_ch: int = 768
    n_pre_res: int = 1        # residual pairs of k=3 convs before downsample
    down_filter: int = 4
    down_stride: int = 2      # 100 Hz frames -> 50 Hz latents
    n_post_res: int = 2       # residual pairs after downsample
    n_out: int = 64           # bottleneck dimensionality


@dataclasses.dataclass(frozen=True)
class BottleneckConfig:
    """Pluggable bottleneck: plain AE / VAE / VQ-VAE-EMA (reference
    bottleneck modules [SURVEY.md §2.1])."""

    kind: str = "ae"          # 'ae' | 'vae' | 'vq' | 'zero'
                              # 'zero' disables conditioning (zq = 0): the
                              # decoder-only ablation baseline that measures
                              # how much the bottleneck actually buys
    n_dim: int = 64
    # --- vq ---
    vq_k: int = 512           # codebook size
    vq_groups: int = 1        # grouped (product) VQ: G independent codebooks
                              # over D/G-dim sub-vectors.  Raises the
                              # bottleneck's information ceiling to
                              # G * ln(vq_k) nats per latent frame
                              # (SoundStream/EnCodec-style capacity) — the
                              # flagship single-group ceiling, 50 Hz *
                              # ln(512) / 16 kHz = 0.0195 nats/sample, is
                              # below measurement noise for the
                              # conditioning-gain experiment
    vq_beta: float = 0.25     # commitment loss weight
    ema_decay: float = 0.99
    ema_eps: float = 1e-5     # Laplace smoothing of EMA counts
    jitter_p: float = 0.12    # temporal jitter regularizer (train only)
    vq_use_pallas: bool = False  # fused device kernel (ops/vq_pallas.py);
                                 # off by default: measured at parity with the
                                 # XLA path at flagship shapes (BASELINE.md
                                 # "Fused VQ kernel head-to-head")
    vq_restart_thresh: float = 0.2  # EMA-count floor below which a dead code
                                    # is re-seeded from a random batch vector
                                    # (0 disables dead-code restarts)
    vq_warmup_steps: int = 0  # linear commitment-weight ramp 0 -> vq_beta
                              # over this many steps (0 = constant vq_beta).
                              # Measured (scripts/diag_vq.py, 2026-08-17):
                              # does NOT prevent the early usage collapse —
                              # the collapse cause is the recon gradient
                              # suppressing a not-yet-informative cond path
                              # through the STE, not commitment pressure —
                              # and on the tiny config the ramp *delays*
                              # codebook usage (ppl 2.5 vs 22 at step 300),
                              # so it stays off by default
    # --- vae ---
    free_nats: float = 0.0    # per-dim KL floor (free bits)
    kl_anneal_steps: int = 0  # linear KL-weight ramp; 0 = constant 1.0

    def __post_init__(self):
        if self.vq_groups < 1 or self.n_dim % self.vq_groups:
            raise ValueError(
                f"vq_groups={self.vq_groups} must be >= 1 and divide "
                f"n_dim={self.n_dim}")
        if self.vq_groups > 1 and self.vq_use_pallas:
            raise ValueError(
                "vq_use_pallas supports vq_groups=1 only (the fused kernel "
                "is single-codebook; the XLA path is the shipped default)")


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    """Autoregressive WaveNet decoder (reference ``wavenet.py`` [H])."""

    n_blocks: int = 2
    n_block_layers: int = 10  # dilations 1,2,...,2^(n-1) per block
    filter_sz: int = 2
    n_res: int = 384
    n_dil: int = 256
    n_skp: int = 256
    n_post: int = 256
    n_quant: int = 256        # mu-law classes
    n_lc_in: int = 64         # local conditioning input channels
    n_lc_out: int = 128       # channels inside the upsampling stack
    # transposed-conv upsampling 50 Hz -> 16 kHz; product of strides must be
    # hop_sz * down_stride; filters default to 2*stride
    lc_upsample_strides: Tuple[int, ...] = (5, 4, 4, 4)
    lc_upsample_filters: Tuple[int, ...] = (10, 8, 8, 8)
    n_speakers: int = 40
    n_global_embed: int = 32
    use_pallas_stack: bool = False  # fused Pallas gated-conv stack for the
                                    # training forward+backward (TPU only;
                                    # ops/gated_pallas.py). Measured 1.79x
                                    # the XLA forward on v5e — BASELINE.md
    # --- fused-stack kernel knobs (numerics/schedule-affecting; config
    # fields so a checkpoint's embedded config fully determines the
    # computation — formerly GATED_* / FASTGEN_* env vars) ---
    gated_tile: int = 1024        # forward time-tile (frames per grid step)
    gated_bwd_tile: int = 0       # backward tile; 0 = same as gated_tile,
                                  # otherwise must divide gated_tile
    gated_save_y: bool = True     # save gate pre-activations in fwd so bwd
                                  # skips the xin@w_in recompute GEMM
    gated_fuse_pairs: bool = True  # fuse consecutive layer pairs into one
                                   # kernel (persistent VMEM mid-stream)
    gated_bwd_group: int = 0      # >=3: grouped backward — that many
                                  # consecutive layers per bwd kernel with
                                  # the cotangent streams VMEM-resident
                                  # across the group (0/2 = pair schedule)
    gated_full_fusion: bool = False  # whole-stack single-kernel forward
                                     # (all inter-layer streams in VMEM,
                                     # skip accumulated once); overrides
                                     # pair fusion for the FORWARD only —
                                     # the backward keeps the pair/single
                                     # schedule
    fastgen_vmem_dil_max: int = 16  # AR sampler: ring buffers with dilation
                                    # <= this stay VMEM-resident

    def __post_init__(self):
        # validated at construction so a bad --gated-bwd-tile raises here
        # instead of silently disqualifying the fused stack in
        # ops/gated_pallas.supports_pallas_stack (round-3 advisor finding)
        if self.gated_bwd_tile and self.gated_tile % self.gated_bwd_tile:
            raise ValueError(
                f"gated_bwd_tile={self.gated_bwd_tile} must divide "
                f"gated_tile={self.gated_tile}"
            )

    @property
    def dilations(self) -> Tuple[int, ...]:
        return tuple(
            2**i for _ in range(self.n_blocks) for i in range(self.n_block_layers)
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_sz: int = 16
    n_win: int = 1600         # loss samples per window (like reference n_win)
    learning_rate: float = 4e-4
    lr_boundaries: Tuple[int, ...] = ()   # steps at which LR changes
    lr_values: Tuple[float, ...] = ()     # len = len(boundaries) + 1 (if set)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0    # 0 = off
    aux_frame_weight: float = 0.0  # weight of the latent->MFCC-frame linear
                                   # prediction loss (0 = off).  Keeps
                                   # information pressure on the bottleneck
                                   # while the decoder is still learning to
                                   # consume conditioning — the measured
                                   # antidote to early VQ usage collapse
                                   # (scripts/diag_vq.py, docs/STATUS.md)
    seed: int = 0
    n_steps: int = 100000
    ckpt_every: int = 1000
    ckpt_keep: int = 0        # retention: >0 keeps only the newest N
                              # checkpoints PLUS the best-holdout one (BEST
                              # sidecar) and the LATEST-pointed step; 0
                              # keeps everything.  At flagship state size
                              # (319 MB) keep-all writes ~64 GB per 100k
                              # steps at ckpt_every=500
    log_every: int = 50
    holdout_every: int = 0    # >0: every k-th clip is held out of training
                              # and used by Chassis.evaluate()
    steps_per_call: int = 1   # K>1: ONE jitted program advances K steps
                              # (lax.scan over a K-deep staged batch block),
                              # amortizing per-step host dispatch — the
                              # compute-vs-e2e gap on slow hosts.  n_steps
                              # must be a multiple of K.
    compute_dtype: str = "bfloat16"  # matmul/conv dtype; params stay f32
    dp_impl: str = "auto"     # data-parallel step implementation:
                              # "auto" = pjit sharding annotations (XLA
                              # inserts the allreduce); "shard_map" =
                              # explicit per-shard program with
                              # psum/pmean — REQUIRED for the fused Pallas
                              # stack, which does not auto-partition
                              # (forced automatically in that case); the
                              # port reads neither: its one DP program is
                              # the shard_map one (parallel/mesh.py)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    spec: SpecConfig = SpecConfig()
    encoder: EncoderConfig = EncoderConfig()
    bottleneck: BottleneckConfig = BottleneckConfig()
    wavenet: WaveNetConfig = WaveNetConfig()
    train: TrainConfig = TrainConfig()
    model_kind: str = "autoencoder"  # 'autoencoder' | 'mfcc_inverter'


def _build(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def from_json(s: str) -> RunConfig:
    d = json.loads(s)
    return RunConfig(
        spec=_build(SpecConfig, d["spec"]),
        encoder=_build(EncoderConfig, d["encoder"]),
        bottleneck=_build(BottleneckConfig, d["bottleneck"]),
        wavenet=_build(WaveNetConfig, d["wavenet"]),
        train=_build(TrainConfig, d["train"]),
        model_kind=d.get("model_kind", "autoencoder"),
    )
