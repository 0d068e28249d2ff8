"""What the instruments share: the device, the reference's synthetic
fixture, the flagship config, the checkpoint step to read, and the timing
of the measuring scripts."""

from __future__ import annotations

import os
import tempfile
import time

import torch

from ae_wavenet_tpu_torch.data.preprocess import (make_synthetic_dataset,
                                                  synthetic_fixture_current)
from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod
from ae_wavenet_tpu_torch.utils import device as device_mod
from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, EncoderConfig,
                                               RunConfig, TrainConfig,
                                               WaveNetConfig)
from ae_wavenet_tpu_torch.utils.precision import set_reference_precision

#: clip lengths of the flagship fixtures (the JAX scripts' 7.5-15 s clips)
FLAGSHIP_CLIP_LEN = (120_000, 240_000)


def workdir(name: str) -> str:
    """The default work directory of an instrument, under the temp dir."""
    return os.path.join(tempfile.gettempdir(), name)


def setup(device: str) -> torch.device:
    """The entry point's device (no card raises), with the reference's f32
    numerics (TF32 off)."""
    set_reference_precision()
    return device_mod.resolve(device)


def sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU): where the JAX scripts block on a result."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, iters: int, device, warmup: int = 1) -> float:
    """Seconds per ``fn()`` call: ``warmup`` calls, then ``iters`` calls on
    the host clock between two synchronisations of ``device``."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters


def platform(device) -> str:
    """The device's platform as JAX names it (``gpu`` for a CUDA card)."""
    kind = torch.device(device).type
    return "gpu" if kind == "cuda" else kind


def fixture(prefix: str, style: str = "v2", n_clips: int = 32,
            n_speakers: int = 8, clip_len=FLAGSHIP_CLIP_LEN) -> str:
    """The reference's synthetic fixture at ``prefix`` (seed 11), written
    unless a current one of ``style`` is there.  Byte for byte the JAX
    package's (``data/preprocess.make_synthetic_dataset``)."""
    if not synthetic_fixture_current(prefix, style):
        make_synthetic_dataset(prefix, n_clips=n_clips, n_speakers=n_speakers,
                               clip_len=clip_len, seed=11, style=style)
    return prefix


def flagship_config(bottleneck: BottleneckConfig, train: TrainConfig,
                    latent_hz: int = 50) -> RunConfig:
    """The flagship dims with the fused stack; ``latent_hz=100`` removes
    the encoder's stride 2 (100 Hz latents), so the upsampler covers a hop
    of 160 samples, not 320."""
    enc, wn_kw = EncoderConfig(), dict(use_pallas_stack=True)
    if latent_hz == 100:
        enc = EncoderConfig(down_stride=1)
        wn_kw.update(lc_upsample_strides=(5, 4, 4, 2),
                     lc_upsample_filters=(10, 8, 8, 4))
    return RunConfig(encoder=enc, bottleneck=bottleneck,
                     wavenet=WaveNetConfig(**wn_kw), train=train)


def pick_step(ckpt_dir: str, step: str | None):
    """``--step`` (None for LATEST, a number, or ``best``) -> (step or
    None, the BEST sidecar's (step, metric) when ``best`` was asked)."""
    if step != "best":
        return (None if step is None else int(step)), None
    info = ckpt_mod.best_info(ckpt_dir)
    if info is None:
        raise SystemExit(f"no BEST sidecar under {ckpt_dir} (only "
                         f"retention-enabled runs write one)")
    return info[0], info
