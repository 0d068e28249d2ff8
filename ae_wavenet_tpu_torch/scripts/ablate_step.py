"""Step-time composition of the flagship train step.

Counterpart of the JAX package's ``scripts/ablate_step.py``.  Times, at
the bench config (B = 8 x n_win 24,000, VQ, bf16, the hand-written gated
stack unless ``--no-pallas``, then the plain PyTorch stack): the
conditioning path (frontend, encoder, bottleneck, upsampler), the decoder
alone and the full loss, each forward only (under ``torch.no_grad``) and
forward + backward (the gradients of every parameter, reduced to one
number as the reference reduces them), so the next optimisation target is
measured, not guessed.  The bottleneck runs in training mode, so its VQ
statistics are updated in place on every call (the reference's pure apply
computes and drops them): every call does the same work.  Timing: the host
clock between two synchronisations of the device, 2 warm-up calls, then
``--iters``.

    python -m ae_wavenet_tpu_torch.scripts.ablate_step [--iters 10] [--no-pallas] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ae_wavenet_tpu_torch.scripts import _common


def run_config(a):
    """The bench config: VQ at ``--batch`` x ``--n-win``, the fused stack
    unless ``--no-pallas``."""
    from ae_wavenet_tpu_torch.utils.config import (BottleneckConfig, RunConfig,
                                                   TrainConfig, WaveNetConfig)

    return RunConfig(bottleneck=BottleneckConfig(kind="vq"),
                     wavenet=WaveNetConfig(use_pallas_stack=not a.no_pallas),
                     train=TrainConfig(batch_sz=a.batch, n_win=a.n_win))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-win", type=int, default=24000)
    ap.add_argument("--no-pallas", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    from ae_wavenet_tpu_torch.audio import mfcc as mfcc_mod
    from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float, mu_encode
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.models import wavenet
    from ae_wavenet_tpu_torch.models.common import normalize_frames

    device = _common.setup(a.device)
    cfg = run_config(a)
    spec = ae.make_window_spec(cfg)
    rng = np.random.default_rng(0)
    wav = torch.as_tensor(rng.integers(-20000, 20000, (a.batch, spec.u_len)),
                          dtype=torch.int16, device=device)
    spk = torch.as_tensor(rng.integers(0, cfg.wavenet.n_speakers, (a.batch,)),
                          device=device)
    model = ae.init(cfg, torch.Generator().manual_seed(0), device)
    params = [p for p in model.parameters() if p.requires_grad]
    gen = torch.Generator(device=device).manual_seed(1)
    bf16 = torch.bfloat16

    def cond_path(w):
        wavf = int16_to_float(w)
        frames = mfcc_mod.mfcc_delta_stack(wavf[..., spec.fb : spec.fe], cfg.spec)
        frames = normalize_frames(frames, spec=cfg.spec)
        z = model.encoder(frames, dtype=bf16)
        zq, _ = model.bottleneck.train_apply(z, 0, True, gen)
        return wavenet.upsample_apply(model.wavenet, cfg.wavenet, zq, spec.up_steps,
                                      dtype=bf16)

    with torch.no_grad():
        cond_const = cond_path(wav)
    x_ids = mu_encode(int16_to_float(wav), cfg.wavenet.n_quant)[
        ..., spec.w0 : spec.w0 + spec.t_in]

    def dec_only():
        return wavenet.apply(model.wavenet, cfg.wavenet, x_ids, cond_const, spk,
                             dtype=bf16)

    def loss():
        return ae.loss_fn(model, cfg, spec, wav, spk, 0, True, gen)[0]

    def fwd(f):
        def run():
            with torch.no_grad():
                return f().float().mean()
        return run

    def fwd_bwd(f):
        def run():
            grads = torch.autograd.grad(f().float().mean(), params, allow_unused=True)
            return sum(g.float().square().sum() for g in grads if g is not None)
        return run

    def ms(fn) -> float:
        return _common.timed(fn, a.iters, device, warmup=2) * 1e3

    print(f"pallas_stack={not a.no_pallas} b{a.batch} x {a.n_win}")
    print(f"cond fwd ms:      {ms(fwd(lambda: cond_path(wav))):.1f}")
    print(f"cond fwd+bwd ms:  {ms(fwd_bwd(lambda: cond_path(wav))):.1f}")
    print(f"dec fwd ms:       {ms(fwd(dec_only)):.1f}")
    print(f"dec fwd+bwd ms:   {ms(fwd_bwd(dec_only)):.1f}")
    print(f"loss fwd ms:      {ms(fwd(loss)):.1f}")
    print(f"loss fwd+bwd ms:  {ms(fwd_bwd(loss)):.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
