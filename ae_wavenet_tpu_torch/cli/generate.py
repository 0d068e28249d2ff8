"""CLI: reconstruction (the autoencoder) or vocoding (the MFCC inverter,
WaveGlow) from a checkpoint on the GPU (fast-queue path).  A mu-law
model's ids are decoded to the wav; a mixture-of-logistics vocoder's
16-bit samples, and WaveGlow's (all of the clip's mel frames in one pass
of the flows, at the configuration's rate: 22,050 Hz for
``waveglow_22k``; ``--temperature`` scales its sigma), are written as
linear PCM.

    python -m ae_wavenet_tpu_torch.cli.generate (--ckpt-dir DIR [--step N] | \
        --ckpt MODEL.pt) --data PREFIX [--clip I] [--n-samples N] \
        [--temperature T] [--int8 | --int4] [--device cuda] --out out.wav

``--ckpt-dir`` is a training run's checkpoint directory: the step
``LATEST`` names, or ``--step``.  ``--ckpt`` is one export file:
``training/weights.save_export`` writes one, the train CLI writes one per
saved step (``DIR/step_XXXXXXXX.pt``), and
``ae_wavenet_tpu.training.torch_compat.export_torch`` converts a JAX
checkpoint to one.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from ae_wavenet_tpu_torch.utils.precision import set_reference_precision

    set_reference_precision()
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt-dir", help="checkpoint directory (LATEST, or --step)")
    src.add_argument("--ckpt", help="export-format .pt file")
    p.add_argument("--step", type=int, default=None,
                   help="with --ckpt-dir: the checkpoint step (default LATEST)")
    p.add_argument("--data", required=True, help="packed dataset prefix")
    p.add_argument("--clip", type=int, default=0, help="clip index to reconstruct")
    p.add_argument("--n-samples", type=int, default=16000)
    p.add_argument("--max-input", type=int, default=64000,
                   help="cap on input samples fed to the encoder")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="sampling temperature (0 = greedy)")
    p.add_argument("--int8", action="store_true",
                   help="sample with int8 layer weights and int8 activations")
    p.add_argument("--int4", action="store_true",
                   help="sample with nibble-packed int4 layer weights (int8 "
                        "activations); takes precedence over --int8.  Check "
                        "a checkpoint's bf16, int8 and int4 reconstructions "
                        "with python -m "
                        "ae_wavenet_tpu_torch.scripts.quality_quantized")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when there is no card")
    p.add_argument("--out", required=True, help="output .wav path")
    a = p.parse_args(argv)
    if a.step is not None and a.ckpt_dir is None:
        p.error("--step needs --ckpt-dir")

    import numpy as np
    import torch

    from ae_wavenet_tpu_torch.audio.mulaw import mu_decode
    from ae_wavenet_tpu_torch.data.dataset import PackedDataset
    from ae_wavenet_tpu_torch.models import registry
    from ae_wavenet_tpu_torch.training import checkpoint
    from ae_wavenet_tpu_torch.training.weights import load_export
    from ae_wavenet_tpu_torch.utils.wavio import write_wav

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    if a.ckpt_dir is not None:
        step, model, cfg = checkpoint.load_model(a.ckpt_dir, a.step)
    else:
        step, model, cfg = load_export(a.ckpt)
    model = model.to(device).eval()
    print(f"loaded step {step} ({cfg.model_kind}, bottleneck={cfg.bottleneck.kind})")

    ds = PackedDataset(a.data)
    wav = torch.from_numpy(ds.clip(a.clip, a.max_input))[None]
    spk = torch.from_numpy(ds.speakers[a.clip : a.clip + 1].astype(np.int64))
    print(f"clip {a.clip}: {wav.shape[-1]} samples, speaker {int(spk[0])}")

    timings: dict = {}
    # both model families have the same reconstruct()
    ids, start = registry.get(cfg.model_kind).reconstruct(
        model, cfg, wav.to(device), spk.to(device),
        torch.Generator().manual_seed(a.seed), temperature=a.temperature,
        n_samples=a.n_samples, timings=timings,
        quantized="int4" if a.int4 else a.int8)
    if cfg.wavenet.n_mix or cfg.model_kind == "waveglow":  # 16-bit samples as they are
        out = ids[0].cpu().numpy()
    else:
        out = mu_decode(ids, cfg.wavenet.n_quant)[0].cpu().numpy()
    write_wav(a.out, out, cfg.spec.sample_rate)
    gen_s = timings["generate"]
    print(f"encode {timings['encode']:.3f} s, prime {timings['prime']:.3f} s, "
          f"generate {gen_s:.3f} s ({len(out) / gen_s:.1f} samples/s) on {device}")
    print(f"wrote {a.out}: {len(out)} samples "
          f"(reconstructs input positions [{start}, {start + len(out)}))")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
