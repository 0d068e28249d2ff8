"""CLI: reconstruction (the autoencoder) or vocoding (the MFCC inverter)
from a checkpoint on the GPU (fast-queue path).

    python -m ae_wavenet_tpu_torch.cli.generate --ckpt MODEL.pt --data PREFIX \
        [--clip I] [--n-samples N] [--temperature T] [--int8 | --int4] \
        [--device cuda] --out out.wav

``--ckpt`` is an export file: ``training/weights.save_export`` writes one,
and ``ae_wavenet_tpu.training.torch_compat.export_torch`` converts a JAX
checkpoint to one.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from ae_wavenet_tpu_torch.utils.precision import set_reference_precision

    set_reference_precision()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True, help="export-format .pt file")
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
                        "activations); takes precedence over --int8")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when there is no card")
    p.add_argument("--out", required=True, help="output .wav path")
    a = p.parse_args(argv)

    import numpy as np
    import torch

    from ae_wavenet_tpu_torch.audio.mulaw import mu_decode
    from ae_wavenet_tpu_torch.data.dataset import PackedDataset
    from ae_wavenet_tpu_torch.models import registry
    from ae_wavenet_tpu_torch.training.weights import load_export
    from ae_wavenet_tpu_torch.utils.wavio import write_wav

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

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
