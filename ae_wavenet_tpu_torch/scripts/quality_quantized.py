"""Generation quality of the quantized samplers: is ``--int8`` / ``--int4``
safe for this checkpoint?

    python -m ae_wavenet_tpu_torch.scripts.quality_quantized --ckpt-dir DIR \\
        --data PREFIX [--step best] [--clips 0,5,10,15] [--n-samples 16000] \\
        [--modes bf16,int8,int4] [--json out.jsonl] [--device cuda]

Counterpart of the JAX package's ``scripts/quality_quantized.py``:
reconstructs held-out clips through the fused sampler at each weight
precision (on the card the bf16, int8 and int4 kernels of
``csrc/fastgen.cu``; with ``--device cpu`` their plain versions) and
reports the log-mel spectral distance to the source beside the source's
distance to silence.  One JSON line for the run, one per (clip, mode) and
a summary with the mean distance per mode.
"""

from __future__ import annotations

import argparse
import json

from ae_wavenet_tpu_torch.scripts import _common

#: --modes name -> the sampler's ``quantized`` argument
MODES = {"bf16": False, "int8": "int8", "int4": "int4"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--step", default=None,
                   help="checkpoint step (default LATEST; 'best' reads the "
                        "retention BEST sidecar)")
    p.add_argument("--data", required=True)
    p.add_argument("--clips", default="0,5,10,15")
    p.add_argument("--n-samples", type=int, default=16000)
    p.add_argument("--max-input", type=int, default=64000)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--modes", default="bf16,int8,int4")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when there is no card")
    a = p.parse_args(argv)

    import numpy as np
    import torch

    from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float, mu_decode
    from ae_wavenet_tpu_torch.data.dataset import PackedDataset
    from ae_wavenet_tpu_torch.eval.quality import log_mel_distance
    from ae_wavenet_tpu_torch.models import registry
    from ae_wavenet_tpu_torch.training import checkpoint

    modes = [m for m in a.modes.split(",") if m]
    if not modes or set(modes) - set(MODES):
        raise SystemExit(f"--modes {a.modes!r}: choose from {sorted(MODES)}")
    device = _common.setup(a.device)
    step, _ = _common.pick_step(a.ckpt_dir, a.step)
    step, model, cfg = checkpoint.load_model(a.ckpt_dir, step)
    model = model.to(device).eval()
    family = registry.get(cfg.model_kind)

    ds = PackedDataset(a.data)
    clips = [int(c) for c in a.clips.split(",")]
    out_f = open(a.json, "a") if a.json else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()

    try:
        emit({"quality_quantized": {"ckpt": a.ckpt_dir, "step": int(step),
                                    "clips": clips, "n_samples": a.n_samples,
                                    "temperature": a.temperature}})
        means: dict[str, list[float]] = {}
        silence_ref = []
        for clip in clips:
            wav = torch.from_numpy(ds.clip(clip, a.max_input))[None].to(device)
            spk = torch.from_numpy(ds.speakers[clip : clip + 1].astype(np.int64)).to(device)
            for name in modes:
                ids, start = family.reconstruct(
                    model, cfg, wav, spk, torch.Generator().manual_seed(a.seed),
                    temperature=a.temperature, n_samples=a.n_samples,
                    quantized=MODES[name])
                n = ids.shape[-1]
                recon = mu_decode(ids, cfg.wavenet.n_quant)
                src = int16_to_float(wav)[..., start : start + n]
                d = log_mel_distance(recon, src, cfg.spec)
                sil = log_mel_distance(torch.zeros_like(src), src, cfg.spec)
                emit({"clip": clip, "mode": name, "spectral_l2": round(d, 4),
                      "spectral_l2_vs_silence": round(sil, 4), "n_scored": int(n)})
                means.setdefault(name, []).append(d)
            silence_ref.append(sil)
        emit({"summary": {
            "mean_spectral_l2": {k: round(float(np.mean(v)), 4)
                                 for k, v in means.items()},
            "mean_spectral_l2_vs_silence": round(float(np.mean(silence_ref)), 4),
        }})
    finally:
        if out_f:
            out_f.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
