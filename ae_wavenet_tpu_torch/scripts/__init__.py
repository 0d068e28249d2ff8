"""The repository's instruments, on the card: counterparts of the JAX
package's ``scripts/`` under the same file names and flags.

    python -m ae_wavenet_tpu_torch.scripts.long_run --steps 2000
    python -m ae_wavenet_tpu_torch.scripts.eval_quality --ckpt-dir DIR --data PREFIX
    python -m ae_wavenet_tpu_torch.scripts.quality_quantized --ckpt-dir DIR --data PREFIX
    python -m ae_wavenet_tpu_torch.scripts.diag_vq --steps 300
    python -m ae_wavenet_tpu_torch.scripts.diag_vae --steps 300 --preset tiny
    python -m ae_wavenet_tpu_torch.scripts.gain_ab --bottlenecks zero,ae,vq
    python -m ae_wavenet_tpu_torch.scripts.compare_runs LABEL=run.jsonl ...
    python -m ae_wavenet_tpu_torch.scripts.gain_scaling LABEL=zero,g1,g4 ...

and the measuring scripts, each layer's reader:

    python -m ae_wavenet_tpu_torch.scripts.bench_gated [--iters 20]
    python -m ae_wavenet_tpu_torch.scripts.bench_vq
    GEN_BATCH=128 python -m ae_wavenet_tpu_torch.scripts.bench_gen
    python -m ae_wavenet_tpu_torch.scripts.bench_mfcc
    python -m ae_wavenet_tpu_torch.scripts.bench_ckpt [--flagship]
    python -m ae_wavenet_tpu_torch.scripts.bench_chassis [--steps 30]
    python -m ae_wavenet_tpu_torch.scripts.probe_dispatch
    python -m ae_wavenet_tpu_torch.scripts.ablate_step [--no-pallas]
    python -m ae_wavenet_tpu_torch.scripts.convergence_ab [--steps 40]
    python -m ae_wavenet_tpu_torch.scripts.train_curves [--out PATH]

Every entry point that computes takes ``--device`` (default ``cuda``; no
card raises) and writes the JAX script's JSON records, key for key.  In
the measuring scripts the JAX scripts' "xla" arm is the plain PyTorch
formulation and "pallas" the hand-written kernel.
"""
