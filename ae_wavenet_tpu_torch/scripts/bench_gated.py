"""Head-to-head: the hand-written gated stack against the plain PyTorch
formulation, at the flagship decoder shapes.

Counterpart of the JAX package's ``scripts/bench_gated.py``, its two arms
mapped onto the port:

* "xla" is the plain formulation: ``models/wavenet.apply`` in bf16 with
  ``use_pallas_stack=False``;
* "pallas" is the hand-written kernels: ``ops/gated.stack_apply`` on layer
  pairs (K1, ``csrc/gated.cu`` ``wg_fwd_kernel<2>``) and with
  ``full_fusion=True`` (K7, ``wg_stack_kernel``).

It measures (1) each kernel path's max abs difference from the plain
forward, (2) the forward latency of all three (the host clock between two
synchronisations of the device).  ``--tile`` sets ``cfg.gated_tile``,
which the Hopper kernels do not read (they choose their own tiles), so it
only labels ``config``.  ``full_fusion_applied`` is True when
``ops/gated.check_schedule`` takes the whole-stack schedule; where it does
not apply, the script raises (the reference fell back to pairs).

    python -m ae_wavenet_tpu_torch.scripts.bench_gated [--tile 1024] [--iters 20] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ae_wavenet_tpu_torch.scripts import _common


def decoder_config(a):
    """The flagship decoder (``RunConfig``'s) at ``--tile``."""
    from ae_wavenet_tpu_torch.utils.config import RunConfig, TrainConfig

    cfg = RunConfig(train=TrainConfig(batch_sz=a.batch, n_win=a.n_win)).wavenet
    return dataclasses.replace(cfg, gated_tile=a.tile)


def forwards(wn, cfg, x_ids, cond, spk) -> tuple:
    """The three forwards, each a call -> logits [B, n_quant, T_out]: the
    plain bf16 formulation, the kernels on layer pairs (K1), the
    whole-stack kernel (K7)."""
    from ae_wavenet_tpu_torch.models import wavenet
    from ae_wavenet_tpu_torch.ops import gated

    def plain():
        return wavenet.apply(wn, cfg, x_ids, cond, spk, dtype=torch.bfloat16)

    def pairs():
        return gated.stack_apply(wn, cfg, x_ids, cond, spk)

    def full():
        return gated.stack_apply(wn, cfg, x_ids, cond, spk, full_fusion=True)

    return plain, pairs, full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tile", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-win", type=int, default=24000)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when there is no card")
    a = ap.parse_args(argv)

    from ae_wavenet_tpu_torch.models import wavenet
    from ae_wavenet_tpu_torch.ops import gated

    device = _common.setup(a.device)
    cfg = decoder_config(a)
    rf = wavenet.receptive_field(cfg)
    t_in = a.n_win + rf
    print(f"flagship decoder: B={a.batch} t_in={t_in} rf={rf} "
          f"layers={len(cfg.dilations)}", file=sys.stderr)

    gen = torch.Generator().manual_seed(0)
    wn = wavenet.WaveNet(cfg, gen).to(device)
    x_ids = torch.randint(0, cfg.n_quant, (a.batch, t_in), generator=gen).to(device)
    cond = (torch.randn(a.batch, cfg.n_lc_out, t_in, generator=gen) * 0.5).to(
        device, torch.bfloat16)
    spk = torch.randint(0, cfg.n_speakers, (a.batch,), generator=gen).to(device)
    gated.check_schedule(cfg, full_fusion=True)
    plain_fwd, pairs_fwd, full_fwd = forwards(wn, cfg, x_ids, cond, spk)

    with torch.no_grad():
        ref = plain_fwd().float()
        d = (ref - pairs_fwd().float()).abs()
        print(f"correctness: max abs diff {float(d.max()):.5f} mean "
              f"{float(d.mean()):.6f}", file=sys.stderr)
        df = (ref - full_fwd().float()).abs()
        print(f"full-fusion correctness: max abs diff {float(df.max()):.5f}",
              file=sys.stderr)
        del ref
        t_xla = _common.timed(plain_fwd, a.iters, device)
        t_pal = _common.timed(pairs_fwd, a.iters, device)
        t_full = _common.timed(full_fwd, a.iters, device)
    samples = a.batch * a.n_win
    print(json.dumps({
        "config": f"b{a.batch} x {a.n_win}, tile {a.tile}",
        "full_fusion_applied": True,
        "xla_fwd_ms": round(t_xla * 1e3, 2),
        "pallas_fwd_ms": round(t_pal * 1e3, 2),
        "full_fusion_fwd_ms": round(t_full * 1e3, 2),
        "xla_fwd_samples_per_sec": round(samples / t_xla),
        "pallas_fwd_samples_per_sec": round(samples / t_pal),
        "full_fusion_fwd_samples_per_sec": round(samples / t_full),
        "speedup": round(t_xla / t_pal, 3),
        "full_fusion_speedup_vs_pairs": round(t_pal / t_full, 3),
        "max_abs_diff": float(d.max()),
        "full_fusion_max_abs_diff": float(df.max()),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
