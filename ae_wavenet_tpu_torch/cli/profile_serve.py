"""Device idle share of each serving phase on the GPU.

    python -m ae_wavenet_tpu_torch.cli.profile_serve [--batch 1 64] \
        [--steps 256] [--json PATH]

Seeded random weights at the full width of the ``chorowski`` preset.  For
each batch size, each phase runs once to warm up and once under
``torch.profiler``: encode of one second of audio, prime over ``--steps``
context ids, and the fused sampler over ``--steps`` samples.  Per phase it
prints the host wall seconds, the device busy seconds (the union of the
device-side intervals the profiler records), their count, and the idle
share 1 - busy / wall.  The profiler's own host cost inflates wall time,
so the idle shares are upper bounds.
"""

from __future__ import annotations

import argparse
import json
import time


def busy_seconds(prof) -> tuple[float, int]:
    """Union of the device-side event intervals, and their number."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for b, e in spans:
        if e > end:
            busy += e - max(b, end)
            end = e
    return busy * 1e-6, len(spans)


def profile(fn) -> dict:
    """Wall, device busy and idle share of one call of fn (after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n = busy_seconds(prof)
    if n == 0:
        raise RuntimeError("the profiler recorded no device activity")
    return {"wall_s": wall, "device_busy_s": busy, "device_events": n,
            "idle_share": 1.0 - busy / wall}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, nargs="+", default=[1, 64])
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--json", help="also write the results to this file")
    a = p.parse_args(argv)

    import torch

    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.ops import fastgen as fg
    from ae_wavenet_tpu_torch.ops import fastgen_cuda as fc
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    dev = torch.device("cuda")
    cfg = chorowski_config()
    wcfg = cfg.wavenet
    gen = torch.Generator().manual_seed(0)
    model = ae.init(cfg, gen, dev).eval()
    packed = fc.pack_for_kernel(model.wavenet, wcfg)
    n_cond = wcfg.n_lc_out + wcfg.n_global_embed
    rows = []
    for b in a.batch:
        wav = (torch.randn(b, cfg.spec.sample_rate, generator=gen) * 3000).to(
            dev, torch.int16)
        ids = torch.randint(0, wcfg.n_quant, (b, a.steps + 1), generator=gen).to(dev)
        cond = (torch.randn(b, wcfg.n_lc_out, a.steps, generator=gen) * 0.3).to(dev)
        gcond = (torch.randn(b, n_cond, a.steps, generator=gen) * 0.3).to(dev)
        ring = torch.randn(sum(wcfg.dilations), b, wcfg.n_res, generator=gen).to(
            dev, torch.bfloat16)
        prev = torch.randint(0, wcfg.n_quant, (b,), generator=gen).to(dev)
        phases = {
            "encode 1 s": lambda: ae.encode(model, cfg, wav),
            f"prime {a.steps} steps": lambda: fg.prime(
                model.wavenet, wcfg, fg.init_state(wcfg, b, device=dev), ids, cond),
            f"sampler {a.steps} steps": lambda: fc.generate_fused(
                packed, wcfg, ring, prev, 0, gcond, 5, 1.0),
        }
        for name, fn in phases.items():
            r = {"batch": b, "phase": name, **profile(fn)}
            rows.append(r)
            print(f"B={b} {name}: wall {r['wall_s']:.6f} s, device busy "
                  f"{r['device_busy_s']:.6f} s in {r['device_events']} events, "
                  f"idle {100 * r['idle_share']:.2f}%")
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
