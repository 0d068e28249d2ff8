"""Readings for the correctness limits: the program's and the control's.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--requests N]
        [--control-seeds 1,2] [--faults]

For each seed, in one process: the cell's set-up and the program's sound
readings against the reference (training: step 1 and the window program's
first K-step call; serving: the run's first ``--requests`` requests, greedy
and sampled as the traffic mixes them); on the seeds of
``--control-seeds`` (all, by default) the control's readings against the
same reference; and with ``--faults`` (training) planted faults' readings.
The control is the precision below the configuration's bf16: for training
the reference itself with every product's operands in fp8
(``reference/precision.fp8``), for serving the program's own int8 sampler
(``quantized="int8"``) on the same requests.  One JSON line a seed and side
on standard output, with the seconds it took.  The benchmark's runs do not
run this; a limit is set between the largest sound reading and the
smallest control or fault reading (PERF.md gives them).
"""

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def half_batch():
    """Plant a fault in the program: the step's loss over the first half of
    its rows only (the mean over the rest).  Returns the undo."""
    from ae_wavenet_tpu_torch.models import autoencoder

    real = autoencoder.loss_fn

    def loss_fn(model, cfg, spec, wav, spk, step, train=True, generator=None, draws=None,
                group=None):
        h = wav.shape[0] // 2
        if draws:
            tz = draws["jitter_u"].shape[-1]
            draws = {"jitter_u": draws["jitter_u"][:h],
                     "restart_idx": draws["restart_idx"] % (h * tz)}
        return real(model, cfg, spec, wav[:h], spk[:h], step, train, generator, draws, group)

    autoencoder.loss_fn = loss_fn
    return lambda: setattr(autoencoder, "loss_fn", real)


def ema_unchanged(names=("codebook", "ema_counts", "ema_sums")):
    """Plant a fault in the program: the VQ bottleneck's step leaves the
    buffers ``names`` (by default its codebook, EMA counts and sums) as they
    were, put back after the update.  Returns the undo."""
    import torch

    from ae_wavenet_tpu_torch.models import bottlenecks

    real = bottlenecks.VQBottleneck.train_apply

    def train_apply(self, *a, **kw):
        state = [getattr(self, n) for n in names]
        kept = [t.clone() for t in state]
        out = real(self, *a, **kw)
        with torch.no_grad():
            for t, v in zip(state, kept):
                t.copy_(v)
        return out

    bottlenecks.VQBottleneck.train_apply = train_apply
    return lambda: setattr(bottlenecks.VQBottleneck, "train_apply", real)


def codebook_unchanged():
    """Plant a fault in the program: the EMA counts and sums are updated,
    the codebook is not.  Returns the undo."""
    return ema_unchanged(("codebook",))


def _program_steps(run, prefix, device):
    import torch

    from benchmark.loops import train as loop

    prog = loop.setup(run, prefix)
    got = loop.first_steps(prog)
    w = prog.weights
    prog.chassis.close()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return got, w


def train_seed(run, device, control: bool, faults: bool) -> list:
    from benchmark import traffic
    from benchmark.loops import train as loop
    from benchmark.reference import precision

    prefix = loop.write_data(run)
    got, w = _program_steps(run, prefix, device)
    ref = loop.reference_steps(run, w, prefix, device)
    bn = loop.reference_config(run, prefix).bottleneck
    out = [("program", loop.readings(got, ref, bn))]
    if control:
        ctl = loop.reference_steps(run, w, prefix, device, precision.fp8)
        out.append(("control_fp8", loop.readings(loop.as_program(ctl), ref, bn)))
    if faults:
        undo = half_batch()
        try:
            hb, _ = _program_steps(run, prefix, device)
        finally:
            undo()
        out.append(("fault_half_batch", loop.readings(hb, ref, bn)))
        for name, plant in (("fault_ema_unchanged", ema_unchanged),
                            ("fault_codebook_unchanged", codebook_unchanged)):
            undo = plant()
            try:
                got_f, _ = _program_steps(run, prefix, device)
            finally:
                undo()
            out.append((name, loop.readings(got_f, ref, bn)))
    traffic.remove_packed(prefix)
    return [(side, {k: v for k, v in r.items() if k != "left_out"}) for side, r in out]


def serve_seed(run, device, n_requests: int, control: bool) -> list:
    from benchmark import traffic
    from benchmark.loops import reconstruct as loop

    tr = run.traffic
    prog = loop.setup(run)
    order = traffic.order(tr, run.seed, n_requests, len(prog.wav), tr["batch"])
    sound = [loop.request(prog, tr, run.seed, i, order[i]) for i in range(n_requests)]
    ctl = [loop.request(prog, tr, run.seed, i, order[i], quantized="int8")
           for i in range(n_requests)] if control else []
    w, wav, spk, prefix = prog.weights, prog.wav, prog.spk, prog.prefix
    del prog
    gc.collect()
    out = [("program", {"widest_gap": loop.reference_gaps(run, w, sound, wav, spk, device)})]
    if control:
        out.append(("control_int8",
                    {"widest_gap": loop.reference_gaps(run, w, ctl, wav, spk, device)}))
    if prefix is not None:
        traffic.remove_packed(prefix)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default=None,
                    help="the seeds that also read the control (default: all)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", action="store_true",
                    help="training: also the readings of planted faults (half the "
                         "batch; the VQ EMA update left out; the codebook alone)")
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    man = harness.manifest()
    device = torch.device(a.device)
    seeds = [int(s) for s in a.seeds.split(",")]
    ctl = set(seeds if a.control_seeds is None else
              [int(s) for s in a.control_seeds.split(",")])
    for seed in seeds:
        t = time.perf_counter()
        run = harness.open_run(man, a.workload, seed, 0.0, False, device=a.device)
        if run.traffic["loop"] == "train":
            rows = train_seed(run, device, seed in ctl, a.faults and seed in ctl)
        else:
            rows = serve_seed(run, device, a.requests, seed in ctl)
        for side, r in rows:
            print(json.dumps({"workload": a.workload, "seed": seed, "side": side, **r,
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
