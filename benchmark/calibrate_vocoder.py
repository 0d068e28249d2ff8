"""Readings for the correctness limits of the vocoder cells: the program's,
the control's and planted faults'.

    python3 benchmark/calibrate_vocoder.py --workload <cell> --seeds 1,2,3
        [--requests N] [--control-seeds 1,2] [--faults]

For each seed, in one process: the cell's set-up and the program's sound
readings against the reference; on the seeds of ``--control-seeds`` (all,
by default) the control's; with ``--faults`` the readings of planted
faults.  One JSON line a seed and side on standard output, with the
seconds it took.  The benchmark's runs do not run this; a limit is set
between the largest sound reading and the smallest control or fault
reading (PERF.md gives them).

Serving with a mixture output (``loops/vocode_mol``): the sound readings
are the first ``--requests`` requests'.  The control is the reference
computed in fp8 (``reference/precision.fp8``), the precision below the
configuration's bf16, in the program's place: teacher-forced on the same
served samples, it picks each position's component and sample with the
same draws, and those are read against the float32 reference.  The faults
are planted in the program's packed weights: the mixture logits moved one
component over (a component altered), the means raised by 0.1 (a sample
altered), and the shares of the first layer that streams through L2 zeroed
(on a card whose plan streams some).

Training the MFCC inverter (``loops/train``): the control is the reference
in fp8, as ``calibrate.py`` reads it; the faults are the inverter's loss
over half the batch's rows, and the optimizer's step left out.
"""

import argparse
import contextlib
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
MEANS_SHIFT = 0.1


@contextlib.contextmanager
def patched(owner, name: str, value):
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def _packed_fault(edit):
    """The program's mixture packer (``fastgen_cuda.PACKERS["mol"]``) with
    ``edit(post2_w, post2_b, n_mix)`` applied to copies of the post-net's
    last product."""
    from ae_wavenet_tpu_torch.ops import fastgen_cuda

    real = fastgen_cuda.PACKERS["mol"]

    def pack(wavenet, cfg):
        p = real(wavenet, cfg)
        w, b = edit(p.post2_w.clone(), p.post2_b.clone(), cfg.n_mix)
        return p._replace(post2_w=w, post2_b=b)

    fastgen_cuda.PACKERS["mol"] = pack
    try:
        yield
    finally:
        fastgen_cuda.PACKERS["mol"] = real


def component_altered():
    """The mixture logits moved one component over."""
    def edit(w, b, k):
        w[:, :k] = w[:, :k].roll(1, 1)
        b[:k] = b[:k].roll(1, 0)
        return w, b
    return _packed_fault(edit)


def sample_altered():
    """Every component's mean raised by ``MEANS_SHIFT``."""
    def edit(w, b, k):
        b[k : 2 * k] += MEANS_SHIFT
        return w, b
    return _packed_fault(edit)


def streamed_zeroed():
    """The shares of the first layer that is not resident in shared memory
    zeroed in every block (no fault where every layer is resident)."""
    from ae_wavenet_tpu_torch.ops import fastgen_cuda

    real = fastgen_cuda.pack_shares

    def pack_shares(packed, plan):
        share = real(packed, plan)
        if plan.resident_layers < plan.n_layers:
            for r in range(plan.n_blocks):
                a = plan.post_bytes(r) + plan.resident_layers * plan.layer_bytes(r)
                share[r, a : a + plan.layer_bytes(r)] = 0
        return share

    return patched(fastgen_cuda, "pack_shares", pack_shares)


SERVE_FAULTS = {"fault_component_altered": component_altered,
                "fault_sample_altered": sample_altered,
                "fault_streamed_layer_zeroed": streamed_zeroed}


def control_gaps(run, prog_weights, done, pool_wav, device) -> dict:
    """The fp8 reference's picks on the served samples, read against the
    float32 reference: the widest mix and value gaps."""
    import torch

    from benchmark.loops import reconstruct, vocode_mol as loop
    from benchmark.reference import mol, precision, sampling

    voc = mol.with_stats(mol.from_json(run.config_json()), reconstruct._prefix(run))
    model = mol.build(voc, prog_weights, device)
    rf, k = mol.receptive_field(voc.cfg.wavenet), voc.n_mix
    worst = {"mix_gap": 0.0, "value_gap": 0.0}
    with torch.no_grad():
        for r in done:
            temp, n = r["temperature"], r["ids"].shape[1]
            key = sampling.kernel_seed(reconstruct.request_seed(run.seed, r["i"]))
            rows = reconstruct.checked_rows(run.traffic, run.seed, r["i"], len(r["rows"]))
            for a in range(0, len(rows), loop.ROWS_A_BLOCK):
                blk = torch.as_tensor(rows[a : a + loop.ROWS_A_BLOCK], device=device)
                pool = torch.as_tensor(r["rows"], device=device)[blk]
                got = r["ids"].to(device)[blk]
                ref = mol.teacher_params(model, voc, pool_wav[pool], got, n)
                ctl = mol.teacher_params(model, voc, pool_wav[pool], got, n, precision.fp8)
                for t in range(0, n, loop.STEPS_A_DRAW):
                    m = min(loop.STEPS_A_DRAW, n - t)
                    g, v = mol.draws(key, blk, rf + t, m, k) if temp > 0.0 else (None, None)
                    pc = ctl[:, t : t + m]
                    pick = mol.scores(pc, k, temp, g).argmax(-1, keepdim=True)
                    x = mol.component_draws(pc, k, voc.log_scale_min, temp, v).gather(
                        -1, pick)[..., 0]
                    pr = ref[:, t : t + m]
                    mg, vg = mol.served_gaps(mol.scores(pr, k, temp, g), mol.component_draws(
                        pr, k, voc.log_scale_min, temp, v), x, run.limits["mix_gap"],
                        run.limits["value_gap"])
                    worst["mix_gap"] = max(worst["mix_gap"], float(mg.max()))
                    worst["value_gap"] = max(worst["value_gap"], float(vg.max()))
    return worst


def serve_seed(run, device, n_requests: int, control: bool, faults: bool) -> list:
    from benchmark import traffic
    from benchmark.loops import reconstruct, vocode_mol as loop

    tr = run.traffic
    prog = loop.setup(run)
    order = traffic.order(tr, run.seed, n_requests, len(prog.wav), tr["batch"])

    def serve():
        return [reconstruct.request(prog, tr, run.seed, i, order[i]) for i in range(n_requests)]

    sides = [("program", serve())]
    if faults:
        for name, plant in SERVE_FAULTS.items():
            with plant():
                sides.append((name, serve()))
    w, wav, prefix = prog.weights, prog.wav, prog.prefix
    del prog
    gc.collect()
    out = [(side, loop.reference_gaps(run, w, done, wav, device)) for side, done in sides]
    if control:
        out.insert(1, ("control_fp8", control_gaps(run, w, sides[0][1], wav, device)))
    if prefix is not None:
        traffic.remove_packed(prefix)
    return out


def half_batch():
    """The inverter's loss over the first half of the batch's rows only."""
    from ae_wavenet_tpu_torch.models import mfcc_inverter

    real = mfcc_inverter.loss_fn

    def loss_fn(model, cfg, spec, wav, spk, step=None, train=True, generator=None,
                draws=None, group=None):
        h = wav.shape[0] // 2
        return real(model, cfg, spec, wav[:h], spk[:h], step, train, generator, draws, group)

    return patched(mfcc_inverter, "loss_fn", loss_fn)


def step_left_out():
    """The optimizer's update left out: the state stays as it was."""
    import torch

    from ae_wavenet_tpu_torch.training import chassis

    def update(self, grads, bc, lr):
        gs = [g for g in grads.values() if g is not None]
        return torch.linalg.vector_norm(torch.stack([g.norm() for g in gs]))

    return patched(chassis.Adam, "update", update)


def train_seed(run, device, control: bool, faults: bool) -> list:
    from benchmark import calibrate, traffic
    from benchmark.loops import train as loop
    from benchmark.reference import precision

    prefix = loop.write_data(run)
    got, w = calibrate._program_steps(run, prefix, device)
    ref = loop.reference_steps(run, w, prefix, device)
    bn = loop.reference_config(run, prefix).bottleneck
    out = [("program", loop.readings(got, ref, bn))]
    if control:
        ctl = loop.reference_steps(run, w, prefix, device, precision.fp8)
        out.append(("control_fp8", loop.readings(loop.as_program(ctl), ref, bn)))
    if faults:
        for name, plant in (("fault_half_batch", half_batch),
                            ("fault_step_left_out", step_left_out)):
            with plant():
                got_f, _ = calibrate._program_steps(run, prefix, device)
            out.append((name, loop.readings(got_f, ref, bn)))
    traffic.remove_packed(prefix)
    return [(side, {k: v for k, v in r.items() if k != "left_out"}) for side, r in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default=None,
                    help="the seeds that also read the control (default: all)")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", action="store_true",
                    help="also the readings of planted faults, on the control's seeds")
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
            rows = serve_seed(run, device, a.requests, seed in ctl, a.faults and seed in ctl)
        for side, r in rows:
            print(json.dumps({"workload": a.workload, "seed": seed, "side": side, **r,
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
