"""Readings for the correctness limits of WaveGlow's serving cell and the
mixture-of-logistics vocoder's training cell: the program's, the
control's and planted faults'.

    python3 benchmark/calibrate_flow.py --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2] [--faults]

For each seed, in one process: the cell's set-up and the program's sound
readings against the reference; on the seeds of ``--control-seeds`` (all,
by default) the control's; with ``--faults`` the readings of planted
faults there.  One JSON line a seed and side on standard output, with the
seconds it took.  The benchmark's runs do not run this; a limit is set
between the largest sound reading and the smallest control or fault
reading (PERF.md gives them).

WaveGlow (``loops/vocode_flow``): the sound readings are those of two
requests (the window's first and last, as a run checks), with
``log_s_max``, the largest |log s| of any coupling in the reference's
inverse of the whole pool (the seeded ``end`` conv sets it), and
``wave_rms``, that audio's rms; the control is
the reference computed in fp8 (``reference/precision.fp8``), the precision
below the configuration's bf16, in the program's place, on the same mel
frames and noise.  The faults are planted in the program's packed weights
or noise: the +dd tap dropped in one layer, W_k used for W_k^-1 in one
flow, one early injection of noise zeroed, one layer's slice of the cond
projection taken from its neighbour.

Training the mixture vocoder (``loops/train_mol``): the control is the
reference in fp8; the faults are the loss over half the batch's rows and
the optimizer's step left out (``calibrate_vocoder``'s).
"""

import argparse
import contextlib
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
FLOW, LAYER = 5, 3  # where a fault in one flow or one layer is planted


def _at(packed) -> tuple:
    """(flow, layer) of a planted fault: FLOW and LAYER, or the last flow
    and the last layer but one of a smaller model."""
    return min(FLOW, len(packed) - 1), min(LAYER, len(packed[0].layers) - 2)


@contextlib.contextmanager
def _packed_fault(edit):
    """The program's packer (``models/waveglow.pack``) with ``edit(packed,
    model)`` applied to its output."""
    from ae_wavenet_tpu_torch.models import waveglow

    real = waveglow.pack

    def pack(model):
        return edit(real(model), model)

    waveglow.pack = pack
    try:
        yield
    finally:
        waveglow.pack = real


def tap_dropped():
    """The +dd tap's rows of w_in zeroed in one layer of one flow."""
    def edit(packed, model):
        k, i = _at(packed)
        w_in, b_in, w_out, b_out = packed[k].layers[i]
        w_in = w_in.clone()
        w_in[2 * (w_in.shape[0] // 3):] = 0
        layers = list(packed[k].layers)
        layers[i] = (w_in, b_in, w_out, b_out)
        packed[k] = packed[k]._replace(layers=tuple(layers))
        return packed
    return _packed_fault(edit)


def inverse_is_w():
    """W_k in W_k^-1's place in one flow."""
    def edit(packed, model):
        k = _at(packed)[0]
        packed[k] = packed[k]._replace(w_inv_t=model.flows[k].W.detach().t().contiguous())
        return packed
    return _packed_fault(edit)


def cond_from_neighbour():
    """One layer's slice of the cond projection taken from the next layer's."""
    def edit(packed, model):
        k, i = _at(packed)
        cond_w = packed[k].cond_w.clone()
        cond_w[i] = cond_w[i + 1]
        packed[k] = packed[k]._replace(cond_w=cond_w)
        return packed
    return _packed_fault(edit)


@contextlib.contextmanager
def early_zeroed():
    """The first early injection's channels of the noise zeroed."""
    from ae_wavenet_tpu_torch.models import waveglow

    real = waveglow.noise

    def noise(cfg, batch, rows, generator, device):
        z = real(cfg, batch, rows, generator, device)
        n = waveglow.flow_channels(cfg)[-1]
        z[:, n : n + cfg.flow.n_early_size] = 0
        return z

    waveglow.noise = noise
    try:
        yield
    finally:
        waveglow.noise = real


FLOW_FAULTS = {"fault_tap_dropped": tap_dropped, "fault_inverse_is_w": inverse_is_w,
               "fault_early_zeroed": early_zeroed,
               "fault_cond_from_neighbour": cond_from_neighbour}


def pool_readings(run, w, mel) -> dict:
    """``log_s_max`` and ``wave_rms`` of the reference's inverse of the
    whole pool, a batch at a time, on each batch's request noise."""
    import torch

    from benchmark.loops import vocode_flow as loop
    from benchmark.reference import waveglow as ref_glow

    g = ref_glow.from_json(run.config_json())
    model = ref_glow.build(g, w, mel.device)
    real, seen, sq, n = ref_glow.wn, [], 0.0, 0

    def wn(fl, g, a0, c, q=ref_glow.exact):
        out = real(fl, g, a0, c, q)
        seen.append(float(out[:, a0.shape[1]:].abs().max()))
        return out

    ref_glow.wn = wn
    try:
        with torch.no_grad():
            for i in range(0, len(mel), run.traffic["batch"]):
                m = mel[i : i + run.traffic["batch"]]
                z = torch.randn(len(m), g.n_group, m.shape[-1] * g.hop // g.n_group,
                                generator=loop.generator(mel.device, run.seed, i),
                                device=mel.device) * g.sigma
                a = ref_glow.infer(model, g, m, z)
                sq, n = sq + float(a.square().sum()), n + a.numel()
    finally:
        ref_glow.wn = real
    return {"log_s_max": max(seen), "wave_rms": (sq / n) ** 0.5}


def serve_seed(run, control: bool, faults: bool) -> list:
    from benchmark import traffic
    from benchmark.loops import vocode_flow as loop
    from benchmark.reference import precision

    tr = run.traffic
    order = None

    def serve():
        nonlocal order
        prog = loop.setup(run)
        order = traffic.order(tr, run.seed, 3, len(prog.mel), tr["batch"])
        done = [loop.request(prog, run.seed, i, order[i]) for i in (0, 1)]
        w, mel = prog.weights, prog.mel
        del prog
        gc.collect()
        return done, w, mel

    done, w, mel = serve()
    out = [("program", {**loop.reference_gaps(run, w, done, mel),
                        **pool_readings(run, w, mel)})]
    if control:
        out.append(("control_fp8", loop.reference_gaps(run, w, done, mel, precision.fp8)))
    if faults:
        for name, plant in FLOW_FAULTS.items():
            with plant():
                done_f, w_f, mel_f = serve()
            out.append((name, loop.reference_gaps(run, w_f, done_f, mel_f)))
    return out


def train_seed(run, device, control: bool, faults: bool) -> list:
    from benchmark import calibrate, calibrate_vocoder, traffic
    from benchmark.loops import train, train_mol as loop
    from benchmark.reference import precision

    prefix = train.write_data(run)
    got, w = calibrate._program_steps(run, prefix, device)
    ref = loop.reference_steps(run, w, prefix, device)
    out = [("program", train.readings(got, ref, None))]
    if control:
        ctl = loop.reference_steps(run, w, prefix, device, precision.fp8)
        out.append(("control_fp8", train.readings(train.as_program(ctl), ref, None)))
    if faults:
        for name, plant in (("fault_half_batch", calibrate_vocoder.half_batch),
                            ("fault_step_left_out", calibrate_vocoder.step_left_out)):
            with plant():
                got_f, _ = calibrate._program_steps(run, prefix, device)
            out.append((name, train.readings(got_f, ref, None)))
    traffic.remove_packed(prefix)
    return [(side, {k: v for k, v in r.items() if k != "left_out"}) for side, r in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default=None,
                    help="the seeds that also read the control (default: all)")
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
        if run.traffic["loop"] == "train_mol":
            rows = train_seed(run, device, seed in ctl, a.faults and seed in ctl)
        else:
            rows = serve_seed(run, seed in ctl, a.faults and seed in ctl)
        for side, r in rows:
            print(json.dumps({"workload": a.workload, "seed": seed, "side": side, **r,
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
