"""Training cells: ``Chassis.train``, K steps a call, closed loop.

Set-up writes the traffic's packed dataset from the seed, builds the
program's ``Chassis`` and copies the benchmark's seeded weights into it.
Its first step is a call of one step through the same ``Chassis.train``
and feed (the only way to read the optimizer's state after one step).
Then comes the window's own K-step program: its first call, which
captures it, is snapshotted before and after (every parameter and buffer,
the VQ codebook and its EMA counts and sums among them), and one more call
sets the window's pace.  The window is one ``Chassis.train`` call of as
many K-step calls as fill ``--seconds`` at that pace, ending in the loop's
own fetch.  With ``--trace`` a profiled call of 2 K steps follows.  After
the window the program's state is freed and the reference follows the same
1 + K steps on the same rows and draws.

Compared, each relative to the larger of the reference's norm of the leaf
and of the median leaf: ``grad_gap``, the median leaf's gap between the
norms of the program's and the reference's first gradient (the program's
taken from Adam's first moment after one step); ``grad_diff``, the median
leaf's norm of the difference of the two first gradients; ``change_gap``,
the worst leaf's gap between the norms of the two sides' changes over the
K-step program's first call (each side from its own state after step 1),
over the parameters and the VQ EMA counts' total (:func:`vq_totals`);
``codebook_gap``, the program's codebook after that
call against the one its own EMA statistics give under the reference's
formula (:func:`codebook_gap`: the reference follows the program's own
state there, since which code a near-tie latent joins differs between
the two sides).  Parameters whose reference gradient is under a
thousandth of the median leaf's are left out of the change (Adam moves
them by round-off alone).  Printed beside them and not compared (PERF.md
has the look at each): the losses of the first and last steps, which no
precision or fault tells apart from sound runs (the VQ commitment, most of
the loss, swings by the encoder's first sign-like Adam steps); the worst
leaf's gradient gap (a few near-tie VQ codes flip under bf16 and move the
small aux head's gradient); the VQ buffers' gap code by code (a near-tie
cluster of latents that joins another code under bf16 moves whole counts
between codes); the EMA sums' total (it follows the latents' sum, which
the encoder's first sign-like Adam steps swing); the median leaf's change
gap.
"""

from __future__ import annotations

import dataclasses
import gc
import io
import os
import statistics
import time

import numpy as np
import torch

from benchmark import counts, peaks, traffic, weights
from benchmark import trace as trace_mod
from benchmark.harness import Check, Run
from benchmark.reference import config as ref_config
from benchmark.reference import data as ref_data
from benchmark.reference import models as ref_models
from benchmark.reference import precision
from benchmark.reference import train as ref_train


@dataclasses.dataclass
class Program:
    """The program's side of one run."""
    chassis: object
    weights: dict
    prefix: str


def reference_config(run: Run, prefix: str):
    cfg = ref_config.from_json(run.config_json())
    if cfg.spec.norm == "dataset":
        mean, var = ref_data.frame_stats(prefix, cfg.spec)
        cfg = dataclasses.replace(cfg, spec=dataclasses.replace(
            cfg.spec, stats_mean=mean, stats_var=var))
    return cfg


def data_prefix(run: Run) -> str:
    return os.path.join(run.tmp, "awt_bench", run.cell["name"], "data")


def write_data(run: Run) -> str:
    """The traffic's packed dataset, drawn from the seed."""
    data, spk = traffic.clips(run.traffic["dataset"], run.seed)
    return traffic.write_packed(data_prefix(run), data, spk,
                                run.traffic["dataset"]["n_speakers"])


def setup(run: Run, prefix: str) -> Program:
    """The program's ``Chassis`` on the dataset at ``prefix``, with the
    benchmark's weights."""
    from ae_wavenet_tpu_torch.training.chassis import Chassis
    from ae_wavenet_tpu_torch.utils import config as prog_config

    run.mark("imported")
    cfg = prog_config.from_json(run.config_json())
    chassis = Chassis(cfg, prefix, ckpt_dir=None, device=run.device,
                      log_stream=io.StringIO())
    w = weights.make(chassis.model, run.seed, chassis.device)
    weights.load(chassis.model, w)
    return Program(chassis=chassis, weights=w, prefix=prefix)


def first_steps(prog: Program) -> dict:
    """Step 1 as a call of one step (its loss, and its gradient from Adam's
    first moment), then the window program's first call of K steps (its
    capture and K replays), with the state before and after it."""
    ch = prog.chassis
    k = ch.k_steps
    ch.k_steps = 1
    loss1 = ch.train(1)[-1]["loss"]
    b1 = ch.cfg.train.adam_b1
    g1 = {n: (m / (1.0 - b1)).detach().cpu() for n, m in ch.opt.mu.items()}
    ch.opt.programs.clear()  # the one-step program is not the window's
    ch.k_steps = k
    before = ref_train.state(ch.model)
    last = ch.train(k)[-1]["loss"]
    return {"loss": [loss1, last], "g1": g1, "before": before,
            "after": ref_train.state(ch.model)}


def reference_steps(run: Run, prog_weights: dict, prefix: str, device, q=precision.exact):
    """The reference's first 1 + K steps on the same rows and draws."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reference_config(run, prefix)
    spec = ref_models.window_spec(cfg)
    b = cfg.train.batch_sz
    n = 1 + cfg.train.steps_per_call
    pk = ref_data.Packed(prefix)
    tz = ref_models.encoder_geometry(cfg.encoder).out_len(spec.n_frames)
    batches, draws = [], []
    for s in range(n):
        wav, spk = pk.batch_at(spec.u_len, b, cfg.train.seed, s)
        batches.append((torch.from_numpy(wav), torch.from_numpy(spk.astype(np.int64))))
        draws.append({} if cfg.model_kind == "mfcc_inverter" else ref_data.vq_draws(
            cfg.bottleneck, b, tz, ref_data.step_generator(cfg.train.seed, s, device), device))
    return ref_train.follow(cfg, prog_weights, batches, draws, device, q, keep=(0, n - 1))


def as_program(ref: list) -> dict:
    """A reference's records in the shape of :func:`first_steps`' (for a
    control computed by the reference in the program's place)."""
    return {"loss": [ref[0]["loss"], ref[-1]["loss"]], "g1": ref[0]["grads"],
            "before": ref[0]["state"], "after": ref[-1]["state"]}


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


COMPARED = ("grad_gap", "grad_diff", "change_gap", "codebook_gap")


def vq_totals(st: dict) -> dict:
    """The VQ EMA statistics summed over the codes: the counts' total and
    the sums' total.  Which code a near-tie latent joins moves neither."""
    if "bottleneck.codebook" not in st:
        return {}
    return {"bottleneck.ema_counts.total": st["bottleneck.ema_counts"].double().sum(-1),
            "bottleneck.ema_sums.total": st["bottleneck.ema_sums"].double().sum(-2)}


def codebook_gap(got: dict, ref: list, bn) -> float:
    """How far the program's codebook after the call lies from the one its
    own EMA counts and sums give under the reference's formula, over the
    reference's codebook change in that call."""
    after = {k: got["after"][f"bottleneck.{k}"].double() for k in ("codebook", "ema_counts",
                                                                     "ema_sums")}
    want = ref_models.smoothed_codebook(bn, after["ema_counts"], after["ema_sums"])
    cb = [r["state"]["bottleneck.codebook"].double() for r in (ref[0], ref[-1])]
    return _norm(after["codebook"] - want) / _norm(cb[1] - cb[0])


def _change_gaps(before: dict, after: dict, r0: dict, r1: dict, leaves, med=None):
    d_ref = {k: _norm(r1[k] - r0[k]) for k in leaves}
    med = statistics.median(d_ref.values()) if med is None else med
    return {k: abs(_norm(after[k] - before[k]) - d) / max(d, med)
            for k, d in d_ref.items()}, med


def readings(got: dict, ref: list, bn) -> dict:
    """The program's readings against the reference's (``bn``: the
    bottleneck's configuration): the numbers compared (:data:`COMPARED`,
    ``codebook_gap`` where there is a codebook) and, for the record, those
    beside them."""
    loss = [abs(a - r["loss"]) / abs(r["loss"]) for a, r in zip(got["loss"], (ref[0], ref[-1]))]
    g_ref = {k: _norm(g) for k, g in ref[0]["grads"].items()}
    med_g = statistics.median(g_ref.values())
    grad = [abs(_norm(got["g1"][k]) - g) / max(g, med_g) for k, g in g_ref.items()]
    grad_diff = [_norm(got["g1"][k] - ref[0]["grads"][k]) / max(g, med_g)
                 for k, g in g_ref.items()]
    r0, r1 = ref[0]["state"], ref[-1]["state"]
    moved = [k for k, g in g_ref.items() if g >= 1e-3 * med_g]
    change, med_d = _change_gaps(got["before"], got["after"], r0, r1, moved)
    tot = [vq_totals(x) for x in (got["before"], got["after"], r0, r1)]
    totals = _change_gaps(*tot, list(tot[2]), med_d)[0]
    change.update({k: v for k, v in totals.items() if k == "bottleneck.ema_counts.total"})
    per_code = _change_gaps(got["before"], got["after"], r0, r1,
                            [k for k in r0 if k not in g_ref], med_d)[0]
    worst = max(change, key=change.get)
    out = {"codebook_gap": codebook_gap(got, ref, bn)} if "bottleneck.codebook" in r0 else {}
    return {**out, "grad_gap": statistics.median(grad), "grad_diff": statistics.median(grad_diff),
            "change_gap": change[worst], "change_gap_leaf": worst,
            "change_gap_params": max(change[k] for k in moved),
            "change_gap_per_code": max(per_code.values(), default=0.0),
            "change_gap_ema_sums_total": totals.get("bottleneck.ema_sums.total", 0.0),
            "loss_gap_first_last": loss, "grad_gap_worst": max(grad),
            "change_gap_median": statistics.median(change.values()),
            "left_out": sorted(set(g_ref) - set(moved))}


def timed(run: Run, prog: Program, on_card: bool) -> dict:
    """One K-step call to set the pace (the program is captured already),
    then the window: one ``Chassis.train`` call of as many K-step calls as
    fill ``--seconds`` at that pace; with ``--trace``, a profiled call of
    2 K steps.  Returns the window's readings, the process's peak memory
    among them (the capture's pool is taken before the window)."""
    ch, k = prog.chassis, prog.chassis.k_steps
    t = time.perf_counter()
    ch.train(k)
    call_s = time.perf_counter() - t
    setup_end = time.perf_counter()
    n_steps = k * max(1, round(run.seconds / call_s))
    wait0 = ch.stats.get("loader_wait", 0.0)
    t = time.perf_counter()
    hist = ch.train(n_steps)
    window_s = time.perf_counter() - t
    out = {"setup_end": setup_end, "seconds": window_s, "steps": n_steps,
           "samples": n_steps * ch.cfg.train.batch_sz * ch.spec.n_win,
           "loader_wait_s": ch.stats.get("loader_wait", 0.0) - wait0,
           "finite": all(np.isfinite(v) for v in hist[-1].values()), "trace": None}
    if run.trace_on:
        with trace_mod.window(on_card) as tw:
            with trace_mod.span("train_call"):
                ch.train(2 * k)
        out["trace"] = tw["trace"]
        out["trace_steps"] = 2 * k
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    return out


def finish(run: Run, got: dict, w: dict, prefix: str, device) -> None:
    """Counts for the readers; then the reference's steps and the checks."""
    rcfg = reference_config(run, prefix)
    rspec = ref_models.window_spec(rcfg)
    b = rcfg.train.batch_sz
    ops, n_bytes = counts.stack_step(rcfg, rspec, b)
    run.counts = {"step_flops": counts.train_step_flops(rcfg, rspec, b),
                  "stack_ops": ops, "stack_bytes": n_bytes}
    t = time.perf_counter()
    gaps = readings(got, reference_steps(run, w, prefix, device), rcfg.bottleneck)
    run.window["reference_s"] = time.perf_counter() - t
    traffic.remove_packed(prefix)
    run.checks = [Check(n, gaps[n], run.limits[n]) for n in COMPARED if n in gaps]
    run.window["not_compared"] = {k: v for k, v in gaps.items() if k not in COMPARED}


def adopt(run: Run, got: dict) -> None:
    """The window's readings into the run, for the metric readers."""
    run.setup_s = got["setup_end"] - run.t_start
    run.window.update({k: got[k] for k in ("seconds", "steps", "samples", "loader_wait_s")})
    if got["trace"] is not None:
        run.trace = got["trace"]
        run.window["trace_steps"] = got["trace_steps"]
    run.attempted = got["steps"]
    run.failed = 0 if got["finite"] else got["steps"]


def run(run: Run) -> None:
    on_card = torch.device(run.device).type == "cuda"
    if on_card:
        run.device_kind = torch.cuda.get_device_name(0)
        run.device_count = 1
        run.peak = peaks.of(run.device_kind)
    prefix = write_data(run)
    run.mark("data")
    prog = setup(run, prefix)
    run.mark("built")
    got = first_steps(prog)
    run.mark("first_steps")
    win = timed(run, prog, on_card)
    adopt(run, win)
    run.memory_peak_bytes = win["memory_peak_bytes"]
    w = prog.weights
    prog.chassis.close()
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    finish(run, got, w, prefix, w[next(iter(w))].device)
