"""Vocoder cells with a mixture-of-logistics output: ``reconstruct``
through ``models/registry``, closed loop.

Set-up, the window and the traced request are ``loops/reconstruct.py``'s
(its ``setup`` and ``request``): batches of ``batch`` utterances from the
seeded pool, each request encode, prime and generate, every
``greedy_every``-th greedy and the others sampled at ``temperature``.  The
program serves 16-bit samples.  The seeded weights' mixture is made
informative first (:func:`informative`), as a trained vocoder's is.  With
``--trace`` the traced request also reads the sampler's counter of weight
bytes read through L2 (``generate_fused.streamed_bytes``: the shares of
the layers that do not fit in shared memory), per generated step.

Compared: after the window, ``check_rows`` rows of every finished request
(drawn from the seed) are teacher-forced through the reference
(``reference/mol.py``, plain float32) on the served samples, under the
utterance's own conditioning.  At each position the reference works out
each component's score (its logit over the temperature plus the request's
Gumbel draw) and its sample with the request's uniform.  A served sample
does not name its component: it is taken to be the one that comes nearest
to meeting both limits (``reference/mol.served_gaps``).  ``mix_gap`` is
the widest gap by which its score lies below the best, ``value_gap`` the
widest distance between its reference sample and the served sample, on
the [-1, 1] scale.  Where several components' draws clip at the same end
any of them meets both limits, so ``clipped_share``, the share of checked
samples served at +-1, is held under a ceiling, and the two gaps over the
unclipped samples alone are printed beside the checks.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import counts_mol, peaks, traffic, weights
from benchmark import trace as trace_mod
from benchmark.harness import Check, Run
from benchmark.loops import reconstruct
from benchmark.reference import mol, sampling
from benchmark.reference.precision import exact

ROWS_A_BLOCK = 4  # reference rows at a time
STEPS_A_DRAW = 4096  # the reference's draws, steps at a time
# The benchmark's draw (``weights.py``: the post-net's last product at 1e-2)
# leaves the mixture's outputs near 0: near-even logits and log-scales near
# 0, so each component's logistic has a scale near 1 and a third of the
# samples clip.  A trained vocoder's mixture picks its components and draws
# narrowly, so the cell rescales each group of the post-net's last product
# (logits, means, log-scales) to a spread MIX_STD, as the reference reads
# them over the pool's first STATS_ROWS clips teacher-forced on their own
# samples for STATS_STEPS steps, and centres each component's mean on its
# own point of [-MEAN_SPREAD, MEAN_SPREAD] and its log-scale on
# LOG_SCALE_CENTRE (scales near 0.05).  Free-running, the seeded stack feeds
# its samples back with a gain above 1, so the means' own spread is kept
# small: a mean that followed the stack would run to +-1 and clip.
MIX_STD = (1.5, 0.1, 0.2)
MEAN_SPREAD, LOG_SCALE_CENTRE = 0.6, -3.0
STATS_ROWS, STATS_STEPS = 2, 256
CLIPPED = 32767  # |int16| of a sample served at +-1
COMPARED = ("mix_gap", "value_gap", "clipped_share")


def streamed_bytes() -> int | None:
    """The program's count of the sampler's weight bytes read through L2
    (None where the program has no such counter)."""
    from ae_wavenet_tpu_torch.ops import fastgen_cuda

    return getattr(fastgen_cuda.generate_fused, "streamed_bytes", None)


def informative(run: Run, w: dict, pool_wav: torch.Tensor) -> dict:
    """The seeded weights ``w`` with the mixture made informative (MIX_STD,
    MEAN_SPREAD, LOG_SCALE_CENTRE), in place: the same tensors go to the
    program and to the reference.  TF32 is left as it was."""
    voc = mol.with_stats(mol.from_json(run.config_json()), reconstruct._prefix(run))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        model = mol.build(voc, w, pool_wav.device)
        rf, c_off = mol.receptive_field(voc.cfg.wavenet), mol.c_offset(voc.cfg)
        wav = pool_wav[:STATS_ROWS]
        own = wav[:, c_off + rf + 1 : c_off + rf + 1 + STATS_STEPS]
        with torch.no_grad():
            params = mol.teacher_params(model, voc, wav, own, STATS_STEPS)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    k = voc.n_mix
    centres = (None, torch.linspace(-MEAN_SPREAD, MEAN_SPREAD, k),
               torch.full((k,), LOG_SCALE_CENTRE))
    with torch.no_grad():
        for g, (sd, centre) in enumerate(zip(MIX_STD, centres)):
            o = params[..., g * k : (g + 1) * k].reshape(-1, k)
            gain = sd / float(o.std())
            w["wavenet.post2.w"][g * k : (g + 1) * k].mul_(gain)
            b = w["wavenet.post2.b"][g * k : (g + 1) * k].mul_(gain)
            if centre is not None:
                b.add_(centre.to(b.device) - gain * o.mean(0))
    return w


def setup(run: Run) -> reconstruct.Program:
    """``reconstruct.setup`` with the mixture made informative."""
    prog = reconstruct.setup(run)
    weights.load(prog.model, informative(run, prog.weights, prog.wav))
    return prog


def request_gaps(model, voc: mol.Vocoder, r: dict, rows, pool_wav, seed: int, limits: dict,
                 device, q=exact):
    """(mix gaps, value gaps, clipped) [R, n] of request ``r``'s ``rows``
    under the reference computed with ``q``, the served samples beside its
    draws; clipped: the served sample is +-1."""
    rf = mol.receptive_field(voc.cfg.wavenet)
    temp, k = r["temperature"], voc.n_mix
    served = r["ids"].to(device)
    n = served.shape[1]
    key = sampling.kernel_seed(reconstruct.request_seed(seed, r["i"]))
    blk = torch.as_tensor(rows, device=device)
    pool = torch.as_tensor(r["rows"], device=device)[blk]
    got = served[blk]
    params = mol.teacher_params(model, voc, pool_wav[pool], got, n, q)
    x = got.float() * (1.0 / 32768.0)
    mix, val = [], []
    for t in range(0, n, STEPS_A_DRAW):
        m = min(STEPS_A_DRAW, n - t)
        p = params[:, t : t + m]
        g, v = mol.draws(key, blk, rf + t, m, k) if temp > 0.0 else (None, None)
        sc = mol.scores(p, k, temp, g)
        xk = mol.component_draws(p, k, voc.log_scale_min, temp, v)
        a, b = mol.served_gaps(sc, xk, x[:, t : t + m], limits["mix_gap"],
                               limits["value_gap"])
        mix.append(a)
        val.append(b)
    return torch.cat(mix, 1), torch.cat(val, 1), got.int().abs() >= CLIPPED


def reference_gaps(run: Run, prog_weights: dict, done: list, pool_wav: torch.Tensor,
                   device, q=exact) -> dict:
    """The widest ``mix_gap`` and ``value_gap`` over the finished
    requests' checked rows, the same over their unclipped samples alone,
    and the share of those samples served at +-1 (``clipped_share``)."""
    voc = mol.with_stats(mol.from_json(run.config_json()), reconstruct._prefix(run))
    model = mol.build(voc, prog_weights, device)
    worst = dict.fromkeys(("mix_gap", "value_gap", "mix_gap_unclipped",
                           "value_gap_unclipped"), 0.0)
    clipped = n = 0
    with torch.no_grad():
        for r in done:
            rows = reconstruct.checked_rows(run.traffic, run.seed, r["i"], len(r["rows"]))
            for a in range(0, len(rows), ROWS_A_BLOCK):
                mix, val, clip = request_gaps(model, voc, r, rows[a : a + ROWS_A_BLOCK],
                                              pool_wav, run.seed, run.limits, device, q)
                for name, v in (("mix_gap", mix), ("value_gap", val)):
                    worst[name] = max(worst[name], float(v.max()))
                    worst[name + "_unclipped"] = max(worst[name + "_unclipped"],
                                                     float(torch.where(clip, 0.0, v).max()))
                clipped += int(clip.sum())
                n += clip.numel()
    return {**worst, "clipped_share": clipped / max(n, 1)}


def run(run: Run) -> None:
    tr = run.traffic
    on_card = torch.device(run.device).type == "cuda"
    if on_card:
        run.device_kind = torch.cuda.get_device_name(0)
        run.device_count = 1
        run.peak = peaks.of(run.device_kind)
        torch.cuda.reset_peak_memory_stats()
    prog = setup(run)
    b, pool = tr["batch"], len(prog.wav)
    order = traffic.order(tr, run.seed, tr["max_requests"] + 1, pool, b)
    run.mark("built")
    reconstruct.request(prog, tr, run.seed, 0, order[0])  # greedy and sampled: one kernel
    run.setup_s = time.perf_counter() - run.t_start
    done = []
    t = time.perf_counter()
    while time.perf_counter() - t < run.seconds and len(done) < tr["max_requests"]:
        done.append(reconstruct.request(prog, tr, run.seed, len(done), order[len(done)]))
    window_s = time.perf_counter() - t
    n_gen = int(done[0]["ids"].shape[1])
    run.window = {**run.window, "seconds": window_s, "requests": len(done), "batch": b,
                  "gen_samples": len(done) * b * n_gen,
                  "prime_s": [r["timings"]["prime"] for r in done],
                  "generate_s": [r["timings"]["generate"] for r in done]}
    run.attempted, run.failed = len(done), 0
    if run.trace_on:
        before = streamed_bytes()
        with trace_mod.window(on_card) as tw:
            with trace_mod.span("request"):
                traced = reconstruct.request(prog, tr, run.seed, len(done), order[len(done)])
        run.trace = tw["trace"]
        run.window["trace_requests"] = 1
        after = streamed_bytes()
        if before is not None and after is not None:
            run.window["streamed_mb_a_step"] = (after - before) / 1e6 / traced["ids"].shape[1]
    if on_card:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    voc = mol.from_json(run.config_json())
    ops, n_bytes = counts_mol.sampler_launch(voc, b, n_gen)
    run.counts = {"request_flops": counts_mol.request_flops(voc, prog.wav.shape[1], n_gen, b),
                  "sampler_ops": ops, "sampler_bytes": n_bytes}
    w, wav, prefix = prog.weights, prog.wav, prog.prefix
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    gaps = reference_gaps(run, w, done, wav, wav.device)
    run.window["reference_s"] = time.perf_counter() - t
    if prefix is not None:
        traffic.remove_packed(prefix)
    run.checks = [Check(n, gaps[n], run.limits[n]) for n in COMPARED]
    run.window["not_compared"] = {k: v for k, v in gaps.items() if k not in COMPARED}
