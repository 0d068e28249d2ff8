"""Serving cells: ``reconstruct`` through ``models/registry``, closed loop.

Set-up draws the traffic's pool of utterances from the seed (written as a
packed dataset where the configuration normalises frames by the dataset's
statistics, which the program then works out from it), builds the model
on the card with the benchmark's seeded weights and warms one request (a
greedy and a sampled request launch the same kernels, with one flag).  The window sends requests one
after another (``batch`` utterances each, in a seeded order) until
``--seconds`` have passed; each is encode, prime and generate, timed by
the program's own ``timings``.  With ``--trace`` one more request is
profiled.  Every ``greedy_every``-th request is decoded greedily, the
others sampled at ``temperature``.

Compared: after the window, the served ids of every request the window
finished (of ``check_rows`` of its rows, drawn from the seed, where the
traffic names that many) are fed to the reference's teacher-forced decoder
under the utterance's own conditioning.  At each position the reference
works out the score the sampler maximises (its logit, over the temperature
plus the request's Gumbel draw where it samples: ``reference/sampling``);
the number is the widest gap, over all positions, by which a served id's
score lies below the reference's best.
"""

from __future__ import annotations

import dataclasses
import gc
import os
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
from benchmark.reference import sampling

ROWS_A_BLOCK = 8  # reference rows at a time
STEPS_A_DRAW = 4096  # the reference's Gumbel draws, steps at a time


@dataclasses.dataclass
class Program:
    cfg: object
    family: object
    model: object
    weights: dict
    wav: torch.Tensor      # the pool [N, L] int16 on the device
    spk: torch.Tensor      # [N]
    prefix: str | None


def _prefix(run: Run) -> str:
    return os.path.join(run.tmp, "awt_bench", run.cell["name"], "pool")


def setup(run: Run) -> Program:
    from ae_wavenet_tpu_torch.models import registry
    from ae_wavenet_tpu_torch.utils import config as prog_config

    tr = run.traffic
    run.mark("imported")
    cfg = prog_config.from_json(run.config_json())
    pool, spk = traffic.clips(tr["pool"], run.seed)
    run.mark("utterances")
    prefix = None
    if cfg.spec.norm == "dataset":
        from ae_wavenet_tpu_torch.data.preprocess import dataset_frame_stats

        prefix = traffic.write_packed(_prefix(run), pool, spk, tr["pool"]["n_speakers"])
        mean, var = dataset_frame_stats(prefix, cfg.spec)
        cfg = dataclasses.replace(cfg, spec=dataclasses.replace(
            cfg.spec, stats_mean=mean, stats_var=var))
        run.mark("frame_stats")
    family = registry.get(cfg.model_kind)
    dev = torch.device(run.device)
    with torch.device(dev):  # the model's own draws land on the card, then are replaced
        model = family.init(cfg, None, dev)
    run.mark("model")
    w = weights.make(model, run.seed, dev)
    run.mark("weights")
    weights.load(model, w)
    wav = torch.from_numpy(np.stack(pool)).to(dev)
    run.mark("loaded")
    return Program(cfg=cfg, family=family, model=model, weights=w, wav=wav,
                   spk=torch.from_numpy(spk).to(dev), prefix=prefix)


def request_seed(seed: int, i: int) -> int:
    """The seed of request ``i``'s generator."""
    return int(np.random.SeedSequence([int(seed), 0x5E, i]).generate_state(1)[0])


def request(prog: Program, tr: dict, seed: int, i: int, rows, quantized=False) -> dict:
    """Request ``i`` on pool ``rows``: the served ids and the program's
    timings."""
    idx = torch.as_tensor(np.asarray(rows), device=prog.wav.device)
    temp = 0.0 if traffic.greedy(tr, i) else float(tr["temperature"])
    gen = torch.Generator().manual_seed(request_seed(seed, i))
    timings: dict = {}
    ids, _ = prog.family.reconstruct(prog.model, prog.cfg, prog.wav[idx], prog.spk[idx],
                                     gen, temp, tr["gen_samples"], timings, quantized)
    return {"i": i, "rows": np.asarray(rows), "temperature": temp, "ids": ids,
            "timings": timings}


def checked_rows(tr: dict, seed: int, i: int, batch: int) -> np.ndarray:
    """The rows of request ``i``'s batch that are compared: ``check_rows``
    of them drawn from the seed, or all."""
    k = min(int(tr.get("check_rows", batch)), batch)
    rng = np.random.default_rng([int(seed), 0xC4, i])
    return np.sort(rng.choice(batch, size=k, replace=False))


def reference_gaps(run: Run, prog_weights: dict, done: list, pool_wav: torch.Tensor,
                   pool_spk: torch.Tensor, device, q=precision.exact) -> float:
    """The widest gap of the finished requests' served ids under the
    reference's scores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ref_config.from_json(run.config_json())
    if cfg.spec.norm == "dataset":
        mean, var = ref_data.frame_stats(_prefix(run), cfg.spec)
        cfg = dataclasses.replace(cfg, spec=dataclasses.replace(
            cfg.spec, stats_mean=mean, stats_var=var))
    model = ref_models.build(cfg, prog_weights, device)
    rf = ref_models.receptive_field(cfg.wavenet)
    worst = 0.0
    with torch.no_grad():
        for r in done:
            temp = r["temperature"]
            served = r["ids"].to(device)
            n = served.shape[1]
            rows = checked_rows(run.traffic, run.seed, r["i"], len(r["rows"]))
            key = sampling.kernel_seed(request_seed(run.seed, r["i"]))
            for a in range(0, len(rows), ROWS_A_BLOCK):
                blk = torch.as_tensor(rows[a : a + ROWS_A_BLOCK], device=device)
                pool = torch.as_tensor(r["rows"], device=device)[blk]
                ids = served[blk]
                sc = ref_models.teacher_logits(model, cfg, pool_wav[pool], pool_spk[pool],
                                               ids, n, q)
                if temp > 0.0:
                    sc = sc * (1.0 / temp)
                    for t in range(0, n, STEPS_A_DRAW):
                        m = min(STEPS_A_DRAW, n - t)
                        sc[:, t : t + m] += sampling.gumbel(key, blk, rf + t, m, sc.shape[-1])
                picked = sc.gather(-1, ids[..., None].long())[..., 0]
                worst = max(worst, float((sc.max(-1).values - picked).max()))
    return worst


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
    request(prog, tr, run.seed, 0, order[0])  # greedy and sampled run one kernel
    run.setup_s = time.perf_counter() - run.t_start
    done = []
    t = time.perf_counter()
    while time.perf_counter() - t < run.seconds and len(done) < tr["max_requests"]:
        done.append(request(prog, tr, run.seed, len(done), order[len(done)]))
    window_s = time.perf_counter() - t
    n_gen = int(done[0]["ids"].shape[1])
    run.window = {**run.window, "seconds": window_s, "requests": len(done), "batch": b,
                  "gen_samples": len(done) * b * n_gen,
                  "prime_s": [r["timings"]["prime"] for r in done],
                  "generate_s": [r["timings"]["generate"] for r in done]}
    run.attempted, run.failed = len(done), 0
    if run.trace_on:
        with trace_mod.window(on_card) as tw:
            with trace_mod.span("request"):
                request(prog, tr, run.seed, len(done), order[len(done)])
        run.trace = tw["trace"]
        run.window["trace_requests"] = 1
    if on_card:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    rcfg = ref_config.from_json(run.config_json())
    ops, n_bytes = counts.sampler_launch(rcfg, b, n_gen)
    run.counts = {"request_flops": counts.request_flops(rcfg, prog.wav.shape[1], n_gen, b),
                  "sampler_ops": ops, "sampler_bytes": n_bytes}
    w, wav, spk, prefix = prog.weights, prog.wav, prog.spk, prog.prefix
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    gap = reference_gaps(run, w, done, wav, spk, wav.device)
    run.window["reference_s"] = time.perf_counter() - t
    if prefix is not None:
        traffic.remove_packed(prefix)
    run.checks = [Check("widest_gap", gap, run.limits["widest_gap"])]
