"""Flow vocoder cells (WaveGlow): ``vocode`` of ``models/registry``'s
family, closed loop.

Set-up draws the traffic's pool of clips from the seed (``pool``: clips of
``clip_len`` samples at the configuration's rate), builds the model on the
card with the benchmark's seeded weights (``weights_waveglow.py``), works
out every clip's first ``frames`` log-mel frames through the benchmark's
own frontend (``reference/waveglow.log_mel``: a vocoder is handed mel
frames, and the reference's waveform must not rest on features the
program prepared) and packs the served path's weights once (``pack``),
then warms one request.  The window sends requests one after another, each
``batch`` clips of the pool in a seeded order: upsample, the flows from
noise drawn by a generator on the card seeded for the request (sigma from
the configuration), and the int16 samples copied to the host.  With
``--trace`` one more request is profiled, with the program's spans
(``benchmark/spans.py``).

Compared: after the window, ``check_rows`` rows (drawn from the seed) of
the window's first and last requests are vocoded by the reference
(``reference/waveglow.py``, plain float32) from the same mel frames and
the same noise (the request's generator drawn again, as the program draws
it: one ``torch.randn`` [B, n_group, rows] times sigma).  ``wave_gap`` is
the widest relative L2 distance of a checked row's served waveform from
the reference's (clipped to the int16 range, as served), ``peak_gap`` the
widest largest difference of a row over that row's largest reference
sample.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from benchmark import counts_waveglow, peaks, spans, traffic, weights, weights_waveglow
from benchmark import trace as trace_mod
from benchmark.harness import Check, Run
from benchmark.reference import waveglow as ref_glow
from benchmark.reference.precision import exact

COMPARED = ("wave_gap", "peak_gap")
TOP = 32767.0 / 32768.0  # the largest int16 sample on the [-1, 1] scale


@dataclasses.dataclass
class Program:
    cfg: object
    family: object
    model: object
    weights: dict
    mel: torch.Tensor      # the pool's frames [N, n_mels, frames] on the device
    packed: list


def setup(run: Run) -> Program:
    from ae_wavenet_tpu_torch.models import registry
    from ae_wavenet_tpu_torch.utils import config as prog_config

    tr = run.traffic
    run.mark("imported")
    cfg = prog_config.from_json(run.config_json())
    family = registry.get(cfg.model_kind)
    pool, _ = traffic.clips(tr["pool"], run.seed)
    run.mark("utterances")
    dev = torch.device(run.device)
    with torch.device(dev):  # the model's own draws land on the card, then are replaced
        model = family.init(cfg, None, dev)
    w = weights_waveglow.make(model, run.seed, dev)
    weights.load(model, w)
    run.mark("weights")
    wav = torch.from_numpy(np.stack(pool)).to(dev).float() * (1.0 / 32768.0)
    mel = ref_glow.log_mel(wav, run.config_doc["spec"])
    mel = mel[..., : tr["frames"]].contiguous()
    if mel.shape[-1] != tr["frames"]:
        raise ValueError(f"the pool's clips give {mel.shape[-1]} frames, the traffic asks "
                         f"for {tr['frames']}")
    packed = family.pack(model)
    run.mark("frames")
    return Program(cfg=cfg, family=family, model=model, weights=w, mel=mel, packed=packed)


def request_seed(seed: int, i: int) -> int:
    """The seed of request ``i``'s noise generator."""
    return int(np.random.SeedSequence([int(seed), 0xF1, i]).generate_state(1)[0])


def generator(device, seed: int, i: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(request_seed(seed, i))


def request(prog: Program, seed: int, i: int, rows) -> dict:
    """Request ``i`` on pool ``rows``: the served samples, on the host."""
    dev = prog.mel.device
    idx = torch.as_tensor(np.asarray(rows), device=dev)
    out = prog.family.vocode(prog.model, prog.cfg, prog.mel[idx], generator(dev, seed, i),
                             prog.packed)
    return {"i": i, "rows": np.asarray(rows), "samples": out.cpu()}


def checked_rows(tr: dict, seed: int, i: int, batch: int) -> np.ndarray:
    k = min(int(tr.get("check_rows", batch)), batch)
    rng = np.random.default_rng([int(seed), 0xC5, i])
    return np.sort(rng.choice(batch, size=k, replace=False))


def reference_audio(run: Run, model, g, r: dict, mel: torch.Tensor, q=exact) -> tuple:
    """(rows, the reference's audio [R, T] of request ``r``'s checked rows,
    clipped as served)."""
    dev = mel.device
    rows = checked_rows(run.traffic, run.seed, r["i"], len(r["rows"]))
    rows_t = torch.as_tensor(rows, device=dev)
    z = torch.randn(len(r["rows"]), g.n_group, mel.shape[-1] * g.hop // g.n_group,
                    generator=generator(dev, run.seed, r["i"]), device=dev) * g.sigma
    pool = torch.as_tensor(r["rows"], device=dev)[rows_t]
    a = ref_glow.infer(model, g, mel[pool], z[rows_t], q)
    return rows, torch.clamp(a, -1.0, TOP)


def gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Per-row wave and peak gaps of served samples ``got`` (floats) against
    ``want``: their largest over the rows."""
    d = got - want
    wave = d.norm(dim=1) / want.norm(dim=1)
    peak = d.abs().amax(1) / want.abs().amax(1)
    return {"wave_gap": float(wave.max()), "peak_gap": float(peak.max())}


def reference_gaps(run: Run, prog_weights: dict, checked: list, mel: torch.Tensor,
                   q=exact) -> dict:
    """The checked requests' gaps against the reference computed with ``q``
    (served samples against the float32 reference's), the worst of each."""
    g = ref_glow.from_json(run.config_json())
    model = ref_glow.build(g, prog_weights, mel.device)
    worst = dict.fromkeys(COMPARED, 0.0)
    with torch.no_grad():
        for r in checked:
            rows, want = reference_audio(run, model, g, r, mel)
            got = r["samples"][rows].to(mel.device).float() * (1.0 / 32768.0)
            if q is not exact:
                got = reference_audio(run, model, g, r, mel, q)[1]
            for k, v in gaps(got, want).items():
                worst[k] = max(worst[k], v)
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
    b, pool = tr["batch"], len(prog.mel)
    order = traffic.order(tr, run.seed, tr["max_requests"] + 1, pool, b)
    run.mark("built")
    request(prog, run.seed, 0, order[0])
    run.setup_s = time.perf_counter() - run.t_start
    first = last = None
    n = 0
    t = time.perf_counter()
    while time.perf_counter() - t < run.seconds and n < tr["max_requests"]:
        last = request(prog, run.seed, n, order[n])
        first = first or last
        n += 1
    window_s = time.perf_counter() - t
    n_gen = int(last["samples"].shape[1])
    run.window = {**run.window, "seconds": window_s, "requests": n, "batch": b,
                  "gen_samples": n * b * n_gen}
    run.attempted, run.failed = n, 0
    if run.trace_on:
        with spans.window(on_card) as tw:
            with trace_mod.span("request"):
                request(prog, run.seed, n, order[n])
        run.trace = tw["trace"]
        run.window["trace_requests"] = 1
        spans.print_by_name(run, "vocode_flow")
    if on_card:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    g = ref_glow.from_json(run.config_json())
    ops, n_bytes = counts_waveglow.layer_launch(g, b, n_gen // g.n_group)
    run.counts = {"request_flops": counts_waveglow.request_flops(g, b, tr["frames"]),
                  "layer_ops": ops, "layer_bytes": n_bytes}
    w, mel = prog.weights, prog.mel
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    got = reference_gaps(run, w, [first] if last is first else [first, last], mel)
    run.window["reference_s"] = time.perf_counter() - t
    run.checks = [Check(k, got[k], run.limits[k]) for k in COMPARED]
