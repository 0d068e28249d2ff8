#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and no network.  Phases, each
printing its own line(s), every measurement beside the card's name and
power limit:

1. environment: torch, CUDA, nvcc, triton, the card;
2. build: compiles ae_wavenet_tpu_torch/csrc/*.cu from this checkout;
3. the fused sampler kernel against its plain PyTorch version at the full
   width of the ``chorowski`` preset (seeded random weights, ring primed on
   2047 context ids, B = 8): greedy ids and logits (and two faults planted
   in the plain version, which the same check must reject), rings and last
   ids, chunk carry, the sampling distribution, and both versions' time
   per step;
4. serving: the generate CLI on one clip (B = 1) of a synthetic dataset from
   an export-format checkpoint, then ``reconstruct`` on a batch of 64 clips,
   with the kernel's launch counter showing the path went through it.

Then one JSON line describing the kernel, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

GREEDY_T = 128          # steps of the greedy comparison
LOGIT_REL_TOL = 0.05    # bf16 sampler tolerance, tests_tpu/test_pallas_tpu.py:236
MIN_PREFIX = 8          # greedy steps over which every row's ids must agree
STATE_T = 16            # steps after which rings and last ids are compared
RING_REL_TOL = 1e-2     # rings hold bf16 of f32 sums taken in another order
POST2_SCALE = 8.0       # makes the seeded logits informative (max ~5, not ~0.65)
KS_ALPHA = 1e-6         # false-failure rate of the sampling test
SAMPLE_T = 2048         # steps of the sampling test (x 8 rows >= 16k draws)
CLI_SAMPLES = 4000      # B = 1 request
BATCH = 64              # batched request
BATCH_SAMPLES = 2000
BATCH_WAV_LEN = 10200   # chorowski: cond frames for 2000 samples after rf


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def compare(ids_a, lg_a, ids_b, lg_b) -> tuple[list[int], float]:
    """Per row, the steps before the first differing id; and the largest
    |logit difference| over each row's inclusive agreeing prefix."""
    t_len = ids_a.shape[1]
    agree, max_abs = [], 0.0
    for r in range(ids_a.shape[0]):
        diff = (ids_a[r] != ids_b[r]).nonzero()
        t_div = t_len if len(diff) == 0 else int(diff[0])
        agree.append(t_div)
        hi = min(t_div + 1, t_len)
        max_abs = max(max_abs, float((lg_a[:hi, r] - lg_b[:hi, r]).abs().max()))
    return agree, max_abs


def passes(agree: list[int], rel: float) -> bool:
    return min(agree) >= MIN_PREFIX and rel < LOGIT_REL_TOL


def pit_ks(ids, logits, seed: int = 0):
    """KS distance to U(0,1) of the randomized probability integral
    transform of each draw under softmax(logits); i.i.d. uniform when every
    draw of the rollout comes from its own predictive distribution."""
    import torch

    p = torch.softmax(logits.double(), -1).cpu()          # [T, B, Q]
    idx = ids.t().long().cpu()[..., None]                 # [T, B, 1]
    pk = p.gather(-1, idx)[..., 0]
    below = torch.cumsum(p, -1).gather(-1, idx)[..., 0] - pk
    v = torch.rand(pk.shape, generator=torch.Generator().manual_seed(seed),
                   dtype=torch.float64)
    u = torch.sort((below + v * pk).flatten()).values
    n = u.numel()
    k = torch.arange(1, n + 1, dtype=torch.float64)
    return float(torch.maximum(k / n - u, u - (k - 1) / n).max()), n


def phase_env(card: str) -> None:
    import torch
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    nvcc = nvcc if os.path.exists(nvcc) else shutil.which("nvcc")
    nvcc_line = "not found"
    if nvcc:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        nvcc_line = [ln for ln in out.splitlines() if "release" in ln][-1]
    try:
        import triton  # noqa: F401
        has_triton = f"yes {triton.__version__}"
    except ImportError:
        has_triton = "no"
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"nvcc: {nvcc_line} | triton: {has_triton} | card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build(card: str) -> None:
    from ae_wavenet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_info.get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    print(f"[build] {secs:.2f} s (nvcc {_build.build_info.get('seconds', 0.0):.2f} s)"
          f" {_build.build_info['path']} | {' | '.join(ptxas)} | {card}")


def phase_kernel(card: str, dev) -> dict:
    import torch

    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.ops import fastgen as fg
    from ae_wavenet_tpu_torch.ops import fastgen_cuda as fc
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    cfg = chorowski_config()
    wcfg = cfg.wavenet
    gen = torch.Generator().manual_seed(0)
    model = ae.init(cfg, gen, dev).eval()
    with torch.no_grad():
        model.wavenet.post2["w"].mul_(POST2_SCALE)
    packed = fc.pack_for_kernel(model.wavenet, wcfg)
    rf, b = sum(wcfg.dilations), 8
    n_cond = wcfg.n_lc_out + wcfg.n_global_embed

    ctx = torch.randint(0, wcfg.n_quant, (b, rf + 1), generator=gen).to(dev)
    cond = (torch.randn(b, wcfg.n_lc_out, rf, generator=gen) * 0.3).to(dev)
    spk = torch.randint(0, wcfg.n_speakers, (b,), generator=gen).to(dev)
    t0 = time.perf_counter()
    state = fg.prime(model.wavenet, wcfg, fg.init_state(wcfg, b, device=dev),
                     ctx, cond, spk)
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    print(f"[kernel] primed B={b} on {rf + 1} context ids in {prime_s:.2f} s | {card}")
    flat = fc.state_to_flat(state, wcfg)
    gcond = (torch.randn(b, n_cond, SAMPLE_T, generator=gen) * 0.3).to(dev)

    def run(fn, t_len, seed, temperature, debug=True, ring=flat, t0=state.t,
            prev=state.prev_id):
        return fn(packed, wcfg, ring.clone(), prev, t0, gcond[..., :t_len],
                  seed, temperature, debug)

    # greedy: ids over each row's inclusive agreeing prefix, logits there
    ids_k, _, _, lg_k = run(fc.generate_fused, GREEDY_T, 0, 0.0)
    ids_r, _, _, lg_r = run(fc.generate_fused_reference, GREEDY_T, 0, 0.0)
    torch.cuda.synchronize()
    scale = float(lg_r.abs().max())
    agree, max_abs = compare(ids_k, lg_k, ids_r, lg_r)
    check(bool(torch.isfinite(lg_k).all()), "non-finite kernel logits")
    check(passes(agree, max_abs / scale),
          f"greedy kernel vs plain: prefixes {agree}, logits {max_abs / scale:.4g} "
          f"of max|logits| (need every prefix >= {MIN_PREFIX}, < {LOGIT_REL_TOL})")
    print(f"[kernel] greedy T={GREEDY_T} B={b}: ids agree for {agree} steps (each "
          f">= {MIN_PREFIX}), logits max|d| {max_abs:.4g} = {max_abs / scale:.4g} of "
          f"max|logits| {scale:.4g} (tol {LOGIT_REL_TOL}) | {card}")

    # the same check on planted faults of the plain version must fail
    l_bad = len(wcfg.dilations) // 2
    w_out, b_out = packed.w_out.clone(), packed.b_out.clone()
    w_out[l_bad, :, wcfg.n_res:] = 0
    b_out[l_bad, wcfg.n_res:] = 0
    faults = {f"layer {l_bad} skip dropped": (packed._replace(w_out=w_out, b_out=b_out),
                                              state.t),
              "ring slot off by one": (packed, state.t + 1)}
    for name, (pk, t_f) in faults.items():
        ids_f, _, _, lg_f = fc.generate_fused_reference(
            pk, wcfg, flat.clone(), state.prev_id, t_f, gcond[..., :GREEDY_T], 0,
            0.0, True)
        agree_f, abs_f = compare(ids_k, lg_k, ids_f, lg_f)
        check(not passes(agree_f, abs_f / scale),
              f"planted fault '{name}' passes the kernel check")
        print(f"[kernel] planted fault '{name}' in the plain version: prefixes "
              f"{agree_f}, logits {abs_f / scale:.4g} of max|logits|: rejected | {card}")

    # state after a short greedy rollout: last ids equal and rings within one
    # bf16 rounding for every row whose ids all agreed
    s_k, ring_k, last_k = run(fc.generate_fused, STATE_T, 0, 0.0, debug=False)
    s_r, ring_r, last_r = run(fc.generate_fused_reference, STATE_T, 0, 0.0,
                              debug=False)
    rows = [r for r in range(b) if torch.equal(s_k[r], s_r[r])]
    check(len(rows) >= b // 2, f"only rows {rows} agree over {STATE_T} greedy steps")
    ring_err = float((ring_k[:, rows].float() - ring_r[:, rows].float()).abs().max())
    ring_max = float(ring_r[:, rows].float().abs().max())
    check(torch.equal(last_k[rows], last_r[rows]), "last ids differ")
    check(ring_err <= RING_REL_TOL * ring_max,
          f"rings differ: {ring_err:.4g} of max {ring_max:.4g}")
    print(f"[kernel] state after {STATE_T} greedy steps, rows {rows}: last ids equal, "
          f"rings max|d| {ring_err:.4g} of max {ring_max:.4g} (tol {RING_REL_TOL}) "
          f"| {card}")

    # chunk carry: 64 + 64 steps == 128 steps
    half = GREEDY_T // 2
    a, ring_a, last_a = fc.generate_fused(packed, wcfg, flat.clone(), state.prev_id,
                                          state.t, gcond[..., :half], 0, 0.0)
    c, _, _ = fc.generate_fused(packed, wcfg, ring_a, last_a, state.t + half,
                                gcond[..., half:GREEDY_T], 0, 0.0)
    check(torch.equal(torch.cat([a, c], 1), ids_k), "chunked ids differ from one call")
    print(f"[kernel] chunk carry {half}+{half} == {GREEDY_T}: ok | {card}")

    # sampling at T = 1: randomized PIT passes KS at false-failure rate alpha
    ids_s, _, _, lg_s = run(fc.generate_fused, SAMPLE_T, 1234, 1.0)
    d, n = pit_ks(ids_s, lg_s)
    eps = math.sqrt(math.log(2.0 / KS_ALPHA) / (2.0 * n))  # DKW bound
    other = run(fc.generate_fused, SAMPLE_T, 4321, 1.0, debug=False)[0]
    check(n >= 16384 and d < eps, f"sampled ids fail KS: D={d:.4g} >= {eps:.4g}")
    check(not torch.equal(other, ids_s), "two seeds gave the same ids")
    check(int(ids_s.min()) >= 0 and int(ids_s.max()) < wcfg.n_quant, "ids out of range")
    print(f"[kernel] sampling T=1: {n} draws, max|logits| "
          f"{float(lg_s.abs().max()):.4g}, KS D={d:.4g} < {eps:.4g} "
          f"(alpha {KS_ALPHA}); seeds 1234/4321 differ | {card}")

    # time per generated step, kernel vs plain, on a random ring
    times = {}
    for bb in (1, 8, BATCH):
        ring = torch.randn(rf, bb, wcfg.n_res, generator=gen).to(dev, torch.bfloat16)
        prev = torch.randint(0, wcfg.n_quant, (bb,), generator=gen).to(dev)
        cnd = (torch.randn(bb, n_cond, GREEDY_T, generator=gen) * 0.3).to(dev)

        def call(fn):
            return lambda: fn(packed, wcfg, ring, prev, 0, cnd, 5, 1.0)

        k_ms = cuda_ms(call(fc.generate_fused), 3) / GREEDY_T
        p_ms = cuda_ms(call(fc.generate_fused_reference), 1) / GREEDY_T
        times[bb] = (k_ms, p_ms)
        print(f"[kernel] B={bb}: kernel {k_ms:.4f} ms/step, plain {p_ms:.4f} ms/step "
              f"({bb / k_ms * 1e3:.0f} vs {bb / p_ms * 1e3:.0f} samples/s) | {card}")
    return {"max_abs_err": max_abs, "ms": times[BATCH][0],
            "plain_ms": times[BATCH][1]}


def phase_serve(card: str, dev, tmp: str) -> dict:
    import numpy as np
    import torch

    from ae_wavenet_tpu_torch.cli import generate as cli
    from ae_wavenet_tpu_torch.data.dataset import PackedDataset, make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.ops import fastgen_cuda as fc
    from ae_wavenet_tpu_torch.training.weights import save_export
    from ae_wavenet_tpu_torch.utils.config import chorowski_config
    from ae_wavenet_tpu_torch.utils.wavio import read_wav

    cfg = chorowski_config()
    data, ckpt, out = (os.path.join(tmp, n) for n in ("synth", "model.pt", "out.wav"))
    t0 = time.perf_counter()
    make_synthetic_dataset(data, n_clips=BATCH, n_speakers=8,
                           clip_len=(12400, 14000), seed=0)
    save_export(ckpt, ae.init(cfg, torch.Generator().manual_seed(1)), cfg, 0)
    print(f"[serve] fixture: {BATCH} synthetic clips + chorowski checkpoint in "
          f"{time.perf_counter() - t0:.1f} s | {card}")

    fc.generate_fused.launches = 0
    fc.generate_fused_reference.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--ckpt", ckpt, "--data", data, "--clip", "0",
                       "--n-samples", str(CLI_SAMPLES), "--temperature", "1.0",
                       "--device", str(dev), "--out", out])
    k1, p1 = fc.generate_fused.launches, fc.generate_fused_reference.launches
    text = buf.getvalue()
    check(rc == 0, f"generate CLI returned {rc}")
    wav, sr = read_wav(out)
    check(len(wav) == CLI_SAMPLES and sr == cfg.spec.sample_rate, "wrong wav written")
    m = re.search(r"encode ([\d.]+) s, prime ([\d.]+) s, generate ([\d.]+) s", text)
    check(m is not None, f"CLI printed no timings:\n{text}")
    enc1, pr1, gen1 = map(float, m.groups())
    print(f"[serve] CLI B=1: {CLI_SAMPLES} samples, encode {enc1:.3f} s, prime "
          f"{pr1:.3f} s, generate {gen1:.3f} s -> {CLI_SAMPLES / gen1:.0f} samples/s "
          f"(RTF {CLI_SAMPLES / gen1 / 16000:.3f} at 16 kHz) | {card}")

    ds = PackedDataset(data)
    wav64 = np.stack([ds.clip(i, BATCH_WAV_LEN) for i in range(BATCH)])
    spk = torch.from_numpy(ds.speakers[:BATCH].astype(np.int64)).to(dev)
    model = ae.init(cfg, torch.Generator().manual_seed(1), dev).eval()
    timings: dict = {}
    ids, start = ae.reconstruct(model, cfg, torch.from_numpy(wav64).to(dev), spk,
                                torch.Generator().manual_seed(2), temperature=1.0,
                                n_samples=BATCH_SAMPLES, timings=timings)
    torch.cuda.synchronize()
    k64 = fc.generate_fused.launches - k1
    p64 = fc.generate_fused_reference.launches - p1
    check(tuple(ids.shape) == (BATCH, BATCH_SAMPLES), f"ids shape {tuple(ids.shape)}")
    check(int(ids.min()) >= 0 and int(ids.max()) < cfg.wavenet.n_quant,
          "ids out of range")
    gen64 = timings["generate"]
    print(f"[serve] reconstruct B={BATCH}: {BATCH_SAMPLES} samples/stream from "
          f"{BATCH_WAV_LEN}-sample clips (start {start}), encode "
          f"{timings['encode']:.3f} s, prime {timings['prime']:.3f} s, generate "
          f"{gen64:.3f} s -> {BATCH_SAMPLES / gen64:.0f} samples/s per stream, "
          f"{BATCH * BATCH_SAMPLES / gen64:.0f} aggregate | {card}")
    check(k1 >= 1 and k64 >= 1, f"kernel launches: CLI {k1}, batch {k64}")
    check(p1 == 0 and p64 == 0, f"plain version ran: CLI {p1}, batch {p64}")
    print(f"[serve] kernel launches: CLI {k1}, batch {k64}; plain version "
          f"launches: {p1 + p64} | {card}")
    return {"launches": k1 + k64}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card)  # exactly as nvidia-smi reports name and power limit
    dev = torch.device("cuda", 0)
    phase_env(card)
    phase_build(card)
    k = phase_kernel(card, dev)
    with tempfile.TemporaryDirectory() as tmp:
        s = phase_serve(card, dev, tmp)
    print(json.dumps({"kernels": [{
        "name": "fastgen_bf16", "route": "cuda",
        "source": "ae_wavenet_tpu_torch/csrc/fastgen.cu",
        "replaces": "ae_wavenet_tpu/ops/fastgen_pallas.py:612",
        "launches": s["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
