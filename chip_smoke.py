#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and no network.  Phases, each
printing its own line(s), every measurement beside the card's name and
power limit:

1. environment: torch, CUDA, nvcc, triton, the card;
2. build: compiles ae_wavenet_tpu_torch/csrc/*.cu from this checkout and
   prints every kernel's registers, spills and stack from the ptxas report
   (every kernel of the Hopper tile core, the whole-stack, group and
   recompute-mode kernels among them, must be listed, and none of them nor
   the sampler's may spill; no WMMA kernel is left);
3. the fused sampler kernels (one cooperative grid, each block's column
   share of the weights resident in shared memory; the plan's block count
   and resident bytes printed) against their plain PyTorch versions at the
   full width of the ``chorowski`` preset (seeded random weights, rings
   primed on 2047 context ids, B = 8): greedy ids and logits (each row held
   to the better of the plain version's runs alone and in the batch, which
   sum in different orders), each row alone giving the kernel's bits in the
   batch (and three faults planted in
   the plain version, which the same check must reject:
   a layer's skip dropped, the ring slot off by one, and one block's share
   of one layer shifted by a column), rings and last ids, chunk carry, the
   sampling distribution; the same for the int8 and int4 kernels at B = 1
   (the CLI's request), B = 8 (one tile), B = 64 and B = 136 (past the
   120 rows the earlier cluster design could take; 136 more primed rows),
   their first-step logits against the bf16 kernel's at every batch, and
   more planted faults (the int4 zero-point correction dropped, at B = 1, 8
   and 64; the scale taken per 8 rows, at B = 136); every version's time
   per step at B = 1, 8, 64 beside its bound and PR 5's time (at B = 1 also
   in one launch of the CLI request's 4,000 steps), and the kernel's own
   clock split of a step into grid barriers, GEMMs and the rest, with the SM
   clock it ran at;
4. the fused VQ lookup kernel against its plain version at the N of the
   serving request and of the training step: codes (differing rows must be
   near-ties), the looked-up rows bit for bit, exact counts, sums, the same
   bits on a second launch, and a planted fault (|e|^2 dropped); one kernel
   per call with and without the statistics (torch.profiler), and its time
   three ways: CUDA events around a loop of wrapper calls, the kernel's
   device time (profiler) and the wrapper's host time per call;
5. serving: the generate CLI on one clip (B = 1) of a synthetic dataset from
   an export-format checkpoint, then ``reconstruct`` on a batch of 64 clips,
   then the CLI with ``--int8`` and with ``--int4`` on a checkpoint whose
   config has ``vq_use_pallas=True``; the launch counters are set to 0
   before each run and show which kernels it went through;
6. train-kernels: the six gated-stack kernels (``csrc/gated.cu``: one
   layer, a pair, the whole stack forward; one layer in both modes, a pair,
   a group of layers backward; all on the Hopper core) against their plain
   versions at the full ``chorowski``
   width (seeded random weights, every bias perturbed), each output, at
   B = 2 with 4,100 loss samples (a ragged last tile) and again at the
   training path's shape (B = 4, n_win = 48,000), where both are also
   timed, each beside its bound and its share of it (the pair kernels also
   beside their bytes bound and a cuBLAS yardstick of their products alone;
   the single-layer backward in both modes, saved y and recompute); the
   pair backward's, the whole-stack forward's and the grouped backward's
   bits on a second launch; the whole stack
   through ``GatedStack`` in seven schedules (logits and every gradient);
   seven faults planted in the plain versions, which the same checks must
   reject (among them the pair forward's and the pair backward's layer 2
   prev tap one row off, and b_in dropped from the recompute mode's y, at
   both shapes); the stack's forward and backward timed under pairs, full fusion,
   and full fusion with groups of 5;
7. train: the train CLI at B = 4, n_win = 48,000.  ``new --preset chorowski
   --pallas-stack`` for 4 steps and ``resume`` for 2 more (the main path:
   pairs, saved y); 4 steps of the single-layer schedule
   (``--no-gated-fuse-pairs --no-gated-save-y``, the first step's loss beside
   the main path's); 3 steps with
   ``--vq-use-pallas`` (the fused VQ lookup once per step, the first step's
   loss equal to the run without it); then the whole-stack path,
   ``--gated-full-fusion --gated-bwd-group 5 --ckpt-keep 2 --ckpt-every 2
   --eval-every 2`` for 4 steps and ``resume`` for 2 (one forward launch per
   step and per eval batch, four grouped backward launches per step, the
   first step's loss beside the main path's, the checkpoints that retention
   leaves), 2 steps of ``--gated-full-fusion`` alone (pair backward), and 2
   steps of the main path and 2 of the whole-stack path under
   ``--profile-steps 2`` (device-busy share, device time by kernel name).  The
   launch counters are set to 0 before each run and read after it: every
   gated kernel (the single-layer backward's recompute mode counted apart)
   must have launched exactly as its path says and no plain version at all.
   Median step time, samples/s and peak memory of each path (the
   single-layer path's beside the other three), each
   whole-stack schedule's step beside the pairs step of the same run, and
   the step's time split from CUDA events around its parts in 3 steps of
   one ``Chassis`` run, for the main and the whole-stack path;
8. eval: ``cli/eval.py --quality`` on the checkpoint that run wrote;
9. inverter: ``python -m ae_wavenet_tpu_torch.cli.preprocess --synthetic``
   writes the reference's v2 fixture (8 clips); the train CLI runs ``new
   --preset chorowski --model mfcc_inverter --pallas-stack --frame-norm
   dataset`` at B = 4, n_win = 48,000 for 4 steps and ``resume`` for 2 (10
   pair forwards and 10 pair backwards a step, no other kernel; the
   dataset statistics in the checkpoint's config; median step, samples/s,
   peak memory and MFU from ``utils/flops.py``); then the generate CLI
   vocodes 4,000 samples of one clip in bf16, ``--int8`` and ``--int4``,
   one sampler launch each, and ``cli/eval.py --quality`` scores the
   checkpoint;
10. gate: the reference's int8 quality gate
   (``eval/quality.quantized_quality_gate``): 300 training steps of the
   flagship dims (VQ, fused stack, B = 4, n_win = 8,000) on its v2 fixture,
   16,384 free-running samples of a held-out clip in bf16, int8 and int4,
   log-mel distances to the source; d8 <= 1.20 d16 + 0.15 or the smoke
   fails.  Phase 7 also prints the main path's MFU.

``python3 chip_smoke.py --kernel-times`` builds the kernels and only times
the VQ lookup (phase 4's numbers) and the single-layer backward's recompute
mode (phase 6's), with no checks: run from an unpacked older commit with
this file beside it, it times that commit's kernels in the same call.

Then one JSON line describing the ten kernels (each with its launches on
its paths, phases 9 and 10 included, its error against the plain version,
its time beside the plain version's and the card's bound for the same
work; the single-layer
backward's row carries its recompute mode's numbers beside it), and as the
last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
SAMPLE_T = 2048         # steps of the sampling test at B = 8
MIN_DRAWS = 8 * SAMPLE_T  # draws of a sampling test, at any batch
CLI_SAMPLES = 4000      # B = 1 request
BATCH = 64              # batched request
Q_BIG_BATCH = 136       # past the earlier cluster design's 120-row bound
# ms per generated step of the earlier (cluster) design at B = 1 / 8 / 64,
# PERF.md (NVIDIA H100 80GB HBM3, 700 W)
PR5_MS = {"bf16": (0.3205, 0.3342, 0.3760), "int8": (0.2698, 0.2831, 0.3562),
          "int4": (0.2532, 0.2640, 0.3353)}
BATCH_SAMPLES = 2000
BATCH_WAV_LEN = 10200   # chorowski: cond frames for 2000 samples after rf
STACK_B, STACK_T = 2, 4100       # phase 5 checks: 4100 = 64 * 64 + 4 (ragged)
TRAIN_B, TRAIN_WIN = 4, 48000    # the training path's shape
TRAIN_STEPS, RESUME_STEPS = 4, 2
GROUP = 5               # layers per grouped backward on the whole-stack path
EVAL_EVERY, CKPT_KEEP = 2, 2   # on the whole-stack path
LOSS_TOL = 0.02         # first-step loss, whole-stack path vs main path
Q_LOGIT_REL_TOL = 0.01  # int8/int4 kernel vs plain: exact integer sums on both sides
Q_VS_BF16_TOL = {"int8": 0.10, "int4": 0.40}  # tests_tpu/test_pallas_tpu.py:241-269
PLAIN_T = 32            # steps of the plain versions' timing
VQ_SUM_REL_TOL = 1e-4   # f32 sums of up to N rows taken in another order
VQ_TIE_REL_GAP = 1e-5   # a differing code must be this near a tie
VQ_TRAIN_STEPS = 3
EVAL_SAMPLES, EVAL_BATCHES = 1000, 2
INV_CLIPS = 8           # phase 9: the reference's v2 fixture, from the CLI
# NVIDIA H100 SXM data sheet: dense peaks and the memory rate
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# and its shared memory: 132 SMs, each reading 128 bytes a clock at the
# 1.98 GHz boost clock
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
# every kernel of the Hopper tile core, as the ptxas report names them
# (wg_bwd_kernel<NL, REC>: K2b saved y, K2, K2b's recompute mode)
HOPPER_KERNELS = ("wg_fwd_kernel<1>", "wg_fwd_kernel<2>", "wg_bwd_kernel<1, false>",
                  "wg_bwd_kernel<2, false>", "wg_bwd_kernel<1, true>", "wg_dw_kernel",
                  "wg_stack_kernel", "wg_group_kernel")
VQ_TIMING_REPS = 20
GATED = {  # wrapper -> the Pallas kernel it replaces
    "gated_pair_fused": "ae_wavenet_tpu/ops/gated_pallas.py:217",
    "gated_layer_fused": "ae_wavenet_tpu/ops/gated_pallas.py:105",
    "gated_pair_bwd": "ae_wavenet_tpu/ops/gated_pallas.py:859",
    "gated_layer_bwd": "ae_wavenet_tpu/ops/gated_pallas.py:643",
    "gated_stack_fused": "ae_wavenet_tpu/ops/gated_pallas.py:355",
    "gated_group_bwd": "ae_wavenet_tpu/ops/gated_pallas.py:1095",
}


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


def bound(n_bytes: float, ops: dict) -> tuple[float, str]:
    """The least milliseconds the card could take: the bytes moved once over
    the memory rate, or the operations ({type: count}) over the card's peak
    for their type, whichever is larger; and which of the two."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sampler_bound(packed, wcfg, plan, batch: int, mode) -> tuple[float, str]:
    """Bound of one generated step, the largest of three times.  Shared
    memory: every step needs every layer and post-net weight at the SMs (the
    AR dependency allows no reuse across steps), and the fastest place they
    can come from is shared memory, where the plan keeps the post-net, the
    biases and scales and its resident layers: those bytes, with one
    embedding row per batch row, at the card's aggregate shared-memory rate.
    Memory: the layers the plan leaves in global memory, and per batch row
    one ring slot per layer read and written, one cond column, the id
    written and the activations the blocks exchange (x_prev | x and h per
    layer, relu(skip), the P1 output), each written once and read once, at
    the memory rate.  Operations: the layer and post-net products at the
    peak of their type."""
    n_cond = wcfg.n_lc_out + wcfg.n_global_embed
    n_layers = len(wcfg.dilations)
    size = {n: v.numel() * v.element_size() for n, v in packed._asdict().items()}
    layers = sum(v for n, v in size.items() if n.startswith(("w_in", "w_out")))
    streamed = layers * (n_layers - plan.resident_layers) // n_layers
    resident = sum(v for n, v in size.items() if n != "embed") - streamed
    h_bytes = 2 if mode is None else 4
    exchanged = 2 * (n_layers * (4 * wcfg.n_res + h_bytes * wcfg.n_dil)
                     + 2 * wcfg.n_skp + 2 * wcfg.n_post)
    per_row = 2 * n_layers * 2 * wcfg.n_res + 2 * n_cond + 4 + exchanged
    t_smem = (resident + batch * 2 * wcfg.n_res) / SMEM_BYTES_PER_S
    t_mem = (streamed + batch * per_row) / HBM_BYTES_PER_S
    layer_ops = 2 * batch * n_layers * ((2 * wcfg.n_res + n_cond) * 2 * wcfg.n_dil
                                        + wcfg.n_dil * (wcfg.n_res + wcfg.n_skp))
    post_ops = 2 * batch * (wcfg.n_skp * wcfg.n_post + wcfg.n_post * wcfg.n_quant)
    ops = {"bf16": post_ops, "int8": layer_ops} if mode else {"bf16": layer_ops + post_ops}
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    t_bytes = max(t_smem, t_mem)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def tensor_bytes(*trees) -> int:
    """Bytes of every distinct tensor in the (nested) arguments."""
    import torch

    seen = {}

    def walk(v):
        if isinstance(v, torch.Tensor):
            seen[(v.data_ptr(), v.numel())] = v.numel() * v.element_size()
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            walk(list(v.values()))
    walk(trees)
    return sum(seen.values())


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


def ptxas_kernels(log: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes, stack bytes)}
    from an ``nvcc -Xptxas -v`` report, kernels named by their mangled
    identifier's readable part."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = re.search(r"'([^']+)'", ln).group(1)
            m = re.search(r"\d+((?:wg|gated|fastgen|vq)_\w+?)(I((?:L[ib]\d+E)+)E)?E", name)
            cur = name
            if m:
                args = [v if t == "i" else ("true" if v == "1" else "false")
                        for t, v in re.findall(r"L([ib])(\d+)E", m.group(3) or "")]
                cur = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            out[cur] = [0, 0, 0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur][1], out[cur][2], out[cur][3] = int(m[2]), int(m[3]), int(m[1])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur][0] = int(m[1])
    return {k: tuple(v) for k, v in out.items()}


def phase_build(card: str) -> None:
    from ae_wavenet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[build] {secs:.2f} s (nvcc {_build.build_info.get('seconds', 0.0):.2f} s)"
          f" {_build.build_info['path']} | {card}")
    kernels = ptxas_kernels(_build.build_info.get("ptxas", ""))
    for name, (regs, st, ld, stack) in sorted(kernels.items()):
        note = (" (ptxas's cap at 384 threads a block; setmaxnreg moves the producer"
                " warpgroup's share to the two consumer warpgroups at run time)"
                if name.startswith("wg_") else "")
        print(f"[build] ptxas {name}: {regs} registers{note}, spill stores {st} B, spill "
              f"loads {ld} B, stack {stack} B | {card}")
    hopper = [k for k in kernels if k.startswith("wg_")]
    check(set(HOPPER_KERNELS) <= set(hopper),
          f"ptxas report lists the Hopper kernels {hopper}, not all of {HOPPER_KERNELS}")
    sampler = [k for k in kernels if k.startswith("fastgen_kernel")]
    check(len(sampler) == 3, f"ptxas report lists the sampler kernels {sampler}")
    # one tile core: the first (WMMA) core's kernel and header are gone
    src = (_build.CSRC / "gated.cu").read_text()
    check(not [k for k in kernels if k.startswith("gated_bwd_recompute")]
          and "wmma" not in src and "mma.h" not in src,
          "the first core (WMMA, gated_bwd_recompute_kernel) is still built")
    check(all(kernels[k][1] == kernels[k][2] == 0 for k in hopper + sampler),
          f"a Hopper or sampler kernel spills: "
          f"{[(k, kernels[k]) for k in hopper + sampler]}")


@contextlib.contextmanager
def f32_numerics():
    """TF32 off for this phase's f32 plain versions, restored after."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def phase_kernel(card: str, dev) -> dict:
    with f32_numerics():
        return _phase_kernel(card, dev)


def _phase_kernel(card: str, dev) -> dict:
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
    plans = {m: fc.device_plan(wcfg, m, dev) for m in (None, "int8", "int4")}
    for m, pl in plans.items():
        print(f"[kernel] share plan {m or 'bf16'}: {pl.n_blocks} blocks, columns "
              f"{[pl.n_cols(n, 0) for n in fc.SHARES]} ({'/'.join(fc.SHARES)}) of "
              f"block 0, {pl.resident_bytes} B of weights resident per block "
              f"({pl.resident_layers} of {len(wcfg.dilations)} layers + post-net), "
              f"{pl.smem_bytes} B of shared memory | {card}")

    def primed(n_rows):
        ctx = torch.randint(0, wcfg.n_quant, (n_rows, rf + 1), generator=gen).to(dev)
        cond = (torch.randn(n_rows, wcfg.n_lc_out, rf, generator=gen) * 0.3).to(dev)
        spk = torch.randint(0, wcfg.n_speakers, (n_rows,), generator=gen).to(dev)
        t0 = time.perf_counter()
        st = fg.prime(model.wavenet, wcfg, fg.init_state(wcfg, n_rows, device=dev),
                      ctx, cond, spk)
        torch.cuda.synchronize()
        print(f"[kernel] primed B={n_rows} on {rf + 1} context ids in "
              f"{time.perf_counter() - t0:.2f} s | {card}")
        return st

    state = primed(b)
    flat, prev = fc.state_to_flat(state, wcfg), state.prev_id
    gcond = (torch.randn(b, n_cond, SAMPLE_T, generator=gen) * 0.3).to(dev)

    def run(fn, t_len, seed, temperature, debug=True, ring=flat, t0=state.t,
            prev=prev):
        return fn(packed, wcfg, ring.clone(), prev, t0, gcond[..., :t_len],
                  seed, temperature, debug)

    # greedy: ids over each row's inclusive agreeing prefix, logits there
    ids_k, _, _, lg_k = run(fc.generate_fused, GREEDY_T, 0, 0.0)
    ids_r, _, _, lg_r = run(fc.generate_fused_reference, GREEDY_T, 0, 0.0)
    torch.cuda.synchronize()
    scale = float(lg_r.abs().max())
    agree_b, _ = compare(ids_k, lg_k, ids_r, lg_r)
    check(bool(torch.isfinite(lg_k).all()), "non-finite kernel logits")
    # each row alone (B = 1): the kernel gives the same bits as in the batch;
    # the plain version does not (cuBLAS sums in another order at 1 row than
    # at 8), so each row is held to the better of the plain version's two
    # runs, alone and in the batch
    agree, agree_a, max_abs = [], [], 0.0
    for r in range(b):
        ring1, prev1 = flat[:, r:r + 1].contiguous(), prev[r:r + 1].contiguous()
        cond1 = gcond[r:r + 1, :, :GREEDY_T].contiguous()
        k1 = fc.generate_fused(packed, wcfg, ring1.clone(), prev1, state.t, cond1, 0,
                               0.0, True)
        check(torch.equal(k1[0][0], ids_k[r]) and torch.equal(k1[3][:, 0], lg_k[:, r]),
              f"kernel row {r} alone differs from the same row in the batch")
        r1 = fc.generate_fused_reference(packed, wcfg, ring1.clone(), prev1, state.t,
                                         cond1, 0, 0.0, True)
        runs = [compare(ids_k[r:r + 1], lg_k[:, r:r + 1], ids, lg)
                for ids, lg in ((ids_r[r:r + 1], lg_r[:, r:r + 1]), (r1[0], r1[3]))]
        agree_a.append(runs[1][0][0])
        (a_best,), m_best = max(runs, key=lambda c: c[0][0])
        agree.append(a_best)
        max_abs = max(max_abs, m_best)
    check(passes(agree, max_abs / scale),
          f"greedy kernel vs plain: prefixes {agree} (in the batch {agree_b}, alone "
          f"{agree_a}), logits {max_abs / scale:.4g} of max|logits| (need prefixes >= "
          f"{MIN_PREFIX}, < {LOGIT_REL_TOL})")
    print(f"[kernel] greedy T={GREEDY_T} B={b}: each row alone gives the kernel's "
          f"bits in the batch | {card}")
    print(f"[kernel] greedy T={GREEDY_T} B={b}: ids agree with the plain version in "
          f"the batch for {agree_b} steps, alone for {agree_a}; the better of the two "
          f"{agree} (each >= {MIN_PREFIX}), logits max|d| {max_abs:.4g} = "
          f"{max_abs / scale:.4g} of max|logits| {scale:.4g} (tol {LOGIT_REL_TOL}) "
          f"| {card}")

    # the same check on planted faults of the plain version must fail
    l_bad = len(wcfg.dilations) // 2
    w_out, b_out = packed.w_out.clone(), packed.b_out.clone()
    w_out[l_bad, :, wcfg.n_res:] = 0
    b_out[l_bad, wcfg.n_res:] = 0
    # one block's share of one layer shifted by a column: block r_bad reads
    # each of its columns of layer 0 one column to the right (the shares
    # differ in its row only)
    plan, r_bad = plans[None], plans[None].n_blocks // 3
    s_in, s_out = packed.w_in.clone(), packed.w_out.clone()
    for name, w in (("filter", s_in), ("gate", s_in), ("res", s_out), ("skip", s_out)):
        lo, hi = plan.cols(name, r_bad)
        w[0, :, lo:hi] = w[0, :, lo + 1:hi + 1].clone()
    shifted = packed._replace(w_in=s_in, w_out=s_out)
    rows_differ = (fc.pack_shares(shifted, plan) != fc.pack_shares(packed, plan)).any(1)
    check(rows_differ.nonzero().flatten().tolist() == [r_bad],
          f"the shifted share differs in blocks {rows_differ.nonzero().flatten().tolist()}")
    faults = {f"layer {l_bad} skip dropped": (packed._replace(w_out=w_out, b_out=b_out),
                                              state.t),
              "ring slot off by one": (packed, state.t + 1),
              f"block {r_bad}'s layer 0 share shifted by a column": (shifted, state.t)}
    for name, (pk, t_f) in faults.items():
        ids_f, _, _, lg_f = fc.generate_fused_reference(
            pk, wcfg, flat.clone(), prev, t_f, gcond[..., :GREEDY_T], 0,
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
    a, ring_a, last_a = fc.generate_fused(packed, wcfg, flat.clone(), prev,
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
    check(n >= MIN_DRAWS and d < eps, f"sampled ids fail KS: D={d:.4g} >= {eps:.4g}")
    check(not torch.equal(other, ids_s), "two seeds gave the same ids")
    check(int(ids_s.min()) >= 0 and int(ids_s.max()) < wcfg.n_quant, "ids out of range")
    print(f"[kernel] sampling T=1: {n} draws, max|logits| "
          f"{float(lg_s.abs().max()):.4g}, KS D={d:.4g} < {eps:.4g} "
          f"(alpha {KS_ALPHA}); seeds 1234/4321 differ | {card}")

    out = {"bf16": {"max_abs_err": max_abs}}
    packs = {"bf16": packed, **{m: fc.PACKERS[m](model.wavenet, wcfg)
                                for m in ("int8", "int4")}}
    # the quantized kernels on primed states at the batch of the CLI's
    # request (one real row), of one 8-row tile, of the batched request and
    # past the earlier design's 120-row bound; each with cond for at least
    # MIN_DRAWS sampled draws
    state_all = primed(Q_BIG_BATCH)
    flat_all = fc.state_to_flat(state_all, wcfg)

    def draws(n_rows):
        return (torch.randn(n_rows, n_cond, -(-MIN_DRAWS // n_rows), generator=gen)
                * 0.3).to(dev)

    q_inputs = {1: (flat[:, :1].contiguous(), prev[:1].contiguous(), state.t, draws(1)),
                b: (flat, prev, state.t, gcond),
                BATCH: (flat_all[:, :BATCH].contiguous(),
                        state_all.prev_id[:BATCH].contiguous(), state_all.t,
                        draws(BATCH)),
                Q_BIG_BATCH: (flat_all, state_all.prev_id, state_all.t,
                              draws(Q_BIG_BATCH))}
    for mode in ("int8", "int4"):
        out[mode] = {"max_abs_err": _check_quantized(card, dev, fc, wcfg, mode,
                                                     packs, q_inputs)}

    # time per generated step, every kernel and every plain version, on a
    # random ring; all from this one call.  At B = 1 also one launch as long
    # as the CLI request's.  The SM clock is block 0's clock cycles over the
    # instrumented launch's time.
    for k, bb in enumerate((1, 8, BATCH)):
        t_len = max(GREEDY_T, CLI_SAMPLES if bb == 1 else 0)
        ring = torch.randn(rf, bb, wcfg.n_res, generator=gen).to(dev, torch.bfloat16)
        prev = torch.randint(0, wcfg.n_quant, (bb,), generator=gen).to(dev)
        cnd = (torch.randn(bb, n_cond, t_len, generator=gen) * 0.3).to(dev)
        for name, pk in packs.items():
            mode = None if name == "bf16" else name

            def gen_ms(steps, reps, clk=None):
                return cuda_ms(lambda: fc.generate_fused(
                    pk, wcfg, ring, prev, 0, cnd[..., :steps], 5, 1.0, quantized=mode,
                    clocks=clk), reps) / steps

            k_ms = gen_ms(GREEDY_T, 3)
            p_ms = cuda_ms(lambda: fc.generate_fused_reference(
                pk, wcfg, ring, prev, 0, cnd[..., :PLAIN_T], 5, 1.0, quantized=mode),
                1) / PLAIN_T
            b_ms, by = sampler_bound(pk, wcfg, plans[mode], bb, mode)
            print(f"[kernel] {name} B={bb}: kernel {k_ms:.4f} ms/step at T={GREEDY_T} "
                  f"a launch (PR 5's cluster design: {PR5_MS[name][k]}), plain "
                  f"{p_ms:.4f} ms/step ({bb / k_ms * 1e3:.0f} vs {bb / p_ms * 1e3:.0f} "
                  f"samples/s); bound {b_ms:.5f} ms/step by {by}, "
                  f"{100 * b_ms / k_ms:.2f}% of it | {card}")
            out[name].setdefault("by_batch", {})[bb] = {
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by}
            # where a step's time goes: block 0's clock cycles in all, in the
            # grid barriers (arrival to release) and in the layers' GEMMs
            for steps in sorted({GREEDY_T, t_len}):
                clk = torch.zeros(3, dtype=torch.int64, device=dev)
                c_ms = gen_ms(steps, 1, clk)
                total, bars, gemms = (v / steps for v in clk.tolist())
                check(0 < bars < total and 0 < gemms < total, f"{name} B={bb}: clock "
                      f"split {clk.tolist()}")
                print(f"[kernel] {name} B={bb} T={steps}: instrumented launch "
                      f"{c_ms:.4f} ms/step, SM clock {total / c_ms / 1e6:.3f} GHz; one "
                      f"step (block 0, clock cycles): {total:.0f} in all, {bars:.0f} "
                      f"({100 * bars / total:.1f}%) in {2 * len(wcfg.dilations) + 3} "
                      f"grid barriers, {gemms:.0f} ({100 * gemms / total:.1f}%) in the "
                      f"layers' GEMMs, {total - bars - gemms:.0f} in the rest | {card}")
            if t_len > GREEDY_T:
                l_ms = gen_ms(t_len, 1)
                out[name]["by_batch"][bb]["ms_cli_launch"] = l_ms
                print(f"[kernel] {name} B={bb}: kernel {l_ms:.4f} ms/step at T={t_len} "
                      f"a launch (the CLI request's) | {card}")
    return out


def _check_quantized(card: str, dev, fc, wcfg, mode: str, packs: dict,
                     inputs: dict) -> float:
    """The int8 or int4 kernel against its plain version at each batch of
    ``inputs`` ({B: (ring, prev, t0, cond)}): greedy ids and logits, state,
    chunk carry, sampling, its first-step logits against the bf16 kernel's,
    and planted faults.  -> the largest |logit difference| seen."""
    from unittest import mock

    import torch

    pk = packs[mode]

    def q_passes(agree, rel):
        return min(agree) >= MIN_PREFIX and rel < Q_LOGIT_REL_TOL

    def greedy(fn, ring, prev, t0, cnd, t_len=GREEDY_T, debug=True):
        return fn(pk, wcfg, ring.clone(), prev, t0, cnd[..., :t_len], 0, 0.0, debug,
                  mode)

    worst, kernel_runs = 0.0, {}
    for b, (ring, prev, t0, cnd) in inputs.items():
        ids_k, _, _, lg_k = greedy(fc.generate_fused, ring, prev, t0, cnd)
        ids_r, _, _, lg_r = greedy(fc.generate_fused_reference, ring, prev, t0, cnd)
        torch.cuda.synchronize()
        kernel_runs[b] = (ids_k, lg_k)
        scale = float(lg_r.abs().max())
        agree, max_abs = compare(ids_k, lg_k, ids_r, lg_r)
        worst = max(worst, max_abs)
        t_len = ids_k.shape[1]
        check(bool(torch.isfinite(lg_k).all()), f"{mode} B={b}: non-finite logits")
        check(q_passes(agree, max_abs / scale),
              f"{mode} B={b} greedy kernel vs plain: shortest prefix {min(agree)}, "
              f"logits {max_abs / scale:.4g} of max|logits| (need >= {MIN_PREFIX}, "
              f"< {Q_LOGIT_REL_TOL})")
        print(f"[kernel] {mode} greedy T={t_len} B={b}: ids agree for "
              f"{min(agree)}..{max(agree)} steps ({sum(a == t_len for a in agree)} of "
              f"{b} rows to the end), logits max|d| {max_abs:.4g} = "
              f"{max_abs / scale:.4g} of max|logits| {scale:.4g} (tol "
              f"{Q_LOGIT_REL_TOL}) | {card}")

        s_k, ring_k, last_k = greedy(fc.generate_fused, ring, prev, t0, cnd, STATE_T,
                                     False)
        s_r, ring_r, last_r = greedy(fc.generate_fused_reference, ring, prev, t0, cnd,
                                     STATE_T, False)
        rows = [r for r in range(b) if torch.equal(s_k[r], s_r[r])]
        check(len(rows) >= max(1, b // 2), f"{mode} B={b}: only {len(rows)} rows "
              f"agree over {STATE_T} greedy steps")
        ring_err = float((ring_k[:, rows].float() - ring_r[:, rows].float()).abs().max())
        ring_max = float(ring_r[:, rows].float().abs().max())
        check(torch.equal(last_k[rows], last_r[rows]), f"{mode} B={b}: last ids differ")
        check(ring_err <= RING_REL_TOL * ring_max,
              f"{mode} B={b}: rings differ: {ring_err:.4g} of max {ring_max:.4g}")

        half = t_len // 2
        a, ring_a, last_a = fc.generate_fused(pk, wcfg, ring.clone(), prev, t0,
                                              cnd[..., :half], 0, 0.0, quantized=mode)
        c, _, _ = fc.generate_fused(pk, wcfg, ring_a, last_a, t0 + half,
                                    cnd[..., half:t_len], 0, 0.0, quantized=mode)
        check(torch.equal(torch.cat([a, c], 1), ids_k),
              f"{mode} B={b}: chunked ids differ from one call")

        n_draw = cnd.shape[-1]
        ids_s, _, _, lg_s = fc.generate_fused(pk, wcfg, ring.clone(), prev, t0, cnd,
                                              1234, 1.0, True, mode)
        d, n = pit_ks(ids_s, lg_s)
        eps = math.sqrt(math.log(2.0 / KS_ALPHA) / (2.0 * n))
        check(n >= MIN_DRAWS and d < eps,
              f"{mode} B={b}: sampled ids fail KS: D={d:.4g} >= {eps:.4g} (n={n})")

        lg_b = fc.generate_fused(packs["bf16"], wcfg, ring.clone(), prev, t0,
                                 cnd[..., :1], 0, 0.0, True)[3]
        vs_bf16 = float((lg_k[0] - lg_b[0]).abs().max()) / float(lg_b.abs().max())
        check(vs_bf16 < Q_VS_BF16_TOL[mode],
              f"{mode} B={b}: first-step logits {vs_bf16:.4g} of max|logits| from the "
              f"bf16 kernel's (tol {Q_VS_BF16_TOL[mode]})")
        print(f"[kernel] {mode} B={b}: state after {STATE_T} steps ({len(rows)} rows): "
              f"last ids equal, rings max|d| {ring_err:.4g} of {ring_max:.4g}; chunk "
              f"carry {half}+{t_len - half} ok; sampling T=1 over {n_draw} steps: "
              f"{n} draws, KS D={d:.4g} < {eps:.4g}; first-step logits "
              f"{vs_bf16:.4g} of max|logits| from the bf16 kernel's (tol "
              f"{Q_VS_BF16_TOL[mode]}) | {card}")

    # the same check on planted faults of the plain version must fail
    def per_8_rows(v):
        m = v.abs().reshape(-1, 8, v.shape[1]).amax((1, 2))
        return (torch.clamp(m, min=1e-9) * (1.0 / 127.0)).repeat_interleave(8)[:, None]

    faults = [("scale taken per 8 rows, not over the batch", max(inputs),
               lambda: mock.patch.object(fc, "_tile_scale", per_8_rows))]
    if mode == "int4":
        faults += [("int4 zero-point correction dropped", b,
                    lambda: mock.patch.object(fc, "_ZERO_POINT", 0))
                   for b in inputs if b < max(inputs)]
    for name, b, patch in faults:
        ring, prev, t0, cnd = inputs[b]
        with patch():
            ids_f, _, _, lg_f = greedy(fc.generate_fused_reference, ring, prev, t0, cnd)
        ids_k, lg_k = kernel_runs[b]
        agree_f, abs_f = compare(ids_k, lg_k, ids_f, lg_f)
        rel_f = abs_f / float(lg_f.abs().max())
        check(not q_passes(agree_f, rel_f),
              f"planted fault '{name}' passes the {mode} kernel check")
        print(f"[kernel] {mode} B={b} planted fault '{name}' in the plain version: "
              f"shortest prefix {min(agree_f)}, logits {rel_f:.4g} of max|logits|: "
              f"rejected | {card}")
    return worst


def phase_vq(card: str, dev, data: str) -> dict:
    with f32_numerics():
        return _phase_vq(card, dev, data)


def vq_cases(dev, data: str) -> tuple:
    """(codebook, {label: latents}): a seeded ``chorowski`` model's codebook
    and its encoder's latents at the N of the serving request (clip 0 of
    ``data``) and of the training step (TRAIN_B windows)."""
    import torch

    from ae_wavenet_tpu_torch.audio import mfcc
    from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float
    from ae_wavenet_tpu_torch.data.dataset import PackedDataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.models.common import normalize_frames
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    cfg = chorowski_config()
    gen = torch.Generator().manual_seed(1)
    model = ae.init(cfg, gen, dev).eval()
    spec = ae.make_window_spec(cfg, TRAIN_WIN)
    clip = torch.from_numpy(PackedDataset(data).clip(0, 64000))[None].to(dev)
    windows = (torch.randn(TRAIN_B, spec.u_len, generator=gen) * 3000).to(
        dev, torch.int16)[..., spec.fb : spec.fe]

    def latents(wav_i16, n_ref):
        frames = mfcc.mfcc_delta_stack(int16_to_float(wav_i16), cfg.spec)
        with torch.no_grad():
            z = model.encoder(normalize_frames(frames, n_ref=n_ref, spec=cfg.spec))
        return z.permute(0, 2, 1).reshape(-1, z.shape[1]).contiguous()

    return model.bottleneck.codebook.detach(), {
        "serving request": latents(clip, ae.make_window_spec(cfg).n_frames),
        "training step": latents(windows, None)}


def device_ms(fn, reps: int) -> tuple[float, float, list]:
    """fn()'s kernels on the card from torch.profiler, over reps calls after
    a warm-up: (device ms per call summed over its kernels, kernels per
    call, their names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.end - e.time_range.start for e in ev)
    return us / 1e3 / reps, len(ev) / reps, sorted({e.name for e in ev})


def host_ms(fn, reps: int) -> float:
    """Host milliseconds per fn() call (what the caller's thread spends to
    enqueue it), the device synchronised before and after the loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def vq_times(z, e) -> dict:
    """The VQ lookup at these latents, with and without the statistics:
    CUDA events around a loop of wrapper calls (``ms``, as earlier PRs
    timed it), the kernels' device time and count per call (profiler) and
    the wrapper's host time per call."""
    from ae_wavenet_tpu_torch.ops import vq_cuda as vq

    out = {}
    for key, stats in (("", True), ("lean_", False)):
        fn = lambda: vq.vq_lookup_fused(z, e, stats=stats)  # noqa: E731
        dev_ms, per_call, names = device_ms(fn, VQ_TIMING_REPS)
        out.update({f"{key}ms": cuda_ms(fn, VQ_TIMING_REPS), f"{key}device_ms": dev_ms,
                    f"{key}kernels_per_call": per_call, f"{key}kernel_names": names,
                    f"{key}host_ms": host_ms(fn, VQ_TIMING_REPS)})
    return out


def vq_times_line(t: dict) -> str:
    return (f"events around {VQ_TIMING_REPS} calls {t['ms']:.4f} ms a call, device "
            f"{t['device_ms']:.4f} ms in {t['kernels_per_call']:g} kernel(s) "
            f"{t['kernel_names']}, wrapper (host) {t['host_ms']:.4f} ms; without the "
            f"statistics {t['lean_ms']:.4f} / {t['lean_device_ms']:.4f} ms in "
            f"{t['lean_kernels_per_call']:g} kernel(s) / {t['lean_host_ms']:.4f} ms")


def _phase_vq(card: str, dev, data: str) -> dict:
    """The fused VQ lookup against its plain version on the encoder's own
    latents (``vq_cases``)."""
    import torch

    from ae_wavenet_tpu_torch.ops import vq_cuda as vq

    e, cases = vq_cases(dev, data)

    def verdict(z, codes, plain_codes) -> list[str]:
        """Why ``codes`` do not agree with ``plain_codes`` (empty: they do):
        under 1% of rows may differ, each of them a near-tie."""
        differ = torch.nonzero(codes != plain_codes)[:, 0]
        why = []
        if len(differ) >= max(1, len(codes) // 100):
            why.append(f"{len(differ)} of {len(codes)} codes differ")
        zd, ed = z[differ[:64]].double(), e.double()
        d2 = ed.square().sum(1)[None] - 2.0 * zd @ ed.t()
        for i, r in enumerate(differ[:64].tolist()):
            gap = abs(float(d2[i, codes[r]] - d2[i, plain_codes[r]]))
            if gap > VQ_TIE_REL_GAP * float(d2[i].abs().max()):
                why.append(f"row {r}: codes {int(codes[r])} and {int(plain_codes[r])} "
                           f"are no tie (distance gap {gap:.3g})")
        return why

    out = {}
    for label, z in cases.items():
        n, (k, d) = z.shape[0], e.shape
        got = vq.vq_lookup_fused(z, e)
        again = vq.vq_lookup_fused(z, e)
        want = vq.vq_lookup_reference(z, e)
        torch.cuda.synchronize()
        codes = got[0].long()
        why = verdict(z, codes, want[0].long())
        check(not why, f"vq {label}: " + "; ".join(why))
        n_diff = int((codes != want[0].long()).sum())
        check(torch.equal(got[1], e[codes]), f"vq {label}: quant is not codebook[codes]")
        check(torch.equal(got[2], torch.bincount(codes, minlength=k).float())
              and float(got[2].sum()) == n, f"vq {label}: counts are not exact")
        sums = torch.zeros(k, d, dtype=torch.float64, device=dev).index_add_(
            0, codes, z.double())
        err = float((got[3].double() - sums).abs().max())
        scale = float(sums.abs().max())
        check(err <= VQ_SUM_REL_TOL * scale,
              f"vq {label}: sums {err:.4g} of max {scale:.4g}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"vq {label}: two launches gave different bits")
        # planted fault in the plain version: |e|^2 left out of the distances
        bad = verdict(z, codes, (-2.0 * (z @ e.t())).argmin(1))
        check(bool(bad), f"vq {label}: planted fault '|e|^2 dropped' passes")
        # what serving and eval call: codes and rows only
        lean = vq.vq_lookup_fused(z, e, stats=False)
        check(torch.equal(lean[0], got[0]) and torch.equal(lean[1], got[1])
              and lean[2] is None and lean[3] is None,
              f"vq {label}: the lookup without statistics differs")
        t = vq_times(z, e)
        check(t["kernels_per_call"] == 1 and t["lean_kernels_per_call"] == 1,
              f"vq {label}: {t['kernels_per_call']:g} kernels a call with the "
              f"statistics, {t['lean_kernels_per_call']:g} without; one launch each "
              f"expected ({t['kernel_names']})")
        p_ms = cuda_ms(lambda: vq.vq_lookup_reference(z, e), VQ_TIMING_REPS)
        b_ms, by = bound(tensor_bytes(z, e, got), {"f32": 2 * n * k * d})
        print(f"[vq] {label}: N={n} K={k} D={d}: {n_diff} codes differ from the plain "
              f"version (near-ties only), {len(torch.unique(codes))} codes in use, quant "
              f"== codebook[codes], counts exact (sum {n}), sums max|d| {err:.4g} of "
              f"{scale:.4g} (tol {VQ_SUM_REL_TOL}), same bits twice; planted fault "
              f"'|e|^2 dropped': {bad[0]}: rejected; without the statistics the same "
              f"codes and rows | {card}")
        print(f"[vq] {label}: N={n}: kernel: {vq_times_line(t)}; plain {p_ms:.4f} ms; "
              f"bound {b_ms:.6f} ms by {by} | {card}")
        out[label] = {"max_abs_err": err, "ms": t["ms"], "device_ms": t["device_ms"],
                      "host_ms": t["host_ms"], "plain_ms": p_ms, "bound_ms": b_ms,
                      "bound_by": by, "n": n}
    return out


def phase_serve(card: str, dev, data: str, tmp: str) -> dict:
    import numpy as np
    import torch

    from ae_wavenet_tpu_torch.cli import generate as cli
    from ae_wavenet_tpu_torch.data.dataset import PackedDataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.ops import fastgen_cuda as fc
    from ae_wavenet_tpu_torch.ops import vq_cuda as vq
    from ae_wavenet_tpu_torch.training.weights import save_export
    from ae_wavenet_tpu_torch.utils.config import chorowski_config
    from ae_wavenet_tpu_torch.utils.wavio import read_wav

    cfg = chorowski_config()
    ckpt, ckpt_vq, out = (os.path.join(tmp, n)
                          for n in ("model.pt", "model_vq.pt", "out.wav"))
    t0 = time.perf_counter()
    model0 = ae.init(cfg, torch.Generator().manual_seed(1), "cpu")
    save_export(ckpt, model0, cfg, 0)
    # the same weights under a config that asks for the fused VQ lookup
    cfg_vq = dataclasses.replace(cfg, bottleneck=dataclasses.replace(
        cfg.bottleneck, vq_use_pallas=True))
    save_export(ckpt_vq, model0, cfg_vq, 0)
    print(f"[serve] fixture: two chorowski checkpoints in "
          f"{time.perf_counter() - t0:.1f} s | {card}")

    def zero_counts():
        for f in (fc.generate_fused_reference, vq.vq_lookup_fused,
                  vq.vq_lookup_reference):
            f.launches = 0
        for name in ("launches", "launches_int8", "launches_int4"):
            setattr(fc.generate_fused, name, 0)

    def counts() -> dict:
        return {"bf16": fc.generate_fused.launches,
                "int8": fc.generate_fused.launches_int8,
                "int4": fc.generate_fused.launches_int4,
                "vq": vq.vq_lookup_fused.launches,
                "plain": fc.generate_fused_reference.launches
                + vq.vq_lookup_reference.launches}

    def run_cli(ckpt_path: str, *flags) -> tuple[dict, str]:
        """One request through the generate CLI with the counters set to 0
        just before and read just after: -> (launches, the timing line)."""
        zero_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--ckpt", ckpt_path, "--data", data, "--clip", "0",
                           "--n-samples", str(CLI_SAMPLES), "--temperature", "1.0",
                           "--device", str(dev), *flags, "--out", out])
        torch.cuda.synchronize()
        got = counts()
        text = buf.getvalue()
        check(rc == 0, f"generate CLI returned {rc}")
        wav, sr = read_wav(out)
        check(len(wav) == CLI_SAMPLES and sr == cfg.spec.sample_rate,
              "wrong wav written")
        check(len(set(wav.tolist())) > 16, "the written wav is (nearly) constant")
        m = re.search(r"encode ([\d.]+) s, prime ([\d.]+) s, generate ([\d.]+) s", text)
        check(m is not None, f"CLI printed no timings:\n{text}")
        enc, pr, gen_s = map(float, m.groups())
        label = " ".join(flags) or "bf16"
        line = (f"[serve] CLI B=1 {label}: {CLI_SAMPLES} samples, encode {enc:.3f} s, "
                f"prime {pr:.3f} s, generate {gen_s:.3f} s -> "
                f"{CLI_SAMPLES / gen_s:.0f} samples/s (RTF "
                f"{CLI_SAMPLES / gen_s / 16000:.3f} at 16 kHz); launches {got}")
        return got, line

    got1, line = run_cli(ckpt)
    print(f"{line} | {card}")
    k1, p1 = got1["bf16"], got1["plain"]
    check(got1 == {"bf16": 1, "int8": 0, "int4": 0, "vq": 0, "plain": 0},
          f"bf16 CLI launches {got1}")

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
    del model

    # quantized serving from the checkpoint that asks for the fused VQ lookup:
    # exactly one launch of the quantized sampler and one of the VQ kernel
    launches = {"bf16": k1 + k64, "vq": 0}
    for mode in ("int8", "int4"):
        got, line = run_cli(ckpt_vq, "--" + mode)
        want = {"bf16": 0, "int8": 0, "int4": 0, "vq": 1, "plain": 0, mode: 1}
        check(got == want, f"--{mode} CLI launches {got}, expected {want}")
        print(f"{line} | {card}")
        launches[mode] = got[mode]
        launches["vq"] += got["vq"]
    return {"launches": launches}


def cuda_s(fn) -> float:
    """Device seconds of one fn() call (CUDA events)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def gemm_yardstick(rows: int, r: int, c: int, d: int, s: int, backward: bool,
                   dev) -> float:
    """Milliseconds of cuBLAS (``torch.matmul`` in bf16) running the products
    of one gated layer pair alone, at the pair's shapes: per layer xin @ w_in
    and h @ w_out forward; g_out @ w_out^T, g_y @ w_in^T and the weight
    gradients xin^T g_y and h^T g_out backward.  A yardstick for the
    products, not the same function (no gate, residual, masks or bias
    sums); timed here only, the port never calls it."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    kp = 2 * r + c
    xin, w_in, h, w_out = rnd(rows, kp), rnd(kp, 2 * d), rnd(rows, d), rnd(d, r + s)
    prods = [(xin, w_in), (h, w_out)]
    if backward:
        g_out, g_y = rnd(rows, r + s), rnd(rows, 2 * d)
        prods = [(g_out, w_out.t()), (g_y, w_in.t()), (xin.t(), g_y), (h.t(), g_out)]

    def run():
        for _ in range(2):  # the pair's two layers
            for a, b in prods:
                torch.matmul(a, b)
    return cuda_ms(run, 3)


def phase_train_kernels(card: str, dev) -> dict:
    with f32_numerics():
        return _phase_train_kernels(card, dev)


def _phase_train_kernels(card: str, dev) -> dict:
    import torch

    from ae_wavenet_tpu_torch.ops import gated, gated_cuda as gc
    from ae_wavenet_tpu_torch.ops import gated_check as chk
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    wcfg = chorowski_config().wavenet
    wn, ids, cond, spk = chk.random_stack(wcfg, STACK_B, STACK_T, 0, dev)
    dils, _, cond_tm, packed, xs, ys, cot = chk.segment_inputs(wn, wcfg, ids, cond, spk)
    errs = {}
    calls = chk.segment_calls(dils, cond_tm, packed, xs, ys, cot)
    faults = {seg: (name, bad)
              for name, (seg, bad) in chk.planted_segment_faults().items()}
    def held(name, wrapper, call, got, x0, where) -> tuple[float, float, str]:
        """``got`` against the plain version (the whole-stack forward also
        layer by layer on its own streams): -> (max|d|, rel, a note)."""
        want = call(getattr(gated, wrapper + "_reference"))
        torch.cuda.synchronize()
        ab, rel = chk.compare_outputs(got, want)
        tol, note = chk.segment_tolerance(name), ""
        check(len(got) == len(want), f"{name}: {len(got)} outputs, plain {len(want)}")
        check(all(bool(torch.isfinite(g.float()).all()) for g in got),
              f"{name} {where}: non-finite kernel output")
        check(rel < tol, f"{name} vs plain {where}: {rel:.4g} of max|plain| (tol {tol})")
        if name == "gated_stack_fused":
            note = f" from x0 within {rel:.3g} (max|d| {ab:.4g}, tol {tol}: " \
                   f"rounding adds up over {len(dils)} layers)"
            ab, rel = chk.compare_outputs(
                got, chk.stack_layerwise(got, dils, cond_tm, packed, x0))
            tol = chk.SEGMENT_REL_TOL
            check(rel < tol, f"{name} layer by layer {where}: {rel:.4g} (tol {tol})")
            note += f", and layer by layer on its own streams within {rel:.3g}"
        return ab, rel, f"(max|d| {ab:.4g}, tol {tol})" + note

    for name, (wrapper, call) in calls.items():
        got = call(getattr(gc, wrapper))
        ab, rel, note = held(name, wrapper, call, got, xs[0], f"at B={STACK_B}")
        errs[wrapper] = max(errs.get(wrapper, 0.0), ab)
        print(f"[train-kernels] {name} B={STACK_B} t_in={xs[0].shape[1]}: "
              f"{len(got)} outputs within {rel:.3g} of max|plain| {note} | {card}")
        if name in faults:  # the same check on a planted fault must fail
            fault, bad = faults[name]
            _, rel_f = chk.compare_outputs(got, call(bad))
            check(rel_f >= chk.SEGMENT_REL_TOL, f"planted fault '{fault}' passes")
            print(f"[train-kernels] planted fault '{fault}' in the plain version: "
                  f"{rel_f:.4g} of max|plain|: rejected | {card}")
    del xs, ys, cot, calls

    probe = torch.randn(STACK_B, STACK_T, wcfg.n_quant,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    # (save_y, pairs, full_fusion, bwd_group)
    schedules = [(True, True, False, 0), (True, False, False, 0),
                 (False, True, False, 0), (False, False, False, 0),
                 (True, True, True, 0), (True, True, True, GROUP),
                 (True, True, False, GROUP)]
    refs = {}
    for save_y, pairs, fused, group in schedules:
        sched = dict(full_fusion=fused, bwd_group=group)
        lg_k, g_k = chk.stack_run(wn, wcfg, ids, cond, spk, probe, None,
                                  save_y, pairs, **sched)
        lg_p, g_p = chk.stack_run(wn, wcfg, ids, cond, spk, probe, gated.PLAIN,
                                  save_y, pairs, **sched)
        lg, rel = chk.stack_errors(lg_k, g_k, lg_p, g_p)
        label = (f"save_y={save_y} pairs={pairs} full_fusion={fused} "
                 f"bwd_group={group}")
        check(chk.stack_passes(lg, rel),
              f"stack {label}: logits {lg:.4g} (tol {chk.LOGIT_ABS_TOL}), grads "
              f"{rel:.4g} (tol {chk.GRAD_REL_TOL})")
        print(f"[train-kernels] GatedStack {label}: logits max|d| {lg:.4g} (tol "
              f"{chk.LOGIT_ABS_TOL}), {len(g_k)} gradients max|d| {rel:.4g} of "
              f"max|plain| (tol {chk.GRAD_REL_TOL}) | {card}")
        refs.setdefault(fused, (lg_k, g_k))  # the first run of each forward
    for name, (wn_bad, ops, sched) in chk.planted_faults(wn, wcfg).items():
        lg_f, g_f = chk.stack_run(wn_bad, wcfg, ids, cond, spk, probe, ops, True, True,
                                  **sched)
        lg, rel = chk.stack_errors(*refs[sched["full_fusion"]], lg_f, g_f)
        check(not chk.stack_passes(lg, rel), f"planted fault '{name}' passes")
        print(f"[train-kernels] planted fault '{name}' in the plain version: logits "
              f"{lg:.4g}, grads {rel:.4g}: rejected | {card}")
    del wn, ids, cond, spk, probe, refs

    # at the training path's shape: each kernel against its plain version
    # again (every block of the card at work, rows handed between blocks,
    # the full split-K), then both timed
    wn, ids, cond, spk = chk.random_stack(wcfg, TRAIN_B, TRAIN_WIN, 1, dev)
    dils, x0, cond_tm, packed, xs, ys, cot = chk.segment_inputs(wn, wcfg, ids, cond, spk)
    win_macs = (x0.shape[2] * 2 + cond_tm.shape[2]) * 2 * wcfg.n_dil
    macs = win_macs + wcfg.n_dil * (wcfg.n_res + wcfg.n_skp)  # per row and layer
    times, yardsticks = {}, {}
    for name, (wrapper, call) in chk.segment_calls(dils, cond_tm, packed, xs, ys,
                                                   cot).items():
        kern, plain = getattr(gc, wrapper), getattr(gated, wrapper + "_reference")
        got = call(kern)
        ab, rel, note = held(name, wrapper, call, got, x0, f"at B={TRAIN_B}")
        errs[wrapper] = max(errs[wrapper], ab)
        errs[name] = max(errs.get(name, 0.0), ab)
        timing = ""
        if name in faults:  # the planted fault fails the same check at this shape too
            fault, bad = faults[name]
            _, rel_f = chk.compare_outputs(got, call(bad))
            check(rel_f >= chk.SEGMENT_REL_TOL, f"planted fault '{fault}' passes at "
                  f"B={TRAIN_B}")
            timing += f"; planted fault '{fault}': {rel_f:.4g} of max|plain|, rejected"
        if name in ("gated_group_bwd", "gated_pair_bwd", "gated_stack_fused"):
            # one owner per output row, fixed-order sums: the same bits
            again = call(kern)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name}: two launches gave different bits")
            timing += "; same bits on a second launch"
            del again
        del got
        if name in (wrapper, "gated_layer_bwd_recompute"):  # the rest are variants
            # the case as PR 4 timed it (with the copies of the inputs that it
            # updates in place), the plain version likewise, then the wrapper
            # alone on one set of inputs (those it updates just accumulate)
            kc_ms = cuda_ms(lambda: call(kern), 3)
            p_ms = cuda_ms(lambda: call(plain), 1)
            moved = []

            def probe(*a, **kw):
                res = kern(*a, **kw)
                moved.append((a, kw, res))
                return res

            call(probe)
            k_ms = cuda_ms(lambda: kern(*moved[0][0], **moved[0][1]), 3)
            # the least work: the n_win loss rows of every batch row through
            # each layer's two GEMMs, once forward, twice backward (inputs
            # and weights); every operand read once, every output written once
            kw = moved[0][1]
            n_layers = (len(kw["dils"]) if "dils" in kw else len(kw["dds"])
                        if "dds" in kw else 2 if "pair" in wrapper else 1)
            ops = (2 * TRAIN_B * TRAIN_WIN * macs * n_layers
                   * (2 if "bwd" in wrapper else 1))
            if kw.get("y_saved", True) is None:  # and y = xin @ w_in recomputed
                ops += 2 * TRAIN_B * TRAIN_WIN * win_macs
            n_bytes = tensor_bytes(moved)
            b_ms, by = bound(n_bytes, {"bf16": ops})
            del moved
            times[name] = (k_ms, p_ms, b_ms, by)
            timing += (f"; {n_layers} layer(s): kernel {k_ms:.3f} ms ({kc_ms:.3f} with the "
                       f"case's input copies, as PR 4 timed it), plain {p_ms:.3f} ms, "
                       f"bound {b_ms:.3f} ms by {by}, {100 * b_ms / k_ms:.1f}% of the bound")
            if wrapper in ("gated_pair_fused", "gated_pair_bwd"):
                lo = kw["r0"] if "r0" in kw else kw["valid_lo1"]
                y_ms = gemm_yardstick(TRAIN_B * (x0.shape[1] - lo), x0.shape[2],
                                      cond_tm.shape[2], wcfg.n_dil, wcfg.n_skp,
                                      "bwd" in wrapper, dev)
                yardsticks[wrapper] = y_ms
                timing += (f"; operations bound {ops / PEAK['bf16'] * 1e3:.3f} ms, bytes "
                           f"bound {n_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms ("
                           f"{n_bytes / 1e9:.3f} GB); yardstick, the products alone in "
                           f"cuBLAS (torch.matmul, not the same function): {y_ms:.3f} ms")
        print(f"[train-kernels] {name} B={TRAIN_B} t_in={x0.shape[1]}: every output "
              f"within {rel:.3g} of max|plain| {note}{timing} | {card}")
    del xs, ys, cot
    # the whole stack under each schedule, the kernels' three in one call
    for label, ops, fused, group in (
            ("kernel, pairs", gated.kernel_ops(), False, 0),
            ("kernel, full fusion", gated.kernel_ops(), True, 0),
            (f"kernel, full fusion + groups of {GROUP}", gated.kernel_ops(), True, GROUP),
            ("plain, pairs", gated.PLAIN, False, 0)):
        sched = gated.Schedule(dils, True, True, ops, fused, group)
        out = {}
        fwd = cuda_s(lambda: out.update(r=gated.run_forward(sched, x0, cond_tm,
                                                            packed, True)))
        skip, xs_s, ys_s = out["r"]
        g_skip = torch.randn_like(skip) * 1e-3
        bwd = cuda_s(lambda: gated.run_backward(sched, g_skip, xs_s, ys_s, cond_tm,
                                                packed))
        del out, skip, xs_s, ys_s
        print(f"[train-kernels] stack {label} (saved y) B={TRAIN_B} t_in="
              f"{x0.shape[1]}: forward {fwd * 1e3:.1f} ms, backward "
              f"{bwd * 1e3:.1f} ms | {card}")
    return {"errs": errs, "times": times, "yardsticks": yardsticks}


def _run_cli(argv) -> list[dict]:
    """cli.train.main(argv) -> the JSON records it printed, one per line
    (stdout captured): the train records hold "loss", the eval records
    "eval_recon_ce", a profiled run's last one "profile"."""
    from ae_wavenet_tpu_torch.cli import train as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"train CLI returned {rc}")
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith('{"')]
    for r in recs:
        check(all(math.isfinite(v) for v in r.values() if isinstance(v, float)),
              f"non-finite metrics: {r}")
    return recs


def _path_run(argv, expect: dict, card: str, label: str):
    """One CLI run with every launch counter set to 0 just before it and
    read just after: each gated kernel and the VQ kernel must have launched
    exactly ``expect[name]`` times (0 unless given) and no plain version at
    all.  -> (train records, launches by kernel, the run's peak GiB, every
    record)."""
    import torch

    from ae_wavenet_tpu_torch.ops import gated, gated_cuda as gc
    from ae_wavenet_tpu_torch.ops import vq_cuda as vq

    expect = {**dict.fromkeys(GATED, 0), "gated_layer_bwd_recompute": 0,
              "vq_lookup_fused": 0, **expect}
    kernels = [getattr(gc, n) for n in GATED] + [vq.vq_lookup_fused]
    plain = [getattr(gated, n + "_reference") for n in GATED] + [vq.vq_lookup_reference]
    for f in kernels + plain:
        f.launches = 0
    gc.gated_layer_bwd.launches_recompute = 0
    torch.cuda.reset_peak_memory_stats()
    recs = _run_cli(argv)
    torch.cuda.synchronize()
    got = {f.__name__: f.launches for f in kernels}
    got["gated_layer_bwd_recompute"] = gc.gated_layer_bwd.launches_recompute
    plain_runs = {f.__name__: f.launches for f in plain}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(got == expect, f"{label}: kernel launches {got}, expected {expect}")
    check(not any(plain_runs.values()), f"{label}: plain versions ran {plain_runs}")
    print(f"[train] {label}: launches {got}; plain versions {plain_runs}; peak memory "
          f"{peak:.2f} GiB | {card}")
    return [r for r in recs if "loss" in r], got, peak, recs


class _Spans:
    """Device milliseconds between CUDA events recorded just before and
    just after each call of a wrapped function, summed per label."""

    def __init__(self):
        self.events = []

    def wrap(self, label, fn):
        import torch

        def timed(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            self.events.append((label, a, b))
            return out
        return timed

    def ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out: dict = {}
        for label, a, b in self.events:
            out[label] = out.get(label, 0.0) + a.elapsed_time(b)
        return out


def step_split(cfg, data: str, dev, n_steps: int = 3) -> dict:
    """Where one training step's time goes, every number from the same
    ``n_steps`` steps of ``Chassis.train`` (after one warm-up step): host
    wall and loader wait per step, and device spans (CUDA events around
    the calls, ms per step) of the whole step, the forward and loss, the
    encoder, the upsampler, the stack's forward, the backward, the stack's
    backward and the optimizer."""
    from unittest import mock

    import torch

    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.models import wavenet as twn
    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.training import chassis

    ch = chassis.Chassis(cfg, data, device=dev, log_stream=io.StringIO())
    ch.train(1)
    ch.stats.clear()
    sp = _Spans()
    targets = [(chassis, "train_step", "step"), (ae, "loss_fn", "forward"),
               (ch.model.encoder, "forward", "encoder"),
               (twn, "upsample_apply", "upsampler"),
               (gated, "run_forward", "stack forward"),
               (torch.Tensor, "backward", "backward"),
               (gated, "run_backward", "stack backward"),
               (ch.opt, "step", "optimizer")]
    with contextlib.ExitStack() as stack:
        for obj, attr, label in targets:
            stack.enter_context(mock.patch.object(obj, attr,
                                                  sp.wrap(label, getattr(obj, attr))))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ch.train(n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {k: v / n_steps for k, v in sp.ms().items()}
    out["host step"] = wall * 1e3 / n_steps
    out["loader wait"] = ch.stats.get("loader_wait", 0.0) * 1e3 / n_steps
    return out


def _median_step(recs: list[dict], eval_every: int = 0) -> float:
    """Median step seconds from the records' samples/s, the first step (its
    warm-up) left out, and with ``eval_every`` the steps that follow an eval
    and a save: the loop's clock charges those to the next step."""
    import statistics

    return statistics.median(
        TRAIN_B * TRAIN_WIN / r["samples_per_sec"] for r in recs[1:]
        if not (eval_every and (r["step"] - 1) % eval_every == 0))


def _print_split(cfg, data: str, dev, label: str, card: str) -> None:
    s = step_split(cfg, data, dev)
    fwd_rest = s["forward"] - s["encoder"] - s["upsampler"] - s["stack forward"]
    bwd_rest = s["backward"] - s["stack backward"]
    print(f"[train] step split, {label} (B={TRAIN_B}, n_win={TRAIN_WIN}, 3 steps, ms "
          f"per step; device spans from CUDA events): host step {s['host step']:.1f}, "
          f"loader wait {s['loader wait']:.2f}; device step {s['step']:.1f} = forward "
          f"and loss {s['forward']:.1f} (encoder {s['encoder']:.1f}, upsampler "
          f"{s['upsampler']:.1f}, stack forward {s['stack forward']:.1f}, the rest "
          f"{fwd_rest:.1f}) + backward {s['backward']:.1f} (stack backward "
          f"{s['stack backward']:.1f}, the rest {bwd_rest:.1f}) + optimizer "
          f"{s['optimizer']:.1f} | {card}")


def mfu_text(cfg, spec, step_s: float) -> str:
    """The step's model FLOP utilization at TRAIN_B (``utils/flops.py``: the
    analytic count of the step's products over the card's bf16 peak)."""
    import torch

    from ae_wavenet_tpu_torch.utils import flops

    work = TRAIN_B * flops.train_step_flops_per_item(cfg, spec)
    peak = flops.peak_bf16_flops(torch.cuda.get_device_name(0))
    share = "not known (no peak for this card)" if peak is None else \
        f"{work / step_s / peak:.2%}"
    peak_txt = "?" if peak is None else f"{peak / 1e12:.0f}"
    return (f"MFU {share}: {work / 1e12:.3f} TFLOP a step (utils/flops.py) in "
            f"{step_s * 1e3:.1f} ms = {work / step_s / 1e12:.1f} TFLOP/s over the "
            f"{peak_txt} TFLOP/s bf16 peak")


def phase_train(card: str, dev, tmp: str) -> dict:
    from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    data, ckpt = os.path.join(tmp, "train"), os.path.join(tmp, "ckpt")
    cfg = chorowski_config()
    u_len = ae.make_window_spec(cfg, TRAIN_WIN).u_len
    make_synthetic_dataset(data, n_clips=8, n_speakers=8,
                           clip_len=(u_len + 4000, u_len + 30000), seed=1)
    n_layers = len(gated.stack_dils(cfg.wavenet))
    check(n_layers % 2 == 0, f"{n_layers} layers: the pair schedule leaves one alone")
    check(n_layers % GROUP == 0, f"{n_layers} layers: groups of {GROUP} leave some")

    def expect(pairs: int, layers: int, steps: int) -> dict:
        # the single-layer path saves no y: its backward is the recompute mode
        return {"gated_pair_fused": pairs * steps, "gated_layer_fused": layers * steps,
                "gated_pair_bwd": pairs * steps, "gated_layer_bwd": layers * steps,
                "gated_layer_bwd_recompute": layers * steps}

    shape = ["--preset", "chorowski", "--pallas-stack", "--batch-sz", str(TRAIN_B),
             "--n-win", str(TRAIN_WIN), "--data", data, "--log-every", "1"]
    # the main path (pairs, saved y) at the CLI's default --device (cuda, no
    # index), as a user runs it: new, then resume
    t0 = time.perf_counter()
    new, n_new, peak_new, _ = _path_run(
        ["new", *shape, "--n-steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt],
        expect(n_layers // 2, 0, TRAIN_STEPS), card, "main path, new")
    res, n_res, peak_res, _ = _path_run(
        ["resume", "--n-steps", str(RESUME_STEPS), "--data", data, "--log-every", "1",
         "--ckpt-dir", ckpt],
        expect(n_layers // 2, 0, RESUME_STEPS), card, "main path, resume")
    wall = time.perf_counter() - t0
    peak = max(peak_new, peak_res)
    check([r["step"] for r in new] == list(range(1, TRAIN_STEPS + 1)),
          f"new run logged steps {[r['step'] for r in new]}")
    check([r["step"] for r in res] == list(range(TRAIN_STEPS + 1,
                                                 TRAIN_STEPS + RESUME_STEPS + 1)),
          f"resumed run logged steps {[r['step'] for r in res]}")
    ce = [r["recon_ce"] for r in new + res]
    check(ce[-1] < ce[0], f"recon_ce did not fall: {ce}")
    step_s = _median_step(new + res[1:])
    print(f"[train] CLI new {TRAIN_STEPS} + resume {RESUME_STEPS} steps in {wall:.1f} "
          f"s; recon_ce {' '.join(f'{v:.4f}' for v in ce)}; perplexity "
          f"{new[-1]['perplexity']:.2f}, grad_norm {res[-1]['grad_norm']:.4g} | {card}")
    print(f"[train] main path (pairs): median step {step_s * 1e3:.1f} ms -> "
          f"{TRAIN_B * TRAIN_WIN / step_s:.0f} samples/s (B={TRAIN_B}, n_win="
          f"{TRAIN_WIN}); peak memory {peak:.2f} GiB | {card}")
    print(f"[train] main path (pairs): "
          f"{mfu_text(cfg, ae.make_window_spec(cfg, TRAIN_WIN), step_s)} | {card}")

    # the single-layer path (--no-gated-fuse-pairs --no-gated-save-y): K1b
    # forward, K2b's recompute mode backward; the same first step
    alt, n_alt, peak_alt, _ = _path_run(
        ["new", *shape, "--no-gated-fuse-pairs", "--no-gated-save-y", "--n-steps",
         str(TRAIN_STEPS), "--ckpt-dir", os.path.join(tmp, "ckpt_alt")],
        expect(0, n_layers, TRAIN_STEPS), card, "single-layer path, new")
    check(len(alt) == TRAIN_STEPS, f"single-layer run logged {len(alt)} steps")
    d_alt = abs(alt[0]["loss"] - new[0]["loss"])
    check(d_alt < LOSS_TOL, f"single-layer path: first-step loss {alt[0]['loss']} vs "
          f"the main path's {new[0]['loss']} (tol {LOSS_TOL})")
    step_alt = _median_step(alt)
    ce_alt = " ".join(f"{r['recon_ce']:.4f}" for r in alt)
    print(f"[train] single-layer path (--no-gated-fuse-pairs --no-gated-save-y): "
          f"first-step loss {alt[0]['loss']:.6f} vs the main path's "
          f"{new[0]['loss']:.6f} (|d| {d_alt:.2g} < {LOSS_TOL}); recon_ce "
          f"{ce_alt}; median step "
          f"{step_alt * 1e3:.1f} ms -> {TRAIN_B * TRAIN_WIN / step_alt:.0f} samples/s; "
          f"peak memory {peak_alt:.2f} GiB | {card}")

    # the main path again with the fused VQ lookup: once per step, and the
    # first step (same seed, same data) loses nothing to it
    ckpt_vq = os.path.join(tmp, "ckpt_vq")
    fused, n_vq, _, _ = _path_run(
        ["new", *shape, "--vq-use-pallas", "--n-steps", str(VQ_TRAIN_STEPS),
         "--ckpt-dir", ckpt_vq],
        {**expect(n_layers // 2, 0, VQ_TRAIN_STEPS), "vq_lookup_fused": VQ_TRAIN_STEPS},
        card, "main path with --vq-use-pallas, new")
    check(len(fused) == VQ_TRAIN_STEPS, f"--vq-use-pallas run logged {len(fused)} steps")
    d_loss = abs(fused[0]["loss"] - new[0]["loss"])
    check(d_loss < 1e-4, f"first-step loss with --vq-use-pallas {fused[0]['loss']} vs "
          f"{new[0]['loss']} without")
    ce_vq = " ".join(f"{r['recon_ce']:.4f}" for r in fused)
    print(f"[train] --vq-use-pallas: first-step loss {fused[0]['loss']:.6f} vs "
          f"{new[0]['loss']:.6f} without (|d| {d_loss:.2g} < 1e-4); recon_ce {ce_vq}; "
          f"perplexity {fused[-1]['perplexity']:.2f}; median step "
          f"{_median_step(fused) * 1e3:.1f} ms | {card}")

    # the whole-stack path: every layer's forward in one launch (also for
    # each of an eval's 8 batches, which save nothing), the backward in
    # groups of GROUP layers; async saves with retention; new, then resume
    ckpt_ws = os.path.join(tmp, "ckpt_ws")
    runtime = ["--ckpt-dir", ckpt_ws, "--ckpt-keep", str(CKPT_KEEP), "--ckpt-every",
               "2", "--eval-every", str(EVAL_EVERY)]

    def expect_ws(steps: int, first: int) -> dict:
        evals = (first + steps) // EVAL_EVERY - first // EVAL_EVERY
        return {"gated_stack_fused": steps + 8 * evals,
                "gated_group_bwd": steps * n_layers // GROUP}

    ws_new, n_ws, peak_ws, all_new = _path_run(
        ["new", *shape, "--gated-full-fusion", "--gated-bwd-group", str(GROUP),
         "--n-steps", str(TRAIN_STEPS), *runtime],
        expect_ws(TRAIN_STEPS, 0), card, "whole-stack path, new")
    ws_res, n_ws_res, peak_ws_res, all_res = _path_run(
        ["resume", "--n-steps", str(RESUME_STEPS), "--data", data, "--log-every", "1",
         *runtime], expect_ws(RESUME_STEPS, TRAIN_STEPS), card,
        "whole-stack path, resume")
    ce_ws = [r["recon_ce"] for r in ws_new + ws_res]
    check([r["step"] for r in ws_new + ws_res]
          == list(range(1, TRAIN_STEPS + RESUME_STEPS + 1)),
          f"whole-stack runs logged steps {[r['step'] for r in ws_new + ws_res]}")
    check(ce_ws[-1] < ce_ws[0], f"whole-stack path: recon_ce did not fall: {ce_ws}")
    d_ws = abs(ws_new[0]["loss"] - new[0]["loss"])
    check(d_ws < LOSS_TOL, f"whole-stack path: first-step loss {ws_new[0]['loss']} vs "
          f"the main path's {new[0]['loss']} (tol {LOSS_TOL})")
    evals = {r["step"]: r["eval_recon_ce"] for r in all_new + all_res
             if "eval_recon_ce" in r}
    last = TRAIN_STEPS + RESUME_STEPS
    best = ckpt_mod.best_info(ckpt_ws)
    saved = sorted(s for s in range(1, last + 1) if s % 2 == 0)
    check(sorted(evals) == list(range(EVAL_EVERY, last + 1, EVAL_EVERY)),
          f"whole-stack path: evals at {sorted(evals)}")
    check(best is not None and best[1] == min(evals.values())
          and evals[best[0]] == best[1],
          f"whole-stack path: BEST {best}, evals {evals}")
    want_files = sorted({f"step_{s:08d}.pt" for s in saved[-CKPT_KEEP:] + [best[0]]}
                        | {"LATEST", "BEST"})
    check(sorted(os.listdir(ckpt_ws)) == want_files,
          f"whole-stack path: retention left {sorted(os.listdir(ckpt_ws))}, expected "
          f"{want_files}")
    check(ckpt_mod.latest_step(ckpt_ws) == last, "whole-stack path: LATEST is not the "
          "last step")
    step_ws = _median_step(ws_new + ws_res[1:], EVAL_EVERY)
    print(f"[train] whole-stack path (--gated-full-fusion --gated-bwd-group {GROUP}): "
          f"recon_ce {' '.join(f'{v:.4f}' for v in ce_ws)}; first-step loss "
          f"{ws_new[0]['loss']:.6f} vs the main path's {new[0]['loss']:.6f} (|d| "
          f"{d_ws:.2g} < {LOSS_TOL}); eval recon_ce {evals}; --ckpt-keep {CKPT_KEEP} "
          f"left {want_files}, BEST {best} | {card}")
    print(f"[train] whole-stack path: median step (of those that follow no eval and "
          f"save) {step_ws * 1e3:.1f} ms -> "
          f"{TRAIN_B * TRAIN_WIN / step_ws:.0f} samples/s; peak memory "
          f"{max(peak_ws, peak_ws_res):.2f} GiB (main path {step_s * 1e3:.1f} ms, "
          f"{peak:.2f} GiB) | {card}")

    # full fusion alone: the whole-stack forward, the pair backward
    ff, n_ff, peak_ff, _ = _path_run(
        ["new", *shape, "--gated-full-fusion", "--n-steps", "3"],
        {"gated_stack_fused": 3, "gated_pair_bwd": 3 * n_layers // 2}, card,
        "--gated-full-fusion alone, new")
    step_ff = _median_step(ff)
    print(f"[train] --gated-full-fusion alone: median step {step_ff * 1e3:.1f} ms -> "
          f"{TRAIN_B * TRAIN_WIN / step_ff:.0f} samples/s; peak memory {peak_ff:.2f} "
          f"GiB | {card}")
    print(f"[train] step by schedule, this run: pairs {step_s * 1e3:.1f} ms "
          f"({peak:.2f} GiB); --gated-full-fusion {step_ff * 1e3:.1f} ms "
          f"({step_ff / step_s - 1:+.1%} against pairs, {peak_ff:.2f} GiB); "
          f"--gated-full-fusion --gated-bwd-group {GROUP} {step_ws * 1e3:.1f} ms "
          f"({step_ws / step_s - 1:+.1%}, {max(peak_ws, peak_ws_res):.2f} GiB); "
          f"--no-gated-fuse-pairs --no-gated-save-y {step_alt * 1e3:.1f} ms "
          f"({step_alt / step_s - 1:+.1%}, {peak_alt:.2f} GiB) | {card}")

    # two profiled steps of the main path and of the whole-stack path:
    # device time by kernel name
    def profiled(argv, expect_n, label, kernels, prof_dir):
        _, n, _, recs = _path_run(
            ["new", *shape, *argv, "--n-steps", "2", "--profile-steps", "2",
             "--profile-dir", os.path.join(tmp, prof_dir)], expect_n, card,
            f"{label} under --profile-steps 2")
        prof = [r["profile"] for r in recs if "profile" in r]
        check(len(prof) == 1 and any("profile_trace" in r for r in recs),
              f"profiled run printed {len(prof)} summaries")
        prof = prof[0]
        names = " ".join(k["name"] for k in prof["top_kernels"])
        check(prof["device_busy_share"] is not None
              and 0.0 < prof["device_busy_share"] <= 1.0,
              f"profile: device-busy share {prof['device_busy_share']}")
        check(all(k in names for k in kernels), f"profile: the top kernels are {names}")
        check(os.path.getsize(prof["trace_file"]) > 0, "profile: empty trace file")
        tops = "; ".join(f"{k['name'][:60]} {k['ms'] / 2:.2f} ms/step x{k['calls'] // 2}"
                         for k in prof["top_kernels"])
        print(f"[train] profile of 2 steps of the {label} (torch.profiler): "
              f"device busy {prof['device_busy_share'] * 100:.2f}% of the "
              f"{prof['window_ms']:.1f} ms window ({prof['device_busy_ms']:.1f} ms in "
              f"{prof['n_kernels']} kernels and copies); top kernels by device time: "
              f"{tops} | {card}")
        return n

    n_prof_pairs = profiled([], expect(n_layers // 2, 0, 2), "main path (pairs)",
                            ("wg_fwd_kernel", "wg_bwd_kernel", "wg_dw_kernel"),
                            "prof_pairs")
    n_prof = profiled(["--gated-full-fusion", "--gated-bwd-group", str(GROUP)],
                      {"gated_stack_fused": 2, "gated_group_bwd": 2 * n_layers // GROUP},
                      "whole-stack path", ("wg_stack_kernel", "wg_group_kernel"),
                      "prof")

    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_sz=TRAIN_B, n_win=TRAIN_WIN),
        wavenet=dataclasses.replace(cfg.wavenet, use_pallas_stack=True))
    _print_split(cfg, data, dev, "main path (pairs)", card)
    _print_split(dataclasses.replace(cfg, wavenet=dataclasses.replace(
        cfg.wavenet, gated_full_fusion=True, gated_bwd_group=GROUP)), data, dev,
        f"whole-stack path (full fusion, groups of {GROUP})", card)
    runs = (n_new, n_res, n_alt, n_vq, n_ws, n_ws_res, n_ff, n_prof_pairs, n_prof)
    launches = {n: sum(r[n] for r in runs) for n in (*GATED, "gated_layer_bwd_recompute")}
    launches["vq_lookup_fused"] = n_vq["vq_lookup_fused"]
    return {"launches": launches, "data": data, "ckpt_vq": ckpt_vq}


def phase_eval(card: str, data: str, ckpt_dir: str) -> dict:
    """The eval CLI on the checkpoint the training phase wrote (its config
    asks for the fused stack and the fused VQ lookup): the eval record and
    one free-running quality record, every metric finite."""
    import torch

    from ae_wavenet_tpu_torch.cli import eval as cli
    from ae_wavenet_tpu_torch.eval.quality import QUALITY_KEYS
    from ae_wavenet_tpu_torch.ops import vq_cuda as vq

    vq.vq_lookup_fused.launches = vq.vq_lookup_reference.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--ckpt-dir", ckpt_dir, "--data", data, "--n-batches",
                       str(EVAL_BATCHES), "--quality", "--quality-samples",
                       str(EVAL_SAMPLES)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(rc == 0, f"eval CLI returned {rc}")
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    check(len(recs) == 2, f"eval CLI printed {len(recs)} records")
    ev, q = recs
    check(ev["step"] == VQ_TRAIN_STEPS and "eval_recon_ce" in ev
          and "eval_perplexity" in ev, f"eval record {ev}")
    check(all(k in q for k in QUALITY_KEYS) and q["n_scored"] == EVAL_SAMPLES,
          f"quality record {q}")
    check(all(math.isfinite(v) for r in recs for v in r.values()
              if isinstance(v, float)), f"non-finite eval metrics: {recs}")
    n_vq, n_plain = vq.vq_lookup_fused.launches, vq.vq_lookup_reference.launches
    check(n_vq == EVAL_BATCHES + 1 and n_plain == 0,
          f"eval: VQ kernel launches {n_vq} (expected {EVAL_BATCHES + 1}), plain {n_plain}")
    print(f"[eval] {json.dumps(ev)} | {card}")
    print(f"[eval] {json.dumps(q)} | {card}")
    print(f"[eval] cli/eval.py --quality: {EVAL_BATCHES} eval batches and "
          f"{EVAL_SAMPLES} free-running samples in {secs:.1f} s; VQ kernel launches "
          f"{n_vq}, plain {n_plain} | {card}")
    return {"launches": n_vq}


def _zero_counts() -> None:
    """Every launch counter (kernels and plain versions) to 0."""
    from ae_wavenet_tpu_torch.ops import fastgen_cuda as fc
    from ae_wavenet_tpu_torch.ops import gated, gated_cuda as gc
    from ae_wavenet_tpu_torch.ops import vq_cuda as vq

    for f in ([getattr(gc, n) for n in GATED]
              + [getattr(gated, n + "_reference") for n in GATED]
              + [vq.vq_lookup_fused, vq.vq_lookup_reference,
                 fc.generate_fused_reference]):
        f.launches = 0
    gc.gated_layer_bwd.launches_recompute = 0
    for name in ("launches", "launches_int8", "launches_int4"):
        setattr(fc.generate_fused, name, 0)


def _counts() -> dict:
    """Every kernel's launches since _zero_counts, and the plain versions'
    ("plain", all together)."""
    from ae_wavenet_tpu_torch.ops import fastgen_cuda as fc
    from ae_wavenet_tpu_torch.ops import gated, gated_cuda as gc
    from ae_wavenet_tpu_torch.ops import vq_cuda as vq

    got = {n: getattr(gc, n).launches for n in GATED}
    got.update(gated_layer_bwd_recompute=gc.gated_layer_bwd.launches_recompute,
               vq_lookup_fused=vq.vq_lookup_fused.launches,
               bf16=fc.generate_fused.launches, int8=fc.generate_fused.launches_int8,
               int4=fc.generate_fused.launches_int4)
    got["plain"] = (sum(getattr(gated, n + "_reference").launches for n in GATED)
                    + vq.vq_lookup_reference.launches
                    + fc.generate_fused_reference.launches)
    return got


def _expect(**kw) -> dict:
    """_counts() of a run that launched only the kernels given."""
    return {**dict.fromkeys(GATED, 0), "gated_layer_bwd_recompute": 0,
            "vq_lookup_fused": 0, "bf16": 0, "int8": 0, "int4": 0, "plain": 0, **kw}


def phase_inverter(card: str, dev, tmp: str) -> dict:
    """The MFCC inverter at the ``chorowski`` width, as a user runs it: the
    preprocess CLI writes the reference's v2 fixture; the train CLI trains
    ``--model mfcc_inverter --frame-norm dataset`` (new, then resume) on
    the pair kernels; the generate CLI vocodes one clip with each sampler.
    Launch counters at 0 before each run and checked exactly after it."""
    import torch

    from ae_wavenet_tpu_torch.cli import generate as gen_cli
    from ae_wavenet_tpu_torch.data.preprocess import dataset_frame_stats
    from ae_wavenet_tpu_torch.models import mfcc_inverter as mi
    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod
    from ae_wavenet_tpu_torch.utils.config import chorowski_config
    from ae_wavenet_tpu_torch.utils.wavio import read_wav

    data, ckpt = os.path.join(tmp, "inv"), os.path.join(tmp, "ckpt_inv")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ae_wavenet_tpu_torch.cli.preprocess",
                        "--synthetic", data, "--n-clips", str(INV_CLIPS)],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0, f"preprocess CLI returned {r.returncode}: {r.stderr}")
    print(f"[inverter] {r.stdout.strip()} in {time.perf_counter() - t0:.1f} s | {card}")

    n_pairs = len(gated.stack_dils(chorowski_config().wavenet)) // 2
    shape = ["--preset", "chorowski", "--model", "mfcc_inverter", "--pallas-stack",
             "--frame-norm", "dataset", "--batch-sz", str(TRAIN_B), "--n-win",
             str(TRAIN_WIN), "--data", data, "--log-every", "1"]
    expect = {"gated_pair_fused": n_pairs * TRAIN_STEPS,
              "gated_pair_bwd": n_pairs * TRAIN_STEPS}
    t0 = time.perf_counter()
    new, n_new, peak_new, _ = _path_run(
        ["new", *shape, "--n-steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt], expect,
        card, "inverter, new")
    expect = {"gated_pair_fused": n_pairs * RESUME_STEPS,
              "gated_pair_bwd": n_pairs * RESUME_STEPS}
    res, n_res, peak_res, _ = _path_run(
        ["resume", "--n-steps", str(RESUME_STEPS), "--data", data, "--log-every", "1",
         "--ckpt-dir", ckpt], expect, card, "inverter, resume")
    wall = time.perf_counter() - t0
    last = TRAIN_STEPS + RESUME_STEPS
    check([r["step"] for r in new + res] == list(range(1, last + 1)),
          f"inverter runs logged steps {[r['step'] for r in new + res]}")
    check(math.isfinite(new[0]["loss"]), f"inverter first-step loss {new[0]['loss']}")
    check(set(new[0]) >= {"loss", "recon_ce"} and "perplexity" not in new[0],
          f"inverter metrics {sorted(new[0])}")
    ce = [r["recon_ce"] for r in new + res]
    check(ce[-1] < ce[0], f"inverter recon_ce did not fall: {ce}")
    cfg = ckpt_mod.load_config(ckpt, last)[1]
    stats = dataset_frame_stats(data, cfg.spec)
    check(cfg.model_kind == "mfcc_inverter" and cfg.spec.norm == "dataset"
          and (cfg.spec.stats_mean, cfg.spec.stats_var) == stats
          and len(stats[0]) == 3 * cfg.spec.n_mfcc,
          "the inverter's checkpoint does not carry the dataset statistics")
    check(cfg.wavenet.lc_upsample_strides == (5, 4, 4, 2),
          f"inverter strides {cfg.wavenet.lc_upsample_strides}")
    step_s = _median_step(new + res[1:])
    peak = max(peak_new, peak_res)
    print(f"[inverter] train CLI new {TRAIN_STEPS} + resume {RESUME_STEPS} steps in "
          f"{wall:.1f} s (--frame-norm dataset: {len(stats[0])} channel statistics in "
          f"the checkpoint's config); recon_ce {' '.join(f'{v:.4f}' for v in ce)}; "
          f"first-step loss {new[0]['loss']:.6f} | {card}")
    print(f"[inverter] median step {step_s * 1e3:.1f} ms -> "
          f"{TRAIN_B * TRAIN_WIN / step_s:.0f} samples/s (B={TRAIN_B}, n_win="
          f"{TRAIN_WIN}); peak memory {peak:.2f} GiB; "
          f"{mfu_text(cfg, mi.make_window_spec(cfg, TRAIN_WIN), step_s)} | {card}")

    out = os.path.join(tmp, "inv.wav")
    launches = {"gated_pair_fused": n_new["gated_pair_fused"] + n_res["gated_pair_fused"],
                "gated_pair_bwd": n_new["gated_pair_bwd"] + n_res["gated_pair_bwd"]}
    for mode in ("bf16", "int8", "int4"):
        flags = [] if mode == "bf16" else ["--" + mode]
        _zero_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = gen_cli.main(["--ckpt", ckpt_mod.checkpoint_path(ckpt, last), "--data",
                               data, "--clip", "0", "--n-samples", str(CLI_SAMPLES),
                               "--temperature", "1.0", *flags, "--out", out])
        torch.cuda.synchronize()
        got, text = _counts(), buf.getvalue()
        check(rc == 0, f"generate CLI on the inverter returned {rc}")
        check(got == _expect(**{mode: 1}), f"inverter {mode}: launches {got}")
        check("(mfcc_inverter," in text, f"generate CLI loaded another model:\n{text}")
        wav, sr = read_wav(out)
        check(len(wav) == CLI_SAMPLES and sr == cfg.spec.sample_rate, "wrong wav written")
        check(len(set(wav.tolist())) > 16, "the vocoded wav is (nearly) constant")
        m = re.search(r"encode ([\d.]+) s, prime ([\d.]+) s, generate ([\d.]+) s", text)
        check(m is not None, f"CLI printed no timings:\n{text}")
        enc, pr, gen_s = map(float, m.groups())
        print(f"[inverter] generate CLI B=1 {' '.join(flags) or 'bf16'}: {CLI_SAMPLES} "
              f"samples, encode {enc:.3f} s, prime {pr:.3f} s, generate {gen_s:.3f} s "
              f"-> {CLI_SAMPLES / gen_s:.0f} samples/s; launches {mode} {got[mode]}, "
              f"plain {got['plain']} | {card}")
        launches[mode] = got[mode]

    # the eval CLI on the same checkpoint (at its default --device): the
    # eval batches' forwards on the pair kernel, the rollout in eager f32
    from ae_wavenet_tpu_torch.cli import eval as eval_cli
    from ae_wavenet_tpu_torch.eval.quality import QUALITY_KEYS

    _zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = eval_cli.main(["--ckpt-dir", ckpt, "--data", data, "--n-batches",
                            str(EVAL_BATCHES), "--quality", "--quality-samples",
                            str(EVAL_SAMPLES)])
    torch.cuda.synchronize()
    secs, got = time.perf_counter() - t0, _counts()
    check(rc == 0, f"eval CLI on the inverter returned {rc}")
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    check(len(recs) == 2, f"eval CLI printed {len(recs)} records")
    ev, q = recs
    check(ev["step"] == last and "eval_recon_ce" in ev and "eval_perplexity" not in ev,
          f"inverter eval record {ev}")
    check(all(k in q for k in QUALITY_KEYS) and q["n_scored"] == EVAL_SAMPLES
          and all(math.isfinite(v) for r in recs for v in r.values()
                  if isinstance(v, float)), f"inverter quality record {q}")
    check(got == _expect(gated_pair_fused=n_pairs * EVAL_BATCHES),
          f"inverter eval: launches {got}")
    print(f"[inverter] cli/eval.py --quality: {json.dumps(ev)}; {json.dumps(q)}; "
          f"{secs:.1f} s, pair forward launches {got['gated_pair_fused']} | {card}")
    launches["gated_pair_fused"] += got["gated_pair_fused"]
    return {"launches": launches}


def phase_gate(card: str, dev, tmp: str) -> dict:
    """The reference's int8 quality gate (``eval/quality.quantized_quality_
    gate``: 300 steps of the flagship dims on its v2 fixture, then 16,384
    free-running samples in bf16, int8 and int4): the training on the pair
    kernels only, one sampler launch per reconstruction, no plain version,
    and d8 <= 1.20 d16 + 0.15."""
    import torch

    from ae_wavenet_tpu_torch.eval import quality
    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

    n_pairs = len(gated.stack_dils(WaveNetConfig())) // 2
    seen: dict = {}

    def on_trained(ch, history):
        torch.cuda.synchronize()
        seen["train"], seen["train_s"] = _counts(), time.perf_counter() - t0
        seen["history"] = history
        _zero_counts()

    _zero_counts()
    t0 = time.perf_counter()
    r = quality.quantized_quality_gate(os.path.join(tmp, "gate"), dev,
                                       on_trained=on_trained)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sampled = _counts()
    want = _expect(gated_pair_fused=n_pairs * quality.GATE_STEPS,
                   gated_pair_bwd=n_pairs * quality.GATE_STEPS)
    check(seen["train"] == want, f"gate training: launches {seen['train']}, "
          f"expected {want}")
    check(sampled == _expect(bf16=1, int8=1, int4=1), f"gate sampling: launches "
          f"{sampled}")
    dists = {k: r[k] for k in ("d16", "d8", "d4", "silence")}
    check(r["n"] == quality.GATE_SAMPLES
          and all(math.isfinite(v) for v in dists.values()),
          f"gate: {r['n']} samples, distances {dists}")
    hist = seen["history"]
    ce = " ".join(f"{h['recon_ce']:.4f}" for h in hist)
    print(f"[gate] {quality.GATE_STEPS} training steps (flagship dims, B=4, "
          f"n_win=8000, 4 a call) in {seen['train_s']:.1f} s: recon_ce {ce} at steps "
          f"{[h['step'] for h in hist]}, {hist[-1]['samples_per_sec']:.0f} samples/s "
          f"at the last log | {card}")
    bound = quality.GATE_RATIO * r["d16"] + quality.GATE_SLACK
    verdict = "pass" if r["passed"] else "FAIL"
    print(f"[gate] log-mel distance to the source over {r['n']} free-running samples: "
          f"bf16 d16 {r['d16']:.4f}, int8 d8 {r['d8']:.4f} (gate d8 <= "
          f"{quality.GATE_RATIO} x d16 + {quality.GATE_SLACK} = {bound:.4f}: "
          f"{verdict}), int4 {r['d4']:.4f} (no gate), silence {r['silence']:.4f}; phase "
          f"{secs:.1f} s | {card}")
    check(r["passed"], f"int8 quality gate: d8 {r['d8']} > {bound} (d16 {r['d16']})")
    launches = {n: seen["train"][n] for n in ("gated_pair_fused", "gated_pair_bwd")}
    launches.update({m: sampled[m] for m in ("bf16", "int8", "int4")})
    return {"launches": launches, **dists}


def kernel_times(card: str, dev) -> None:
    """``--kernel-times``: the VQ lookup's times (``vq_times``) at phase 4's
    latents, the single-layer backward's recompute mode at the training
    path's shape, timed as phase 6 times it, with the call's peak memory
    above its inputs, and the single-layer path through the train CLI as
    phase 7 runs it (median step, peak memory); no checks, so that an older
    commit's package can be timed with the same code."""
    import torch

    from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.ops import _build
    from ae_wavenet_tpu_torch.ops import gated_check as chk
    from ae_wavenet_tpu_torch.ops import gated_cuda as gc
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    t0 = time.perf_counter()
    _build.load()
    print(f"[times] build {time.perf_counter() - t0:.2f} s, package "
          f"{os.path.dirname(_build.CSRC)} | {card}")
    with f32_numerics(), tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth")
        make_synthetic_dataset(data, n_clips=BATCH, n_speakers=8,
                               clip_len=(12400, 14000), seed=0)
        e, cases = vq_cases(dev, data)
        for label, z in cases.items():
            print(f"[times] vq {label}: N={z.shape[0]}: {vq_times_line(vq_times(z, e))} "
                  f"| {card}")
        del e, cases
        wcfg = chorowski_config().wavenet
        wn, ids, cond, spk = chk.random_stack(wcfg, TRAIN_B, TRAIN_WIN, 1, dev)
        dils, x0, cond_tm, packed, xs, ys, cot = chk.segment_inputs(wn, wcfg, ids, cond,
                                                                    spk)
        wrapper, call = chk.segment_calls(dils, cond_tm, packed, xs, ys,
                                          cot)["gated_layer_bwd_recompute"]
        kern, moved = getattr(gc, wrapper), []

        def probe(*a, **kw):
            moved.append((a, kw))
            return kern(*a, **kw)

        call(probe)
        a, kw = moved[0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = kern(*a, **kw)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        del out
        k_ms = cuda_ms(lambda: kern(*a, **kw), 3)
        kc_ms = cuda_ms(lambda: call(kern), 3)
        print(f"[times] gated_layer_bwd_recompute B={TRAIN_B} t_in={x0.shape[1]}: kernel "
              f"{k_ms:.3f} ms ({kc_ms:.3f} with the case's input copies); the call's peak "
              f"memory above its inputs {peak:.3f} GB | {card}")
        del wn, ids, cond, spk, x0, cond_tm, packed, xs, ys, cot, moved, a, kw, call
        cfg = chorowski_config()
        u_len = ae.make_window_spec(cfg, TRAIN_WIN).u_len
        make_synthetic_dataset(data + "_train", n_clips=8, n_speakers=8,
                               clip_len=(u_len + 4000, u_len + 30000), seed=1)
        torch.cuda.reset_peak_memory_stats()
        recs = [r for r in _run_cli(
            ["new", "--preset", "chorowski", "--pallas-stack", "--batch-sz", str(TRAIN_B),
             "--n-win", str(TRAIN_WIN), "--data", data + "_train", "--log-every", "1",
             "--no-gated-fuse-pairs", "--no-gated-save-y", "--n-steps", str(TRAIN_STEPS),
             "--ckpt-dir", os.path.join(tmp, "ckpt_alt")]) if "loss" in r]
        torch.cuda.synchronize()
        step = _median_step(recs)
        print(f"[times] single-layer path (--no-gated-fuse-pairs --no-gated-save-y), "
              f"{TRAIN_STEPS} steps: first-step loss {recs[0]['loss']:.6f}, median step "
              f"{step * 1e3:.1f} ms, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card)  # exactly as nvidia-smi reports name and power limit
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--kernel-times"]:
        kernel_times(card, dev)
        return 0
    phase_env(card)
    phase_build(card)
    k = phase_kernel(card, dev)
    with tempfile.TemporaryDirectory() as tmp:
        from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset

        data = os.path.join(tmp, "synth")
        make_synthetic_dataset(data, n_clips=BATCH, n_speakers=8,
                               clip_len=(12400, 14000), seed=0)
        v = phase_vq(card, dev, data)
        s = phase_serve(card, dev, data, tmp)
    g = phase_train_kernels(card, dev)
    with tempfile.TemporaryDirectory() as tmp:
        t = phase_train(card, dev, tmp)
        e = phase_eval(card, t["data"], t["ckpt_vq"])
    with tempfile.TemporaryDirectory() as tmp:
        inv = phase_inverter(card, dev, tmp)
        gate = phase_gate(card, dev, tmp)

    def extra(name: str) -> int:
        """Phases 9 and 10's launches of one kernel."""
        return inv["launches"].get(name, 0) + gate["launches"].get(name, 0)

    fastgen = "ae_wavenet_tpu_torch/csrc/fastgen.cu"
    replaces = {"bf16": "ae_wavenet_tpu/ops/fastgen_pallas.py:612",
                "int8": "ae_wavenet_tpu/ops/fastgen_pallas.py:501",
                "int4": "ae_wavenet_tpu/ops/fastgen_pallas.py:481"}
    # the samplers' times are per generated step at B = 1, the batch of the
    # CLI request that their launches are counted on; by_batch has the rest
    kernels = [{
        "name": "fastgen_" + mode, "route": "cuda", "source": fastgen,
        "replaces": replaces[mode], "launches": s["launches"][mode] + extra(mode),
        "max_abs_err": k[mode]["max_abs_err"], **k[mode]["by_batch"][1],
        "library_ms": None, "batch": 1, "per": "generated step",
        "by_batch": k[mode]["by_batch"]} for mode in ("bf16", "int8", "int4")]
    def gated_row(name, launches):
        k_ms, p_ms, b_ms, by = g["times"][name]
        return {"launches": launches, "max_abs_err": g["errs"][name], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None}

    for name, replaced in GATED.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ae_wavenet_tpu_torch/csrc/gated.cu", "replaces": replaced,
            **gated_row(name, t["launches"][name] + extra(name)),
            **({"yardstick_ms": g["yardsticks"][name]} if name in g["yardsticks"] else {})})
    # K2b's two modes are two kernels behind one wrapper: the row above is
    # the saved-y mode's time; the recompute mode's (the single-layer path's
    # launches) rides beside it
    n_rec = t["launches"]["gated_layer_bwd_recompute"]
    k2b = next(k for k in kernels if k["name"] == "gated_layer_bwd")
    k2b["saved_y_launches"] = k2b["launches"] - n_rec
    k2b["recompute_mode"] = gated_row("gated_layer_bwd_recompute", n_rec)
    vq_train = {n: x for n, x in v["training step"].items() if n != "n"}
    vq_by_n = {x["n"]: {n: y for n, y in x.items() if n not in ("n", "max_abs_err")}
               for x in v.values()}
    kernels.append({
        "name": "vq_lookup", "route": "cuda",
        "source": "ae_wavenet_tpu_torch/csrc/vq.cu",
        "replaces": "ae_wavenet_tpu/ops/vq_pallas.py:66",
        "launches": s["launches"]["vq"] + t["launches"]["vq_lookup_fused"]
        + e["launches"], **vq_train, "library_ms": None,
        "n": v["training step"]["n"], "by_n": vq_by_n})
    print(json.dumps({"kernels": kernels}))
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
