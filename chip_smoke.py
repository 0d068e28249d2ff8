#!/usr/bin/env python3
"""The port on an NVIDIA GPU: its build, its kernels' times, and its CLIs
and scripts driven at the flagship width.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and no network.  The card
tests (``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py``) hold each kernel to its plain version over
shapes, schedules and planted faults; this script measures and drives, and
holds each kernel's reading on the inputs it times to the tolerance those
tests take from here (LOGIT_REL_TOL, MOL_PARAM_TOL, ``vq_codes_agree`` and
VQ_SUM_TOL, ``segment_tolerance``).  Phases, each printing its own line(s),
every measurement beside the card's name and power limit:

1. environment: torch, CUDA, nvcc, triton, the card;
2. build: compiles ae_wavenet_tpu_torch/csrc/*.cu from this checkout and
   prints every kernel's registers, spills and stack from the ptxas report
   (every kernel of the Hopper tile core, the whole-stack, group and
   recompute-mode kernels among them, must be listed, and none of them nor
   the sampler's may spill; no WMMA kernel is left);
3. the sampler kernels (bf16, int8, int4) at the ``chorowski`` width: each
   share plan, then each version's time a generated step at B = 1, 8 and
   64 beside its bound, its plain version's time and the earlier cluster
   design's (at B = 1 also in one launch of the CLI request's 4,000 steps),
   its logits over PLAIN_T greedy steps against the plain version's, and
   the kernel's own clock split of a step into grid barriers, GEMMs and
   the rest with the SM clock it ran at;
4. the fused VQ lookup at the N of the serving request and of the training
   step (the encoder's own latents): one kernel a call with and without the
   statistics (torch.profiler), and its time three ways: CUDA events
   around a loop of wrapper calls, the kernel's device time (profiler) and
   the wrapper's host time per call;
5. serving: the generate CLI on one clip (B = 1) of a synthetic dataset
   from an export-format checkpoint, then ``reconstruct`` on a batch of
   64 clips, then the CLI with ``--int8`` and with ``--int4`` on a
   checkpoint whose config has ``vq_use_pallas=True``; the launch counters
   are set to 0 before each run and show which kernels it went through,
   and that prime ran as one pass a request (no eager step); then the
   mixture-of-logistics sampler (``fastgen_kernel<3>``) at the published
   widths of ``benchmark/configs/wavenet_mol_24k.json`` and its cell's B =
   64, 18 of 30 layers resident and 12 streamed through L2: its time a
   step beside its bound (``phase_mol``);
6. train-kernels: the six gated-stack kernels (``csrc/gated.cu``: one
   layer, a pair, the whole stack forward; one layer in both modes, a pair,
   a group of layers backward) at the training path's shape (B = 4, n_win
   = 48,000; seeded random weights, every bias perturbed), each timed
   beside its bound and its plain version (the pair kernels also beside
   their bytes bound and a cuBLAS yardstick of their products alone); the
   stack's forward and backward timed under pairs, full fusion, and full
   fusion with groups of 5; then K1b's non-causal three-tap mode
   (WaveGlow's layer, ``wg_same_kernel``) at its cell's shape, B = 16 x
   16,384 rows at 256 channels with a layer's slice of the cond projection
   as the addend, beside its bound and plain version (``--three-tap`` runs
   it alone after the build);
7. train: the train CLI at B = 4, n_win = 48,000.  ``new --preset chorowski
   --pallas-stack`` for 4 steps and ``resume`` for 2 more (the main path:
   pairs, saved y); 4 steps of the single-layer schedule
   (``--no-gated-fuse-pairs --no-gated-save-y``: K2b's recompute mode, the
   first step's loss beside the main path's) and 4 with saved y
   (``--no-gated-fuse-pairs`` alone: K1b and K2b's saved-y mode, the same
   first-step check); 3 steps with ``--vq-use-pallas`` (the fused VQ lookup
   once per step, the first step's loss equal to the run without it); then
   the whole-stack path, ``--gated-full-fusion --gated-bwd-group 5
   --ckpt-keep 2 --ckpt-every 2 --eval-every 2`` for 4 steps and ``resume``
   for 2 (one forward launch per step and per eval batch, four grouped
   backward launches per step, the first step's loss beside the main
   path's, the checkpoints that retention leaves), 3 steps of
   ``--gated-full-fusion`` alone (pair backward), and 2 steps of the main
   path and 2 of the whole-stack path under ``--profile-steps 2``
   (device-busy share, device time by kernel name).  Every run trains
   through the captured step (``chassis.train_step``: one capture a run,
   one replay a step, no eager step; the capture's warm-up step launches
   the kernels once more).  The launch counters are set to 0 before each
   run and read after it: every gated kernel (the single-layer backward's
   recompute mode counted apart) must have launched exactly as its path
   says and no plain version at all.  Median step time, samples/s and peak
   memory of each path (the main path's with the pair backward's tiles in
   flight, 2 at these widths), its MFU, and the step's time split from
   CUDA events around its parts in 3 steps of one ``Chassis`` run, for the
   main and the whole-stack path;
8. eval: ``cli/eval.py --quality`` on the checkpoint that run wrote (its
   prime as one pass and its rollout as a CUDA graph; from here on every
   exact launch check also holds the rollout's eager step loop at 0);
9. inverter: ``python -m ae_wavenet_tpu_torch.cli.preprocess --synthetic``
   writes the reference's v2 fixture (8 clips); the train CLI runs ``new
   --preset chorowski --model mfcc_inverter --pallas-stack --frame-norm
   dataset`` at B = 4, n_win = 48,000 for 4 steps and ``resume`` for 2 (10
   pair forwards and 10 pair backwards a step, no other kernel; the
   dataset statistics in the checkpoint's config; median step, samples/s,
   peak memory and MFU from ``utils/flops.py``; the pair backward's tiles in
   flight, 2); then the generate CLI vocodes 4,000 samples of one clip in
   bf16, ``--int8`` and ``--int4``, one sampler launch each, and
   ``cli/eval.py --quality`` scores the checkpoint;
10. parallel (``parallel/mesh.py``, ``parallel/halo.py``): (a) two ranks of
   the train CLI on the one card as subprocesses (``--distributed``, gloo,
   global B = 4, n_win = 48,000), new for 3 steps and resume for 1: the
   ranks' logged losses and state digests bit-identical, rank 0 alone writes
   the checkpoint and both resume at step 3, per rank per step 10 pair
   forwards, 10 pair backwards and 1 VQ launch and no plain version, each
   rank's occupancy query; (b) ``--mesh`` on the one card: a world of
   one on NCCL, 2 steps, the losses bit for bit those of the run without it;
   (c) the halo stack (``make_sp_forward``) at the ``chorowski`` decoder
   width over 2 ranks, B = 2, T = 2 x 25,000, f32, against the single-rank
   stack (rtol/atol 2e-4); (d) ``python -m ae_wavenet_tpu_torch.dryrun 2``
   on the card (its default).  Median step, samples/s, each rank's peak
   memory, the gradient bytes all-reduced a step and the collective's time
   (CUDA events); every subprocess and spawn has a timeout;
11. instruments (``ae_wavenet_tpu_torch/scripts``, each through its
   ``main`` as ``python -m`` runs it) at the flagship width: ``long_run``
   for 16 steps on 8 clips of the reference's v2 fixture (an eval and a
   save at step 16, a 1,000-sample probe), ``eval_quality --divergence``
   at two temperatures and ``quality_quantized --step best`` (K4, K5, K6
   once each; 500 samples a rollout) on its checkpoints, the generate CLI by ``--ckpt-dir``,
   ``--ckpt-dir --step 16`` and ``--ckpt`` (the same wav), then
   ``diag_vq``, ``diag_vae --preset flagship`` and ``gain_ab
   --bottlenecks zero,vq``, 8 steps a twin: each exits 0 with the JAX
   script's record keys, every value finite, the launch counters at 0
   before each and exact after it (K1 and K2 in training and eval); the
   phase's seconds;
12. measures (the measuring scripts, ``ae_wavenet_tpu_torch/scripts``, each
   through its ``main``) at the flagship width, cut in iterations and steps
   only: first the VQ kernel at every shape of ``bench_vq``'s sweep (N =
   4,096 and 16,384, K = 512, 4,096 and 8,192) and the three sampler
   kernels at B = 128, each timed beside its bound and its plain version;
   then ``bench_gated`` and ``ablate_step``
   at 2 iterations (the kernel paths within 0.02 and 0.05 of the plain
   forward), ``bench_vq`` (the sweep, the train step at 3 + 5 steps with
   the VQ kernel off and on), ``bench_gen`` at B = 128 (bf16, int8) and
   B = 64 (int4), 256 steps, and one eager record at 64, ``bench_mfcc``,
   ``bench_ckpt --flagship``, ``bench_chassis --steps 8``,
   ``probe_dispatch`` at K = 8, ``convergence_ab`` over 40 steps (mean
   |dCE| <= 0.03, max <= 0.15) and ``train_curves`` at 40 steps a family:
   each exits 0 with the JAX script's record keys, every value finite, the
   launch counters at 0 before each and exact after it;
13. bench (``ae_wavenet_tpu_torch/bench.py``, the port of ``bench.py``):
   its functions in this process at the defaults (pairs; B = 4, n_win =
   48,000, 20 compute-only steps after 3 warm-up, ``Chassis.train`` at K =
   8 for 16 + 24 steps) and under BENCH_FULL_FUSION=1 BENCH_BWD_GROUP=5,
   the launch counters at 0 before each and exact after it (10 K1 and 10
   K2, or 1 K7 and 4 K8, in each of 63 steps; no plain version), then
   ``python -m ae_wavenet_tpu_torch.bench`` as a subprocess: each line has
   ``bench.py``'s keys, the e2e headline, 15.36 TFLOP a step, MFU in (0,
   1.05] and e2e/compute in (0, 1.10]; the compute rate beside phase 12's
   ``probe_dispatch``.

``python3 chip_smoke.py --mesh-cards``, on a machine with 2 or 4 cards,
builds the kernels and runs ``--mesh`` over every card on NCCL (new 3 +
resume 1 steps, the first step against one card at the same global
batch) and the halo stack over the cards.

``python3 chip_smoke.py --mol`` builds the kernels and runs only
``phase_mol``.

``python3 chip_smoke.py --serve-times`` builds the kernels and only times
the serving path (the CLI's B = 1 request twice, ``reconstruct`` at B =
64, ``bench_gen`` at B = 64), with no checks: run from an unpacked older
commit with this file beside it, it times that commit's prime.

``python3 chip_smoke.py --train-times`` builds the kernels and only times
the main path's training step (``bench.py``'s defaults) replayed as a CUDA
graph and run eagerly, in one process, graph, eager, eager, graph:
compute-only and fetch-every-step ms, peak memory, the device-busy share and
kernels a step under ``torch.profiler``; no checks: run from an unpacked
older commit with this file beside it, it times that commit's step.

``python3 chip_smoke.py --kernel-times`` builds the kernels and only times
the VQ lookup (phase 4's numbers) and the single-layer backward's recompute
mode (phase 6's), with no checks: run from an unpacked older commit with
this file beside it, it times that commit's kernels in the same call.

Then one JSON line describing the ten kernels and the mixture-of-logistics
sampler, which replaces no TPU kernel (each with its launches on its
paths, phases 9 to 13 included; its largest difference from the plain
version on the inputs it was timed on, ``max_abs_err``; its time beside
the plain version's and the card's bound for the same work; the
single-layer backward's row carries its recompute mode's numbers beside
it), and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero.
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
import signal
import statistics
import subprocess
import sys
import tempfile
import time

TIMED_T = 128           # generated steps of a timed sampler launch
POST2_SCALE = 8.0       # makes the seeded logits informative (max ~5, not ~0.65)
CLI_SAMPLES = 4000      # B = 1 request
BATCH = 64              # batched request
MOL_CONFIG = "benchmark/configs/wavenet_mol_24k.json"  # the MoL cell's published widths
MOL_B = 64              # the MoL cell's batch
MOL_TIMED_T = 512       # steps a timed MoL launch
SERVE_TIMES_STEPS = 512  # bench_gen's steps in --serve-times
# ms per generated step of the earlier (cluster) design at B = 1 / 8 / 64,
# PERF.md (NVIDIA H100 80GB HBM3, 700 W)
PR5_MS = {"bf16": (0.3205, 0.3342, 0.3760), "int8": (0.2698, 0.2831, 0.3562),
          "int4": (0.2532, 0.2640, 0.3353)}
BATCH_SAMPLES = 2000
BATCH_WAV_LEN = 10200   # chorowski: cond frames for 2000 samples after rf
TRAIN_B, TRAIN_WIN = 4, 48000    # the training path's shape
TRAIN_STEPS, RESUME_STEPS = 4, 2
TRAIN_TIMES_STEPS = 20   # --train-times: steps of each timed segment
TRAIN_TIMES_PROFILED = 5  # and of its profiled window
GROUP = 5               # layers per grouped backward on the whole-stack path
EVAL_EVERY, CKPT_KEEP = 2, 2   # on the whole-stack path
LOSS_TOL = 0.02         # first-step loss, whole-stack path vs main path
PLAIN_T = 32            # steps of the plain versions' timing
VQ_TRAIN_STEPS = 3
# Each kernel against its plain version on the same inputs, as the card tests
# (tests/test_torch_cuda.py) and this script's readings hold it.  The sampler's
# logits over each row's agreeing prefix, of max |logits|, at the ``chorowski``
# widths (tests_tpu/test_pallas_tpu.py:236 for bf16; the quantized ones'
# integer sums exact on both sides): f32 sums of 928-wide products in another
# order, through 20 layers or more.
LOGIT_REL_TOL = {None: 0.05, "int8": 0.01, "int4": 0.01}
MOL_PARAM_TOL = 0.02    # mixture parameters, of each group's max|.| (logits, means, scales)
VQ_SUM_TOL = 1e-4       # the VQ sums against float64 sums over its codes, of the largest
VQ_TIE_TOL = 1e-5       # codes may differ only at ties to this, of the row's largest distance
# The gated kernels round at the same points as their plain versions (the
# contract in ops/gated.py); only the order of f32 summation differs, so an
# intermediate bf16 value may land one ulp (2^-8 relative) apart and carry
# that into later sums: every output within SEGMENT_REL_TOL of the plain
# output's largest value.  The whole-stack forward run against the plain
# version from x0 adds such flips over its layers on the residual stream
# (about 0.02 of the largest value at 20 layers of the flagship width, against
# 0.004-0.006 for one layer): DRIFT_REL_TOL.
SEGMENT_REL_TOL = 1e-2
DRIFT_REL_TOL = 5e-2
EVAL_SAMPLES, EVAL_BATCHES = 1000, 2
INV_CLIPS = 8           # phase 9: the reference's v2 fixture, from the CLI
DP_RANKS = 2            # phase 10: ranks sharing the one card (gloo)
DP_STEPS, DP_RESUME = 3, 1
DP_TIMEOUT_S = 240      # per subprocess or spawn: a hung collective fails
DP_LOSS_REL_TOL = 1e-3  # --mesh-cards: the first step vs one card (bf16 stacks at B 1 vs 4)
HALO_T = 25_000         # phase 10(c): time columns per rank
INSTR_CLIPS = 8         # phase 11: the instruments' fixtures
INSTR_STEPS = 16        # long_run: an eval, a save and the probe at the end
DIAG_STEPS = 8          # each twin of diag_vq, diag_vae and gain_ab
INSTR_SAMPLES = 1000    # free-running samples of long_run's probe
ROLLOUT_SAMPLES = 500   # of each other rollout (the eager sampler's steps cost
                        # ~3-7 ms on the host; the log-mel distance needs 400)
MEASURE_ITERS = 2       # phase 12: bench_gated's and ablate_step's timed calls
MEASURE_VQ_TRAIN_ITERS = 5  # bench_vq's timed steps, after its 3 warm-up steps
MEASURE_GEN_BATCH = 128  # K4-K6 timed at bench_gen_r5's largest batch
MEASURE_HELD_T = 64     # greedy steps of their reading against the plain version
MEASURE_GEN_STEPS = 256  # bench_gen's steps a launch
MEASURE_SCAN_STEPS = 64  # its eager record's (a few ms a step on the host)
CONV_STEPS = 40         # convergence_ab, the JAX script's default
MEASURE_CURVE_STEPS = 40  # train_curves, each family
BENCH_ITERS, BENCH_K = 20, 8  # phase 13: the bench's defaults (BENCH_ITERS, _STEPS_PER_CALL)
BENCH_KNOBS = ("BENCH_BATCH", "BENCH_NWIN", "BENCH_ITERS", "BENCH_AUX_WEIGHT",
               "BENCH_PALLAS_STACK", "BENCH_FULL_FUSION", "BENCH_BWD_GROUP",
               "BENCH_STEPS_PER_CALL", "BENCH_E2E")
BENCH_TFLOP = 15.36     # the step's count at the defaults (utils/flops.py), 2 places
BENCH_MFU_MAX = 1.05
BENCH_E2E_MAX = 1.10    # e2e over compute-only: two timings of the same steps
BENCH_CLI_TIMEOUT_S = 300
STACK_ABS_TOL = 0.02    # bench_gated: pairs against the plain bf16 forward
STACK_FULL_ABS_TOL = 0.05  # and the whole-stack kernel (one-ulp flips over 20 layers)
# the JAX scripts' record keys (scripts/bench_*.py, probe_dispatch.py,
# convergence_ab.py) and ablate_step's line labels
BENCH_GATED_KEYS = {"config", "full_fusion_applied", "xla_fwd_ms", "pallas_fwd_ms",
                    "full_fusion_fwd_ms", "xla_fwd_samples_per_sec",
                    "pallas_fwd_samples_per_sec", "full_fusion_fwd_samples_per_sec",
                    "speedup", "full_fusion_speedup_vs_pairs", "max_abs_diff",
                    "full_fusion_max_abs_diff"}
VQ_OP_KEYS = {"bench", "n", "k", "d", "tile_n", "xla_us", "pallas_us", "speedup"}
VQ_STEP_KEYS = {"bench", "vq_use_pallas", "batch", "n_win", "step_ms",
                "samples_per_sec_per_chip"}
GEN_SCAN_KEYS = {"path", "platform", "batch", "dtype", "gen_steps", "wall_s",
                 "samples_per_sec_per_stream", "rtf_16k", "aggregate_samples_per_sec",
                 "compile_s"}
MFCC_KEYS = [{"bench", "path", "batch", "wav_samples", "frames_per_call", "us_per_call",
              "frames_per_sec", "audio_samples_per_sec"},
             {"bench", "path", "frames_per_sec", "audio_samples_per_sec", "device_speedup"},
             {"bench", "path", "train_samples_per_sec_assumed", "frames_per_sec_needed",
              "isolated_capacity_fraction"}]
CKPT_KEYS = {"metric", "params_mb", "blocking_save_sec", "async_save_return_sec",
             "async_final_drain_sec", "pause_reduction"}
PROBE_KEYS = {"k", "batch", "n_win", "rtt_scalar_get_ms", "assemble_block_ms",
              "block_mbytes", "put_block_ms", "dispatch_ms", "block_compute_rest_ms",
              "compute_sps", "metrics_fetch_ms"}
ABLATE_LABELS = ("cond fwd", "cond fwd+bwd", "dec fwd", "dec fwd+bwd", "loss fwd",
                 "loss fwd+bwd")
CONV_KEYS = {"steps", "xla_first_last", "pallas_first_last", "max_abs_ce_diff",
             "mean_abs_ce_diff"}
# NVIDIA H100 SXM data sheet: dense peaks and the memory rate
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# and its shared memory: 132 SMs, each reading 128 bytes a clock at the
# 1.98 GHz boost clock
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
# every kernel of the Hopper tile core, as the ptxas report names them
# (wg_fwd_kernel<NL, STAGED>: K1b, K1, K1 with its epilogue staged;
# wg_same_kernel: K1b's three-tap mode;
# wg_bwd_kernel<NL, REC>: K2b saved y, K2, K2b's recompute mode)
HOPPER_KERNELS = ("wg_fwd_kernel<1, false>", "wg_fwd_kernel<2, false>",
                  "wg_fwd_kernel<2, true>", "wg_same_kernel", "wg_bwd_kernel<1, false>",
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
    """The card's name and power limit as nvidia-smi reports them."""
    from ae_wavenet_tpu_torch.utils.device import card_line as line

    return line("cuda")


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
    post_ops = 2 * batch * (wcfg.n_skp * wcfg.n_post + wcfg.n_post * wcfg.n_out)
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


def max_abs_rel(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    d = float((got.float() - want.float()).abs().max())
    return d, d / max(float(want.float().abs().max()), 1e-30)


def compare_outputs(got, want) -> tuple[float, float]:
    """Largest (abs, rel) error over every output tensor."""
    worst = (0.0, 0.0)
    for g, w in zip(got, want):
        e = max_abs_rel(g, w)
        worst = (max(worst[0], e[0]), max(worst[1], e[1]))
    return worst


def segment_tolerance(name: str) -> float:
    """The tolerance of ``segment_calls``'s case ``name`` against its plain
    version on the same inputs."""
    return DRIFT_REL_TOL if name.startswith("gated_stack_fused") else SEGMENT_REL_TOL


def mol_param_err(mix_a, mix_b, n_mix: int) -> float:
    """The largest mixture difference of each group (logits, means,
    log-scales) over that group's largest magnitude in ``mix_b``."""
    return max(max_abs_rel(mix_a[..., g * n_mix:(g + 1) * n_mix],
                           mix_b[..., g * n_mix:(g + 1) * n_mix])[1] for g in range(3))


def vq_codes_agree(z, e, codes, ref) -> bool:
    """Under 1% of the rows (none below 100 rows) on another code than
    ``ref``'s, each of them a tie to within VQ_TIE_TOL of the row's largest
    distance."""
    import torch

    differ = torch.nonzero(codes != ref)[:, 0]
    ed = e.double()
    d2 = ed.square().sum(1)[None] - 2.0 * z[differ].double() @ ed.t()
    gaps = (d2.gather(1, codes[differ, None]) - d2.gather(1, ref[differ, None])).abs()
    return (len(differ) < max(1, len(codes) // 100)
            and bool((gaps[:, 0] <= VQ_TIE_TOL * d2.abs().amax(1)).all()))


def vq_sums_err(z, codes, sums) -> tuple[float, float]:
    """``max_abs_rel`` of the VQ sums against float64 sums of ``z`` over
    ``codes``."""
    import torch

    want = torch.zeros(sums.shape, dtype=torch.float64, device=z.device).index_add_(
        0, codes.long(), z.double())
    return max_abs_rel(sums, want)


# ------------------------------------------------- the gated kernels' inputs

def random_stack(cfg, batch: int, t_out: int, seed: int, dev):
    """(wavenet with every bias ~ N(0, 0.3^2), x_ids, cond, speaker ids)."""
    import torch

    from ae_wavenet_tpu_torch.models import wavenet as twn

    gen = torch.Generator().manual_seed(seed)
    wn = twn.WaveNet(cfg, gen)
    with torch.no_grad():
        for name, p in wn.named_parameters():
            if name.endswith(".b"):
                p.normal_(0.0, 0.3, generator=gen)
    t_in = t_out + twn.receptive_field(cfg)
    ids = torch.randint(0, cfg.n_quant, (batch, t_in), generator=gen)
    cond = torch.randn(batch, cfg.n_lc_out, t_in, generator=gen) * 0.5
    spk = torch.randint(0, cfg.n_speakers, (batch,), generator=gen)
    return wn.to(dev), ids.to(dev), cond.to(dev), spk.to(dev)


# K1b's three-tap mode at WaveGlow's cell (serve.waveglow_22k.b16): 16 rows of
# 512 mel frames x 256 samples in groups of 8, 256 channels, 8 layers a WN
# whose cond projection is 640 -> 8 x 512; the layer timed and its dilation
FLOW_B, FLOW_P, FLOW_W, FLOW_COND, FLOW_LAYERS = 16, 16384, 256, 640, 8
FLOW_LAYER, FLOW_DD = 3, 8


def three_tap_inputs(batch: int, rows: int, width: int, seed: int, dev, addend: bool = True,
                     n_cond: int = FLOW_COND, layers: int = FLOW_LAYERS,
                     layer: int = FLOW_LAYER) -> dict:
    """K1b's three-tap mode's inputs (n_res = n_dil = n_skp = ``width``):
    x bf16, skip f32, w_in [3 width, 2 width], b_in, w_out, b_out and, with
    ``addend``, the layer's 2 width-wide slice of one cond projection
    [n_cond -> layers x 2 width] of a seeded c [B, P, n_cond], as WaveGlow's
    WN takes it."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, sd=1.0):
        return (torch.randn(*shape, generator=gen) * sd).to(dev)

    w = width
    out = {"x": rnd(batch, rows, w, sd=0.7).to(torch.bfloat16), "skip": rnd(batch, rows, w),
           "w_in": rnd(3 * w, 2 * w, sd=(3 * w) ** -0.5), "b_in": rnd(2 * w, sd=0.3),
           "w_out": rnd(w, 2 * w, sd=w ** -0.5), "b_out": rnd(2 * w, sd=0.3), "addend": None}
    if addend:
        c = rnd(batch, rows, n_cond).to(torch.bfloat16)
        proj = rnd(n_cond, layers * 2 * w, sd=n_cond ** -0.5).to(torch.bfloat16)
        out["addend"] = (c @ proj[:, layer * 2 * w : (layer + 1) * 2 * w]).contiguous()
    return out


def three_tap_call(fn, inp: dict, dd: int):
    """``fn`` (the kernel's wrapper or its plain version) on copies of the
    inputs it updates in place: -> (x', skip)."""
    return fn(inp["x"], None, inp["skip"].clone(), inp["w_in"], inp["b_in"], inp["w_out"],
              inp["b_out"], dd=dd, r0=0, addend=inp["addend"])


def phase_three_tap(card: str, dev) -> dict:
    """K1b's three-tap mode timed at WaveGlow's cell shape beside its bound
    and its plain version, and held to it (rows next to both ends among
    them)."""
    import torch

    from ae_wavenet_tpu_torch.ops import gated, gated_cuda as gc

    inp = three_tap_inputs(FLOW_B, FLOW_P, FLOW_W, 0, dev)
    got = three_tap_call(gc.gated_layer_fused, inp, FLOW_DD)
    want = three_tap_call(gated.gated_layer_fused_reference, inp, FLOW_DD)
    _, rel = compare_outputs(got, want)
    check(rel < SEGMENT_REL_TOL and gc.gated_layer_fused.taps == 3,
          f"three-tap K1b: an output {rel:.4g} from the plain version's, of its largest; "
          f"taps {gc.gated_layer_fused.taps}")
    skip = inp["skip"].clone()
    k_ms = cuda_ms(lambda: gc.gated_layer_fused(inp["x"], None, skip, inp["w_in"], inp["b_in"],
                                                inp["w_out"], inp["b_out"], dd=FLOW_DD, r0=0,
                                                addend=inp["addend"]), 5)
    p_ms = cuda_ms(lambda: three_tap_call(gated.gated_layer_fused_reference, inp, FLOW_DD), 1)
    n = FLOW_B * FLOW_P
    ops = 2 * n * (3 * FLOW_W * 2 * FLOW_W + FLOW_W * 2 * FLOW_W)
    n_bytes = tensor_bytes(inp["x"], inp["w_in"], inp["w_out"], inp["addend"]) + \
        2 * tensor_bytes(inp["skip"]) + tensor_bytes(got[0])
    b_ms, by = bound(n_bytes, {"bf16": ops})
    print(f"[three-tap] K1b's three-tap mode B={FLOW_B} P={FLOW_P} width {FLOW_W} dd {FLOW_DD} "
          f"with the addend: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms "
          f"by {by}, {100 * b_ms / k_ms:.1f}% of the bound; every output within {rel:.3g} of "
          f"the plain version's largest | {card}")
    return {"kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "rel": rel}


def segment_inputs(wn, cfg, ids, cond, spk, seed: int = 0):
    """The stack's operands from a plain saved forward: (dils, x0, cond_tm,
    packed, xs, ys) plus random upstream cotangents (gxcur, gxprev, gskip,
    gcond) of the stack's shape."""
    import torch

    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.ops.fastgen import with_gc

    bf16 = torch.bfloat16
    dils = gated.stack_dils(cfg)
    with torch.no_grad():
        x0 = wn.embed[ids].to(bf16).contiguous()
        cond_tm = with_gc(wn, cfg, cond, spk).permute(0, 2, 1).to(bf16).contiguous()
        packed = [tuple(t.detach().contiguous() for t in pk)
                  for pk in gated.pack_stack_weights(wn, cfg)]
        sched = gated.Schedule(dils, True, False, gated.PLAIN)
        _, xs, ys = gated.run_forward(sched, x0, cond_tm, packed, save=True)
    gen = torch.Generator(device=x0.device).manual_seed(seed)

    def rnd(shape, dtype, scale):
        return (torch.randn(shape, generator=gen, device=x0.device) * scale).to(dtype)

    b, p, r = x0.shape
    cot = dict(gxcur=rnd((b, p, r), bf16, 0.1), gxprev=rnd((b, p, r), bf16, 0.1),
               gskip=rnd((b, p, cfg.n_skp), bf16, 0.1),
               gcond=rnd((b, p, cond_tm.shape[-1]), torch.float32, 0.1))
    return dils, x0, cond_tm, packed, xs, ys, cot


def skip0(x0, packed, seed: int):
    """A random incoming skip [B, P, n_skp] f32."""
    import torch

    gen = torch.Generator(device=x0.device).manual_seed(seed)
    return torch.randn(*x0.shape[:2], packed[0][3].shape[0] - x0.shape[2],
                       generator=gen, device=x0.device)


def segment_calls(dils, cond_tm, packed, xs, ys, cot, skip_seed: int = 1):
    """{kernel name: (wrapper name, call(fn))} for one segment each, chosen
    where the schedule is hardest: the pair and the single layer with the
    largest dilation (the forward's halo spans the most rows) and a pair
    and a single layer below the top, so the upstream prev-tap cotangent
    (prev_dd) is read; the whole stack from x0 into a random incoming skip,
    saving everything and saving nothing; and groups of up to 5 and of 3
    layers below the top that end on the largest dilation.  Besides, the
    pair of the schedule below the top whose layer 2 reaches least far, under
    one tile (the prev-tap carry from the tile above, which the pair
    backward hands between its two tiles in flight), forward and backward:
    the pair forward's layer 2 reads rows of mid that layer 1 stored from
    the same tile.  Every call returns a flat tuple of tensors."""
    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.ops.gated_cuda import TM

    n = len(dils)
    vl = lambda i: gated.valid_lo(dils, i)  # noqa: E731
    top = n - 2 if n % 2 == 0 else n - 3   # the last pair of the schedule
    mid = max(top - 2, 0)
    near = max((i for i in range(0, top, 2) if dils[i + 1] < TM), default=mid)
    skip = skip0(xs[0], packed, skip_seed)

    def fresh(d):
        return {k: v.clone() for k, v in d.items()}

    def pair_fwd(fn, i=top):
        return fn(xs[i], cond_tm, skip.clone(), packed[i], packed[i + 1],
                  dd1=dils[i], dd2=dils[i + 1], r0=vl(i), save_y=True)

    def layer_fwd(fn):
        i = n - 1
        return fn(xs[i], cond_tm, skip.clone(), *packed[i], dd=dils[i],
                  r0=vl(i), save_y=True)

    def pair_bwd(fn, i=mid):
        c = fresh(cot)
        return fn(xs[i], xs[i + 1], cond_tm, c["gxcur"], c["gxprev"],
                  c["gskip"], c["gcond"], packed[i], packed[i + 1],
                  ys[i], ys[i + 1], dd1=dils[i], dd2=dils[i + 1],
                  prev_dd=dils[i + 2], valid_lo1=vl(i),
                  valid_lo2=vl(i + 1), cur_valid_lo=vl(i + 2))

    def layer_bwd(fn, saved=True):
        c, i = fresh(cot), n - 2
        w_in, b_in, w_out, _ = packed[i]
        return fn(xs[i], cond_tm, c["gxcur"], c["gxprev"], c["gskip"],
                  c["gcond"], w_in, w_out, b_in, dd=dils[i], prev_dd=dils[i + 1],
                  valid_lo=vl(i), cur_valid_lo=vl(i + 1),
                  y_saved=ys[i] if saved else None)

    def stack_fwd(fn, save=True):
        out, mids, ys_all = fn(xs[0], cond_tm, skip.clone(), packed, dils=dils,
                               r0=vl(0), save_y=save, save_mids=save)
        return (out, *mids, *ys_all)

    # the first layer below the top with the largest dilation ends the groups
    hi = max(range(n - 1), key=lambda i: (dils[i], -i)) if n > 1 else 0

    def group_bwd(fn, size):
        c, i, k = fresh(cot), max(hi + 1 - size, 0), hi + 1
        return fn(tuple(xs[i:k]), cond_tm, c["gxcur"], c["gxprev"], c["gskip"],
                  c["gcond"], tuple(packed[i:k]), tuple(ys[i:k]),
                  dds=tuple(dils[i:k]), prev_dd=dils[k],
                  valid_los=tuple(vl(m) for m in range(i, k)), cur_valid_lo=vl(k))

    return {
        "gated_stack_fused": ("gated_stack_fused", stack_fwd),
        "gated_stack_fused_no_save": (
            "gated_stack_fused", lambda fn: stack_fwd(fn, save=False)),
        "gated_group_bwd": ("gated_group_bwd", lambda fn: group_bwd(fn, 5)),
        "gated_group_bwd_3": ("gated_group_bwd", lambda fn: group_bwd(fn, 3)),
        "gated_pair_fused": ("gated_pair_fused", pair_fwd),
        "gated_pair_fused_near": ("gated_pair_fused", lambda fn: pair_fwd(fn, near)),
        "gated_layer_fused": ("gated_layer_fused", layer_fwd),
        "gated_pair_bwd": ("gated_pair_bwd", pair_bwd),
        "gated_pair_bwd_near": ("gated_pair_bwd", lambda fn: pair_bwd(fn, near)),
        "gated_layer_bwd": ("gated_layer_bwd", layer_bwd),
        "gated_layer_bwd_recompute": (
            "gated_layer_bwd", lambda fn: layer_bwd(fn, saved=False)),
    }


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
    check(len(sampler) == 4, f"ptxas report lists the sampler kernels {sampler} (bf16, "
          f"int8, int4 and the mixture-of-logistics tail)")
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
    from ae_wavenet_tpu_torch.ops import fastgen_cuda as fc
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    cfg = chorowski_config()
    wcfg = cfg.wavenet
    gen = torch.Generator().manual_seed(0)
    model = ae.init(cfg, gen, dev).eval()
    with torch.no_grad():
        model.wavenet.post2["w"].mul_(POST2_SCALE)
    rf = sum(wcfg.dilations)
    n_cond = wcfg.n_lc_out + wcfg.n_global_embed
    plans = {m: fc.device_plan(wcfg, m, dev) for m in (None, "int8", "int4")}
    for m, pl in plans.items():
        print(f"[kernel] share plan {m or 'bf16'}: {pl.n_blocks} blocks, columns "
              f"{[pl.n_cols(n, 0) for n in fc.SHARES]} ({'/'.join(fc.SHARES)}) of "
              f"block 0, {pl.resident_bytes} B of weights resident per block "
              f"({pl.resident_layers} of {len(wcfg.dilations)} layers + post-net), "
              f"{pl.smem_bytes} B of shared memory | {card}")
    packs = {"bf16": fc.pack_for_kernel(model.wavenet, wcfg),
             **{m: fc.PACKERS[m](model.wavenet, wcfg) for m in ("int8", "int4")}}
    out = {name: {"max_abs_err": 0.0, "by_batch": {}} for name in packs}

    # time per generated step, every kernel and every plain version, on a
    # random ring; all from this one call.  At B = 1 also one launch as long
    # as the CLI request's.  The SM clock is block 0's clock cycles over the
    # instrumented launch's time.  max_abs_err: the largest |logit
    # difference| from the plain version over each row's agreeing prefix of
    # PLAIN_T greedy steps from the same ring.
    for k, bb in enumerate((1, 8, BATCH)):
        t_len = max(TIMED_T, CLI_SAMPLES if bb == 1 else 0)
        ring = torch.randn(rf, bb, wcfg.n_res, generator=gen).to(dev, torch.bfloat16)
        prev = torch.randint(0, wcfg.n_quant, (bb,), generator=gen).to(dev)
        cnd = (torch.randn(bb, n_cond, t_len, generator=gen) * 0.3).to(dev)
        for name, pk in packs.items():
            mode = None if name == "bf16" else name
            (ids_k, _, _, lg_k), (ids_r, _, _, lg_r) = (
                fn(pk, wcfg, ring.clone(), prev, 0, cnd[..., :PLAIN_T], 0, 0.0, True, mode)
                for fn in (fc.generate_fused, fc.generate_fused_reference))
            _, err = compare(ids_k, lg_k, ids_r, lg_r)
            rel = err / float(lg_r.abs().max())
            check(rel < LOGIT_REL_TOL[mode],
                  f"{name} B={bb}: logits max|d| {err:.4g} from the plain version")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)

            def gen_ms(steps, reps, clk=None):
                return cuda_ms(lambda: fc.generate_fused(
                    pk, wcfg, ring, prev, 0, cnd[..., :steps], 5, 1.0, quantized=mode,
                    clocks=clk), reps) / steps

            k_ms = gen_ms(TIMED_T, 3)
            p_ms = cuda_ms(lambda: fc.generate_fused_reference(
                pk, wcfg, ring, prev, 0, cnd[..., :PLAIN_T], 5, 1.0, quantized=mode),
                1) / PLAIN_T
            b_ms, by = sampler_bound(pk, wcfg, plans[mode], bb, mode)
            print(f"[kernel] {name} B={bb}: kernel {k_ms:.4f} ms/step at T={TIMED_T} "
                  f"a launch (PR 5's cluster design: {PR5_MS[name][k]}), plain "
                  f"{p_ms:.4f} ms/step ({bb / k_ms * 1e3:.0f} vs {bb / p_ms * 1e3:.0f} "
                  f"samples/s); bound {b_ms:.5f} ms/step by {by}, "
                  f"{100 * b_ms / k_ms:.2f}% of it; logits max|d| from the plain "
                  f"version {err:.4g} ({rel:.3g} of max |logits|) | {card}")
            out[name]["by_batch"][bb] = {
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by}
            # where a step's time goes: block 0's clock cycles in all, in the
            # grid barriers (arrival to release) and in the layers' GEMMs
            for steps in sorted({TIMED_T, t_len}):
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
            if t_len > TIMED_T:
                l_ms = gen_ms(t_len, 1)
                out[name]["by_batch"][bb]["ms_cli_launch"] = l_ms
                print(f"[kernel] {name} B={bb}: kernel {l_ms:.4f} ms/step at T={t_len} "
                      f"a launch (the CLI request's) | {card}")
    return out


def phase_mol(card: str, dev) -> dict:
    """The mixture-of-logistics sampler (``fastgen_kernel<3>``) at the MoL
    cell's published widths and batch: 30 layers at 512, 18 resident and 12
    streamed through L2, B = 64 on a random ring: its time a step beside its
    bound and its plain version's; max_abs_err, the largest difference of
    the first step's mixture parameters from the plain version's."""
    import torch

    from ae_wavenet_tpu_torch.models import wavenet as twn
    from ae_wavenet_tpu_torch.ops import fastgen_cuda as fc
    from ae_wavenet_tpu_torch.utils import config as tcfg

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), MOL_CONFIG)) as f:
        cfg = tcfg.from_json(f.read()).wavenet
    n_layers = len(cfg.dilations)
    plan = fc.device_plan(cfg, None, dev)
    print(f"[mol] share plan: {plan.n_blocks} blocks, {plan.resident_layers} of {n_layers} "
          f"layers resident, {plan.streamed_bytes} B of layer shares streamed a step, "
          f"{plan.smem_bytes} B of shared memory | {card}")
    gen = torch.Generator().manual_seed(20)
    packed = fc.pack_for_kernel(twn.WaveNet(cfg, gen).to(dev), cfg)
    ring = (torch.randn(sum(cfg.dilations), MOL_B, cfg.n_res, generator=gen)
            * 0.5).to(dev, torch.bfloat16)
    prev = (torch.rand(MOL_B, generator=gen) - 0.5).to(dev)
    cond = (torch.randn(MOL_B, cfg.n_lc_out, MOL_TIMED_T, generator=gen) * 0.3).to(dev)
    launches = fc.generate_fused.mol_launches
    with f32_numerics():
        mix_k, mix_p = (fn(packed, cfg, ring.clone(), prev, 3, cond[..., :1], 5, 1.0,
                           True)[3] for fn in (fc.generate_fused,
                                               fc.generate_fused_reference))
        err = float((mix_k - mix_p).abs().max())
        rel = mol_param_err(mix_k, mix_p, cfg.n_mix)
        check(rel < MOL_PARAM_TOL, f"mol: the first step's mixture {rel:.4g} from the plain "
              f"version's, of each group's largest")
        k_ms = cuda_ms(lambda: fc.generate_fused(packed, cfg, ring, prev, 3, cond, 5, 1.0),
                       3) / MOL_TIMED_T
        p_ms = cuda_ms(lambda: fc.generate_fused_reference(
            packed, cfg, ring, prev, 3, cond[..., :PLAIN_T], 5, 1.0), 1) / PLAIN_T
    b_ms, by = sampler_bound(packed, cfg, plan, MOL_B, None)
    print(f"[mol] B={MOL_B}: kernel {k_ms:.4f} ms/step at T={MOL_TIMED_T} a launch "
          f"({MOL_B / k_ms * 1e3:.0f} samples/s), plain {p_ms:.4f} ms/step; bound "
          f"{b_ms:.5f} ms/step by {by}, {100 * b_ms / k_ms:.2f}% of it; the first "
          f"step's mixture max|d| from the plain version {err:.4g} ({rel:.3g} of its "
          f"group's largest) | {card}")
    return {"launches": fc.generate_fused.mol_launches - launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by}


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
    """The fused VQ lookup timed on the encoder's own latents
    (``vq_cases``); max_abs_err: its sums' largest difference from float64
    sums over its own codes."""
    from ae_wavenet_tpu_torch.ops import vq_cuda as vq

    e, cases = vq_cases(dev, data)
    out = {}
    for label, z in cases.items():
        n, (k, d) = z.shape[0], e.shape
        got = vq.vq_lookup_fused(z, e)
        codes, ref = got[0].long(), vq.vq_lookup_reference(z, e)[0].long()
        n_diff = int((codes != ref).sum())
        err, rel = vq_sums_err(z, codes, got[3])
        check(vq_codes_agree(z, e, codes, ref) and rel <= VQ_SUM_TOL,
              f"vq {label}: {n_diff} codes differ, sums {rel:.4g} from float64's")
        t = vq_times(z, e)
        p_ms = cuda_ms(lambda: vq.vq_lookup_reference(z, e), VQ_TIMING_REPS)
        b_ms, by = bound(tensor_bytes(z, e, got), {"f32": 2 * n * k * d})
        print(f"[vq] {label}: N={n} K={k} D={d}: kernel: {vq_times_line(t)}; plain "
              f"{p_ms:.4f} ms; bound {b_ms:.6f} ms by {by}; {n_diff} codes differ from "
              f"the plain version's, sums max|d| {err:.4g} ({rel:.3g} of the largest) | {card}")
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

    def counts() -> dict:
        return {"bf16": fc.generate_fused.launches,
                "int8": fc.generate_fused.launches_int8,
                "int4": fc.generate_fused.launches_int4,
                "vq": vq.vq_lookup_fused.launches,
                "plain": fc.generate_fused_reference.launches
                + vq.vq_lookup_reference.launches, **_graph_counts()}

    def run_cli(ckpt_path: str, *flags) -> tuple[dict, str]:
        """One request through the generate CLI with the counters set to 0
        just before and read just after: -> (launches and prime's passes,
        the timing line)."""
        zero_launch_counts()
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
    check(got1 == {"bf16": 1, "int8": 0, "int4": 0, "vq": 0, "plain": 0,
                   "prime": 1, "rollout": 0, "eager": 0},
          f"bf16 CLI launches {got1}")

    ds = PackedDataset(data)
    wav64 = np.stack([ds.clip(i, BATCH_WAV_LEN) for i in range(BATCH)])
    spk = torch.from_numpy(ds.speakers[:BATCH].astype(np.int64)).to(dev)
    model = ae.init(cfg, torch.Generator().manual_seed(1), dev).eval()
    timings: dict = {}
    g0 = _graph_counts()
    ids, start = ae.reconstruct(model, cfg, torch.from_numpy(wav64).to(dev), spk,
                                torch.Generator().manual_seed(2), temperature=1.0,
                                n_samples=BATCH_SAMPLES, timings=timings)
    torch.cuda.synchronize()
    g64 = {k: v - g0[k] for k, v in _graph_counts().items()}
    check(g64 == {"prime": 1, "rollout": 0, "eager": 0},
          f"reconstruct B={BATCH}: prime's passes / eager steps {g64}")
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
          f"launches: {p1 + p64}; prime in one pass: {got1['prime']} and "
          f"{g64['prime']} passes, no eager step | {card}")
    del model

    # quantized serving from the checkpoint that asks for the fused VQ lookup:
    # exactly one launch of the quantized sampler and one of the VQ kernel
    launches = {"bf16": k1 + k64, "vq": 0}
    for mode in ("int8", "int4"):
        got, line = run_cli(ckpt_vq, "--" + mode)
        want = {"bf16": 0, "int8": 0, "int4": 0, "vq": 1, "plain": 0, mode: 1,
                "prime": 1, "rollout": 0, "eager": 0}
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
    """Each gated kernel at the training path's shape (every block of the
    card at work, rows handed between blocks, the full split-K), timed
    beside its plain version, its bound and, for the pairs, a cuBLAS
    yardstick; max_abs_err, the largest difference of any of its outputs
    from the plain version's on the same inputs.  Then the whole stack
    timed under each schedule."""
    import torch

    from ae_wavenet_tpu_torch.ops import gated, gated_cuda as gc
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    wcfg = chorowski_config().wavenet
    wn, ids, cond, spk = random_stack(wcfg, TRAIN_B, TRAIN_WIN, 1, dev)
    dils, x0, cond_tm, packed, xs, ys, cot = segment_inputs(wn, wcfg, ids, cond, spk)
    win_macs = (x0.shape[2] * 2 + cond_tm.shape[2]) * 2 * wcfg.n_dil
    macs = win_macs + wcfg.n_dil * (wcfg.n_res + wcfg.n_skp)  # per row and layer
    errs, times, yardsticks = {}, {}, {}
    for name, (wrapper, call) in segment_calls(dils, cond_tm, packed, xs, ys,
                                               cot).items():
        if name not in (wrapper, "gated_layer_bwd_recompute"):
            continue  # the other cases are variants that the card tests hold
        kern, plain = getattr(gc, wrapper), getattr(gated, wrapper + "_reference")
        errs[name], rel = compare_outputs(call(kern), call(plain))
        check(rel < segment_tolerance(name), f"{name}: an output {rel:.4g} from the "
              f"plain version's, of its largest")
        # the case with the copies of the inputs that it updates in place,
        # the plain version likewise, then the wrapper alone on one set of
        # inputs (those it updates just accumulate)
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
        timing = (f"{n_layers} layer(s): kernel {k_ms:.3f} ms ({kc_ms:.3f} with the "
                  f"case's input copies), plain {p_ms:.3f} ms, "
                  f"bound {b_ms:.3f} ms by {by}, {100 * b_ms / k_ms:.1f}% of the bound; "
                  f"every output within {errs[name]:.4g} of the plain version's "
                  f"({rel:.3g} of its largest)")
        if wrapper == "gated_pair_bwd":
            timing += f"; {gc.gated_pair_bwd.tiles_in_flight} tiles in flight"
        if wrapper == "gated_pair_fused":
            timing += (f"; gated_pair_fused.staged_epilogue "
                       f"{gc.gated_pair_fused.staged_epilogue}")
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
        print(f"[train-kernels] {name} B={TRAIN_B} t_in={x0.shape[1]}: {timing} "
              f"| {card}")
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


def _path_run(argv, expect: dict, card: str, label: str, steps: int):
    """One CLI run of ``steps`` training steps with every launch counter
    and the training step's counters set to 0 just before it and read just
    after: the step captured once and replayed ``steps`` times, no eager
    step; each gated kernel and the VQ kernel launched exactly
    ``expect[name]`` times (0 unless given; the capture's warm-up step
    counts, see ``warm_steps``) and no plain version at all.  -> (train records,
    launches by kernel, the run's peak GiB, every record)."""
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
    _zero_train_counts()
    torch.cuda.reset_peak_memory_stats()
    recs = _run_cli(argv)
    torch.cuda.synchronize()
    got = {f.__name__: f.launches for f in kernels}
    got["gated_layer_bwd_recompute"] = gc.gated_layer_bwd.launches_recompute
    plain_runs = {f.__name__: f.launches for f in plain}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step = _train_counts()
    check(step == {"replays": steps, "captures": 1, "eager": 0},
          f"{label}: training step counters {step}, expected {steps} replays of one "
          "capture and no eager step")
    check(got == expect, f"{label}: kernel launches {got}, expected {expect}")
    check(not any(plain_runs.values()), f"{label}: plain versions ran {plain_runs}")
    check(barriers_at_zero(), f"{label}: the VQ kernel's grid barrier is not at zero")
    print(f"[train] {label}: {step['replays']} replays of {step['captures']} captured "
          f"step, {step['eager']} eager steps; launches {got} (the warm-up's "
          f"{warm_steps()} step included); plain versions {plain_runs}; peak memory "
          f"{peak:.2f} GiB | {card}")
    return [r for r in recs if "loss" in r], got, peak, recs


def warm_steps(steps: int = 0, captures: int = 1) -> int:
    """``steps`` training steps run through ``captures`` captures: each
    capture runs ``chassis.WARMUP_STEPS`` eager steps first (their launches
    are real and counted; the training state is restored after them)."""
    from ae_wavenet_tpu_torch.training import chassis

    return steps + chassis.WARMUP_STEPS * captures


def _zero_train_counts() -> None:
    from ae_wavenet_tpu_torch.training import chassis

    f = chassis.train_step
    f.graph_replays = f.eager_steps = f.captures = 0


def _train_counts() -> dict:
    """The training step's replays, captures and eager steps since
    ``_zero_train_counts``."""
    from ae_wavenet_tpu_torch.training import chassis

    f = chassis.train_step
    return {"replays": f.graph_replays, "captures": f.captures, "eager": f.eager_steps}


def barriers_at_zero() -> bool:
    """Every grid barrier of the VQ kernel with its arrival count back at
    zero (csrc/vq.cu: the generation count moves on, the arrivals are
    reset by the last block in)."""
    import torch

    from ae_wavenet_tpu_torch.ops import vq_cuda

    torch.cuda.synchronize()
    return all(int(b[0]) == 0 for b in vq_cuda._BARRIERS.values())


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
    ``n_steps`` steps of ``Chassis.train`` (after one warm-up step), the
    step run eagerly (``train_step(eager=True)``: CUDA events cannot be
    read inside a replayed graph; the same kernels): host wall and loader
    wait per step, and device spans (CUDA events around the calls, ms per
    step) of the whole step, the forward and loss, the encoder, the
    upsampler, the stack's forward, the backward, the stack's backward and
    the optimizer."""
    import functools
    from unittest import mock

    import torch

    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.models import wavenet as twn
    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.training import chassis

    ch = chassis.Chassis(cfg, data, device=dev, log_stream=io.StringIO())
    eager = functools.partial(chassis.train_step, eager=True)
    with mock.patch.object(chassis, "train_step", eager):
        ch.train(1)
    ch.stats.clear()
    sp = _Spans()
    targets = [(chassis, "train_step", "step"), (ae, "loss_fn", "forward"),
               (ch.model.encoder, "forward", "encoder"),
               (twn, "upsample_apply", "upsampler"),
               (gated, "run_forward", "stack forward"),
               (torch.Tensor, "backward", "backward"),
               (gated, "run_backward", "stack backward"),
               (ch.opt, "update", "optimizer")]
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(chassis, "train_step", eager))
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
    print(f"[train] step split, {label} (B={TRAIN_B}, n_win={TRAIN_WIN}, 3 eager steps, "
          f"ms per step; device spans from CUDA events): host step {s['host step']:.1f}, "
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


def _tiles_in_flight(wcfg, label: str) -> str:
    """The pair backward's last launch kept two tiles in flight and the pair
    forward's staged its epilogue, as the plans from the widths say
    (``gated_cuda.bwd_plan``, ``gated_cuda.fwd_plan``)."""
    from ae_wavenet_tpu_torch.ops import gated_cuda as gc

    got = gc.gated_pair_bwd.tiles_in_flight
    want = gc.bwd_plan(wcfg.n_res, wcfg.n_dil, wcfg.n_skp)[0]
    check(got == want == 2, f"{label}: the pair backward kept {got} tiles in flight, "
          f"the plan {want}")
    staged = gc.gated_pair_fused.staged_epilogue
    plan = gc.fwd_plan(wcfg.n_res, wcfg.n_dil, wcfg.n_skp,
                       wcfg.n_lc_out + wcfg.n_global_embed)[0]
    check(staged == plan == 1, f"{label}: the pair forward's staged epilogue {staged}, "
          f"the plan {int(plan)}")
    return (f"the pair backward's tiles in flight {got}, the pair forward's staged "
            f"epilogue {staged}")


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
        expect(n_layers // 2, 0, warm_steps(TRAIN_STEPS)), card, "main path, new",
        TRAIN_STEPS)
    res, n_res, peak_res, _ = _path_run(
        ["resume", "--n-steps", str(RESUME_STEPS), "--data", data, "--log-every", "1",
         "--ckpt-dir", ckpt],
        expect(n_layers // 2, 0, warm_steps(RESUME_STEPS)), card, "main path, resume",
        RESUME_STEPS)
    wall = time.perf_counter() - t0
    peak = max(peak_new, peak_res)
    tiles_text = _tiles_in_flight(cfg.wavenet, "main path")
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
          f"{TRAIN_WIN}); peak memory {peak:.2f} GiB; {tiles_text} | {card}")
    print(f"[train] main path (pairs): "
          f"{mfu_text(cfg, ae.make_window_spec(cfg, TRAIN_WIN), step_s)} | {card}")

    # the single-layer path (--no-gated-fuse-pairs --no-gated-save-y): K1b
    # forward, K2b's recompute mode backward; the same first step
    alt, n_alt, peak_alt, _ = _path_run(
        ["new", *shape, "--no-gated-fuse-pairs", "--no-gated-save-y", "--n-steps",
         str(TRAIN_STEPS), "--ckpt-dir", os.path.join(tmp, "ckpt_alt")],
        expect(0, n_layers, warm_steps(TRAIN_STEPS)), card, "single-layer path, new",
        TRAIN_STEPS)
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

    # K2b's saved-y mode: single layers with y saved (--no-gated-fuse-pairs
    # alone; gated_save_y is on by default): K1b forward, K2b saved-y backward
    sy, n_sy, peak_sy, _ = _path_run(
        ["new", *shape, "--no-gated-fuse-pairs", "--n-steps", str(TRAIN_STEPS),
         "--ckpt-dir", os.path.join(tmp, "ckpt_sy")],
        {"gated_layer_fused": n_layers * warm_steps(TRAIN_STEPS),
         "gated_layer_bwd": n_layers * warm_steps(TRAIN_STEPS)}, card,
        "single-layer path with saved y, new", TRAIN_STEPS)
    check(len(sy) == TRAIN_STEPS, f"saved-y single-layer run logged {len(sy)} steps")
    d_sy = abs(sy[0]["loss"] - new[0]["loss"])
    check(d_sy < LOSS_TOL, f"saved-y single-layer path: first-step loss {sy[0]['loss']} "
          f"vs the main path's {new[0]['loss']} (tol {LOSS_TOL})")
    step_sy = _median_step(sy)
    ce_sy = " ".join(f"{r['recon_ce']:.4f}" for r in sy)
    print(f"[train] single-layer path with saved y (--no-gated-fuse-pairs): first-step "
          f"loss {sy[0]['loss']:.6f} vs the main path's {new[0]['loss']:.6f} (|d| "
          f"{d_sy:.2g} < {LOSS_TOL}); recon_ce {ce_sy}; median step "
          f"{step_sy * 1e3:.1f} ms -> {TRAIN_B * TRAIN_WIN / step_sy:.0f} samples/s; "
          f"peak memory {peak_sy:.2f} GiB | {card}")

    # the main path again with the fused VQ lookup: once per step, and the
    # first step (same seed, same data) loses nothing to it
    ckpt_vq = os.path.join(tmp, "ckpt_vq")
    fused, n_vq, _, _ = _path_run(
        ["new", *shape, "--vq-use-pallas", "--n-steps", str(VQ_TRAIN_STEPS),
         "--ckpt-dir", ckpt_vq],
        {**expect(n_layers // 2, 0, warm_steps(VQ_TRAIN_STEPS)),
         "vq_lookup_fused": warm_steps(VQ_TRAIN_STEPS)},
        card, "main path with --vq-use-pallas, new", VQ_TRAIN_STEPS)
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
        return {"gated_stack_fused": warm_steps(steps) + 8 * evals,
                "gated_group_bwd": warm_steps(steps) * n_layers // GROUP}

    ws_new, n_ws, peak_ws, all_new = _path_run(
        ["new", *shape, "--gated-full-fusion", "--gated-bwd-group", str(GROUP),
         "--n-steps", str(TRAIN_STEPS), *runtime],
        expect_ws(TRAIN_STEPS, 0), card, "whole-stack path, new", TRAIN_STEPS)
    ws_res, n_ws_res, peak_ws_res, all_res = _path_run(
        ["resume", "--n-steps", str(RESUME_STEPS), "--data", data, "--log-every", "1",
         *runtime], expect_ws(RESUME_STEPS, TRAIN_STEPS), card,
        "whole-stack path, resume", RESUME_STEPS)
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
        {"gated_stack_fused": warm_steps(3), "gated_pair_bwd": warm_steps(3) * n_layers // 2},
        card, "--gated-full-fusion alone, new", 3)
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
          f"({step_alt / step_s - 1:+.1%}, {peak_alt:.2f} GiB); --no-gated-fuse-pairs "
          f"{step_sy * 1e3:.1f} ms ({step_sy / step_s - 1:+.1%}, {peak_sy:.2f} GiB) "
          f"| {card}")

    # two profiled steps of the main path and of the whole-stack path:
    # device time by kernel name
    def profiled(argv, expect_n, label, kernels, prof_dir):
        _, n, _, recs = _path_run(
            ["new", *shape, *argv, "--n-steps", "2", "--profile-steps", "2",
             "--profile-dir", os.path.join(tmp, prof_dir)], expect_n, card,
            f"{label} under --profile-steps 2", 2)
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

    n_prof_pairs = profiled([], expect(n_layers // 2, 0, warm_steps(2)), "main path (pairs)",
                            ("wg_fwd_kernel", "wg_bwd_kernel", "wg_dw_kernel"),
                            "prof_pairs")
    n_prof = profiled(["--gated-full-fusion", "--gated-bwd-group", str(GROUP)],
                      {"gated_stack_fused": warm_steps(2),
                       "gated_group_bwd": warm_steps(2) * n_layers // GROUP},
                      "whole-stack path", ("wg_stack_kernel", "wg_group_kernel"),
                      "prof")

    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_sz=TRAIN_B, n_win=TRAIN_WIN),
        wavenet=dataclasses.replace(cfg.wavenet, use_pallas_stack=True))
    _print_split(cfg, data, dev, "main path (pairs)", card)
    _print_split(dataclasses.replace(cfg, wavenet=dataclasses.replace(
        cfg.wavenet, gated_full_fusion=True, gated_bwd_group=GROUP)), data, dev,
        f"whole-stack path (full fusion, groups of {GROUP})", card)
    runs = (n_new, n_res, n_alt, n_sy, n_vq, n_ws, n_ws_res, n_ff, n_prof_pairs, n_prof)
    launches = {n: sum(r.get(n, 0) for r in runs)
                for n in (*GATED, "gated_layer_bwd_recompute", "vq_lookup_fused")}
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
    _zero_graph_counts()
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
    graph = _graph_counts()
    check(graph["eager"] == 0 and graph["prime"] > 0 and graph["rollout"] >= EVAL_SAMPLES,
          f"eval: prime's passes, the rollout's graph replays / eager steps {graph}")
    print(f"[eval] {json.dumps(ev)} | {card}")
    print(f"[eval] {json.dumps(q)} | {card}")
    print(f"[eval] cli/eval.py --quality: {EVAL_BATCHES} eval batches and "
          f"{EVAL_SAMPLES} free-running samples in {secs:.1f} s; VQ kernel launches "
          f"{n_vq}, plain {n_plain}; prime passes {graph['prime']}, rollout graph "
          f"replays {graph['rollout']}, no eager step | {card}")
    return {"launches": n_vq}


def zero_launch_counts() -> None:
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
    gc.gated_pair_bwd.tiles_in_flight = 0
    gc.gated_pair_fused.staged_epilogue = 0
    for name in ("launches", "launches_int8", "launches_int4", "mol_launches",
                 "streamed_bytes"):
        setattr(fc.generate_fused, name, 0)
    _zero_graph_counts()


def _zero_graph_counts() -> None:
    """prime's passes and positions, generate's graph replays and eager
    steps to 0."""
    from ae_wavenet_tpu_torch.ops import fastgen as fg

    fg.prime.passes = fg.prime.positions = 0
    fg.generate.graph_replays = fg.generate.eager_steps = 0


def _graph_counts() -> dict:
    """Since _zero_graph_counts: prime's passes, and the f32 rollout's
    (``generate``) steps replayed as a CUDA graph and in the eager step
    loop (none on the card outside phase 5's plain comparison)."""
    from ae_wavenet_tpu_torch.ops import fastgen as fg

    return {"prime": fg.prime.passes, "rollout": fg.generate.graph_replays,
            "eager": fg.generate.eager_steps}


def launch_counts() -> dict:
    """Every kernel's launches since zero_launch_counts, and the plain versions'
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
    got["eager"] = _graph_counts()["eager"]
    return got


def expect_launches(**kw) -> dict:
    """launch_counts() of a run that launched only the kernels given (and ran no
    eager step loop of the rollout)."""
    return {**dict.fromkeys(GATED, 0), "gated_layer_bwd_recompute": 0,
            "vq_lookup_fused": 0, "bf16": 0, "int8": 0, "int4": 0, "plain": 0,
            "eager": 0, **kw}


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
    expect = {"gated_pair_fused": n_pairs * warm_steps(TRAIN_STEPS),
              "gated_pair_bwd": n_pairs * warm_steps(TRAIN_STEPS)}
    t0 = time.perf_counter()
    new, n_new, peak_new, _ = _path_run(
        ["new", *shape, "--n-steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt], expect,
        card, "inverter, new", TRAIN_STEPS)
    expect = {"gated_pair_fused": n_pairs * warm_steps(RESUME_STEPS),
              "gated_pair_bwd": n_pairs * warm_steps(RESUME_STEPS)}
    res, n_res, peak_res, _ = _path_run(
        ["resume", "--n-steps", str(RESUME_STEPS), "--data", data, "--log-every", "1",
         "--ckpt-dir", ckpt], expect, card, "inverter, resume", RESUME_STEPS)
    wall = time.perf_counter() - t0
    last = TRAIN_STEPS + RESUME_STEPS
    tiles_text = _tiles_in_flight(chorowski_config().wavenet, "inverter")
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
          f"{TRAIN_WIN}); peak memory {peak:.2f} GiB; {tiles_text}; "
          f"{mfu_text(cfg, mi.make_window_spec(cfg, TRAIN_WIN), step_s)} | {card}")

    out = os.path.join(tmp, "inv.wav")
    launches = {"gated_pair_fused": n_new["gated_pair_fused"] + n_res["gated_pair_fused"],
                "gated_pair_bwd": n_new["gated_pair_bwd"] + n_res["gated_pair_bwd"]}
    for mode in ("bf16", "int8", "int4"):
        flags = [] if mode == "bf16" else ["--" + mode]
        zero_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = gen_cli.main(["--ckpt", ckpt_mod.checkpoint_path(ckpt, last), "--data",
                               data, "--clip", "0", "--n-samples", str(CLI_SAMPLES),
                               "--temperature", "1.0", *flags, "--out", out])
        torch.cuda.synchronize()
        got, text = launch_counts(), buf.getvalue()
        check(rc == 0, f"generate CLI on the inverter returned {rc}")
        check(got == expect_launches(**{mode: 1}), f"inverter {mode}: launches {got}")
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

    zero_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = eval_cli.main(["--ckpt-dir", ckpt, "--data", data, "--n-batches",
                            str(EVAL_BATCHES), "--quality", "--quality-samples",
                            str(EVAL_SAMPLES)])
    torch.cuda.synchronize()
    secs, got = time.perf_counter() - t0, launch_counts()
    check(rc == 0, f"eval CLI on the inverter returned {rc}")
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    check(len(recs) == 2, f"eval CLI printed {len(recs)} records")
    ev, q = recs
    check(ev["step"] == last and "eval_recon_ce" in ev and "eval_perplexity" not in ev,
          f"inverter eval record {ev}")
    check(all(k in q for k in QUALITY_KEYS) and q["n_scored"] == EVAL_SAMPLES
          and all(math.isfinite(v) for r in recs for v in r.values()
                  if isinstance(v, float)), f"inverter quality record {q}")
    check(got == expect_launches(gated_pair_fused=n_pairs * EVAL_BATCHES),
          f"inverter eval: launches {got}")
    print(f"[inverter] cli/eval.py --quality: {json.dumps(ev)}; {json.dumps(q)}; "
          f"{secs:.1f} s, pair forward launches {got['gated_pair_fused']} | {card}")
    launches["gated_pair_fused"] += got["gated_pair_fused"]
    return {"launches": launches}


def _finite(rec) -> bool:
    """Every float of a record, nested dicts and lists too, is finite."""
    if isinstance(rec, dict):
        return all(_finite(v) for v in rec.values())
    if isinstance(rec, list):
        return all(_finite(v) for v in rec)
    return not isinstance(rec, float) or math.isfinite(rec)


def _instrument(script, argv: list, expect: dict, card: str):
    """``python -m ae_wavenet_tpu_torch.scripts.<script> ARGV`` in this
    process (the module's ``main``), every launch counter at 0 just before
    it and checked exactly after it (``expect`` as ``expect_launches`` takes it),
    every record it printed finite.  -> (records printed, stdout, launches,
    seconds)."""
    import torch

    name = script.__name__.rsplit(".", 1)[-1]
    zero_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = script.main(argv)
    torch.cuda.synchronize()
    secs, got = time.perf_counter() - t0, launch_counts()
    check(rc == 0, f"{name} returned {rc}")
    text = buf.getvalue()
    recs = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    check(all(_finite(r) for r in recs), f"{name}: a non-finite record in {recs}")
    check(got == expect_launches(**expect), f"{name}: launches {got}, expected "
          f"{expect_launches(**expect)}")
    return recs, text, got, secs


def _held_keys(name: str, recs: list, want: dict) -> None:
    """Each record kind of ``want`` ({kind: (the key that marks it, keys it
    must carry)}) is among ``recs`` with those keys (the JAX script's)."""
    for kind, (mark, keys) in want.items():
        of_kind = [r for r in recs if mark in r]
        check(bool(of_kind) and all(set(keys) <= set(r) for r in of_kind),
              f"{name}: {kind} records {of_kind} lack some of {sorted(keys)}")


def phase_instruments(card: str, dev, tmp: str) -> dict:
    """The instruments (``ae_wavenet_tpu_torch/scripts``) at the flagship
    width, as a user runs them, a few steps each: ``long_run`` (an eval, a
    save and the probe), ``eval_quality --divergence`` and
    ``quality_quantized --step best`` (K4, K5, K6) on its checkpoints, the
    generate CLI three ways on one checkpoint (the same wav), ``diag_vq``,
    ``diag_vae --preset flagship`` and ``gain_ab``.  Each exits 0, writes
    the JAX script's record keys, every value finite, and launches exactly
    the kernels its path gives (K1 and K2 in training and eval)."""
    from ae_wavenet_tpu_torch.cli import generate as gen_cli
    from ae_wavenet_tpu_torch.eval.quality import QUALITY_KEYS
    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.scripts import (diag_vae, diag_vq, eval_quality, gain_ab,
                                              long_run, quality_quantized)
    from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod
    from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

    t_phase = time.perf_counter()
    pairs = len(gated.stack_dils(WaveNetConfig())) // 2
    eval_batches = 8  # Chassis.evaluate's default

    def trained(steps: int, evals: int, twins: int = 1) -> dict:
        """K1 and K2 launches of ``twins`` runs of ``steps`` steps (one
        capture each) and ``evals`` eval batches each, on the pair
        schedule."""
        return {"gated_pair_fused": twins * pairs * (warm_steps(steps) + evals),
                "gated_pair_bwd": twins * pairs * warm_steps(steps)}

    launches: dict = {}

    def add(got: dict) -> None:
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    # long_run: 16 steps on 8 clips; eval and save at 16; the probe
    work = os.path.join(tmp, "long_run")
    out = os.path.join(tmp, "long_run.jsonl")
    _, _, got, secs = _instrument(long_run, [
        "--steps", str(INSTR_STEPS), "--clips", str(INSTR_CLIPS), "--eval-every",
        str(INSTR_STEPS), "--ckpt-every", str(INSTR_STEPS), "--log-every", "8",
        "--quality-samples", str(INSTR_SAMPLES), "--workdir", work, "--out", out],
        trained(INSTR_STEPS, eval_batches), card)
    add(got)
    with open(out) as f:
        recs = [json.loads(ln) for ln in f]
    check(all(_finite(r) for r in recs), f"long_run: a non-finite record in {recs}")
    _held_keys("long_run", recs, {
        "header": ("run_config", ("steps", "batch", "n_win", "bottleneck", "fixture",
                                  "vq_k", "vq_groups", "latent_hz", "clips",
                                  "data_prefix", "t_start")),
        "train": ("samples_per_sec", ("step", "loss", "recon_ce", "bn_loss",
                                      "commitment", "perplexity", "restarts",
                                      "aux_frame_mse", "aux_frame_loss", "grad_norm")),
        "eval": ("eval_split", ("step", "eval_recon_ce", "eval_perplexity",
                                "eval_commitment", "eval_loss")),
        "probe": ("quality_holdout", ("step", "wall_s"))})
    probe = next(r for r in recs if "quality_holdout" in r)
    check(set(QUALITY_KEYS) | {"clips", "n_scored"} <= set(probe["quality_holdout"])
          and probe["quality_holdout"]["n_scored"] == INSTR_SAMPLES
          and [r["step"] for r in recs if "eval_split" in r] == [INSTR_STEPS],
          f"long_run: probe {probe}")
    ckpt = os.path.join(work, "ckpt")
    best = ckpt_mod.best_info(ckpt)
    check(best is not None and best[0] == INSTR_STEPS, f"long_run: BEST {best}")
    ce = " ".join(f"{r['recon_ce']:.4f}" for r in recs if "samples_per_sec" in r)
    print(f"[instruments] long_run: {INSTR_STEPS} steps on {INSTR_CLIPS} clips in "
          f"{secs:.1f} s (the fixture, the steps, one eval and save, the "
          f"{INSTR_SAMPLES}-sample probe in {probe['probe_s']} s); recon_ce "
          f"{ce}; probe "
          f"{json.dumps(probe['quality_holdout'])}; BEST {best} | {card}")

    # eval_quality --divergence, two temperatures, on that directory
    data = os.path.join(work, f"synth{INSTR_CLIPS}")
    recs, _, got, secs = _instrument(eval_quality, [
        "--ckpt-dir", ckpt, "--step", "best", "--data", data, "--clips", "0",
        "--n-samples", str(ROLLOUT_SAMPLES), "--divergence", "--temperatures", "1.0,0.0",
        "--nll-buckets", "4"], {}, card)
    check(len(recs) == 3 and recs[0]["best_checkpoint"]["step"] == INSTR_STEPS
          and set(recs[1]["divergence"]["temperatures"]) == {"1", "greedy"}
          and {"teacher_nll", "spectral_l2_vs_silence", "n_scored"}
          <= set(recs[1]["divergence"])
          and {"teacher_nll_mean", "free_nll_by_temp", "spectral_l2_by_temp"}
          <= set(recs[2]["summary"]), f"eval_quality: records {recs}")
    print(f"[instruments] eval_quality --divergence (1.0, greedy), {ROLLOUT_SAMPLES} "
          f"samples: {json.dumps(recs[2]['summary'])}; {secs:.1f} s | {card}")

    # quality_quantized in all three modes: K4, K5, K6 once each
    recs, _, got, secs = _instrument(quality_quantized, [
        "--ckpt-dir", ckpt, "--step", "best", "--data", data, "--clips", "0",
        "--n-samples", str(ROLLOUT_SAMPLES)], {"bf16": 1, "int8": 1, "int4": 1}, card)
    add(got)
    check([r.get("mode") for r in recs[1:-1]] == ["bf16", "int8", "int4"]
          and all({"clip", "spectral_l2", "spectral_l2_vs_silence", "n_scored"} <= set(r)
                  for r in recs[1:-1])
          and set(recs[-1]["summary"]["mean_spectral_l2"]) == {"bf16", "int8", "int4"},
          f"quality_quantized: records {recs}")
    print(f"[instruments] quality_quantized --step best: "
          f"{json.dumps(recs[-1]['summary'])}; {secs:.1f} s | {card}")

    # the generate CLI three ways on one checkpoint: one wav
    wavs = []
    path = ckpt_mod.checkpoint_path(ckpt, INSTR_STEPS)
    for source in (["--ckpt-dir", ckpt], ["--ckpt-dir", ckpt, "--step", str(INSTR_STEPS)],
                   ["--ckpt", path]):
        zero_launch_counts()
        wav = os.path.join(tmp, f"gen{len(wavs)}.wav")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = gen_cli.main([*source, "--data", data, "--clip", "0", "--n-samples",
                               str(ROLLOUT_SAMPLES), "--seed", "5", "--out", wav])
        got = launch_counts()
        check(rc == 0 and got == expect_launches(bf16=1), f"generate {source}: rc {rc}, "
              f"launches {got}")
        check(f"loaded step {INSTR_STEPS} " in buf.getvalue(),
              f"generate {source} loaded another step: {buf.getvalue()}")
        add(got)
        with open(wav, "rb") as f:
            wavs.append(f.read())
    check(wavs[0] == wavs[1] == wavs[2], "generate: --ckpt-dir, --ckpt-dir --step and "
          "--ckpt gave different wavs")
    print(f"[instruments] generate CLI by --ckpt-dir, --ckpt-dir --step {INSTR_STEPS} "
          f"and --ckpt: the same {len(wavs[0])}-byte wav; one bf16 launch each | {card}")

    # the twins: diag_vq (vq, ae, zero), diag_vae (vae, zero, ae), gain_ab
    diag = os.path.join(tmp, "diag")
    recs, _, got, secs = _instrument(
        diag_vq, ["--steps", str(DIAG_STEPS), "--workdir", diag],
        trained(DIAG_STEPS, eval_batches, twins=3), card)
    add(got)
    clouds = [r for r in recs if "at" in r]
    check([r["at"] for r in clouds] == ["init", f"step{DIAG_STEPS}"]
          and all({"frame_norm_mean", "cloud_rms_spread", "nearest_d2_mean",
                   "batch_perplexity", "batch_codes_used", "ema_counts_gt_thresh"}
                  <= set(r) for r in clouds)
          and {"summary", "conditioning_gain_nats", "vq_gap_to_continuous"}
          <= set(recs[-1]), f"diag_vq: records {clouds}, {recs[-1]}")
    print(f"[instruments] diag_vq, {DIAG_STEPS} steps a twin: {json.dumps(clouds[-1])}; "
          f"{json.dumps(recs[-1])}; {secs:.1f} s | {card}")

    recs, _, got, secs = _instrument(
        diag_vae, ["--preset", "flagship", "--steps", str(DIAG_STEPS), "--workdir",
                     diag], trained(DIAG_STEPS, eval_batches, twins=3), card)
    add(got)
    _held_keys("diag_vae", recs, {
        "vae": ("kl_per_frame", ("kind", "steps", "final_eval_recon_ce", "active_units",
                                 "n_dims", "mu_var", "free_nats", "kl_anneal_steps",
                                 "aux_weight", "kl_trend", "active_trend")),
        "summary": ("summary", ())})
    check({"vae_conditioning_gain_nats", "continuous_conditioning_gain_nats",
           "vae_gap_to_continuous", "active_units", "n_dims", "collapsed"}
          <= set(recs[-1]["summary"]), f"diag_vae: summary {recs[-1]}")
    print(f"[instruments] diag_vae --preset flagship, {DIAG_STEPS} steps a twin: "
          f"{json.dumps(recs[-1])}; {secs:.1f} s | {card}")

    recs, _, got, secs = _instrument(
        gain_ab, ["--bottlenecks", "zero,vq", "--steps", str(DIAG_STEPS), "--clips",
                    str(INSTR_CLIPS), "--eval-batches", "4", "--workdir",
                    os.path.join(tmp, "gain")], trained(DIAG_STEPS, 4, twins=2), card)
    add(got)
    _held_keys("gain_ab", recs, {
        "header": ("gain_ab", ("vq_gain_ceiling_nats",)),
        "twin": ("eval", ("kind", "steps", "wall_s")),
        "summary": ("summary", ())})
    twins = [r for r in recs if "eval" in r]
    check(set(recs[-1]["summary"]) == {"recon_ce", "gain_vs_zero_nats",
                                       "vq_gain_ceiling_nats"}
          and [r["kind"] for r in twins] == ["zero", "vq"]
          and all("recon_ce" in r["eval"] for r in twins), f"gain_ab: records {recs}")
    print(f"[instruments] gain_ab --bottlenecks zero,vq, {DIAG_STEPS} steps a twin: "
          f"{json.dumps(recs[-1])}; {secs:.1f} s | {card}")
    secs = time.perf_counter() - t_phase
    print(f"[instruments] phase 11 in {secs:.1f} s; launches {launches} | {card}")
    return {"launches": launches, "seconds": secs}


@contextlib.contextmanager
def _environ(**kw):
    """The environment variables ``kw`` (None: unset) for a block, restored
    after: how a user passes a measuring script its sizes."""
    old = {k: os.environ.get(k) for k in kw}
    try:
        for k, v in kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def measure_kernels(card: str, dev) -> dict:
    """K9 at every shape of ``bench_vq``'s sweep and K4-K6 at B = 128, each
    timed beside its bound and its plain version, before the scripts run
    them (these launches are timings, not the path's); max_abs_err, the
    largest difference from the plain version on the same inputs (the
    sums; the logits over each row's agreeing greedy prefix).
    -> {"vq_by_n": {"N (K=k)": row}, "by_batch": {mode: row at B = 128}}."""
    import torch

    from ae_wavenet_tpu_torch.models.wavenet import WaveNet
    from ae_wavenet_tpu_torch.ops import fastgen_cuda as fc
    from ae_wavenet_tpu_torch.ops import vq_cuda as vq
    from ae_wavenet_tpu_torch.scripts import bench_vq
    from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

    out: dict = {"vq_by_n": {}, "by_batch": {}}
    gen = torch.Generator().manual_seed(13)
    d = bench_vq.D
    for k in bench_vq.SWEEP_K:
        for n in bench_vq.SWEEP_N:
            z = torch.randn(n, d, generator=gen).to(dev)
            e = torch.randn(k, d, generator=gen).to(dev)
            got = vq.vq_lookup_fused(z, e)
            want = vq.vq_lookup_reference(z, e)
            err = float((got[3] - want[3]).abs().max())
            n_diff = int((got[0] != want[0]).sum())
            rel = vq_sums_err(z, got[0], got[3])[1]
            check(vq_codes_agree(z, e, got[0].long(), want[0].long()) and rel <= VQ_SUM_TOL,
                  f"vq N={n} K={k}: {n_diff} codes differ, sums {rel:.4g} from float64's")
            k_ms = cuda_ms(lambda: vq.vq_lookup_fused(z, e), VQ_TIMING_REPS)
            p_ms = cuda_ms(lambda: vq.vq_lookup_reference(z, e), VQ_TIMING_REPS)
            b_ms, by = bound(tensor_bytes(z, e, got), {"f32": 2 * n * k * d})
            print(f"[measures] vq N={n} K={k} D={d}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.5f} ms by {by} ({100 * b_ms / k_ms:.1f}%); "
                  f"{n_diff} codes differ from the plain version's, sums max|d| "
                  f"{err:.4g} | {card}")
            out["vq_by_n"][f"{n} (K={k})"] = {"ms": k_ms, "plain_ms": p_ms,
                                             "bound_ms": b_ms, "bound_by": by,
                                             "max_abs_err": err}
            del z, e, got, want

    wcfg = WaveNetConfig()  # bench_gen's decoder
    wn = WaveNet(wcfg, gen)
    with torch.no_grad():
        wn.post2["w"].mul_(POST2_SCALE)
    wn = wn.to(dev)
    rf = sum(wcfg.dilations)
    n_cond = wcfg.n_lc_out + wcfg.n_global_embed
    b = MEASURE_GEN_BATCH
    ring = (torch.randn(rf, b, wcfg.n_res, generator=gen) * 0.5).to(dev, torch.bfloat16)
    prev = torch.randint(0, wcfg.n_quant, (b,), generator=gen).to(dev)
    cnd = (torch.randn(b, n_cond, TIMED_T, generator=gen) * 0.3).to(dev)
    for name in ("bf16", "int8", "int4"):
        mode = None if name == "bf16" else name
        pk = fc.PACKERS[mode](wn, wcfg)
        got, want = (fn(pk, wcfg, ring.clone(), prev, 3, cnd[..., :MEASURE_HELD_T], 9, 0.0,
                        debug_logits=True, quantized=mode)
                     for fn in (fc.generate_fused, fc.generate_fused_reference))
        agree, max_abs = compare(got[0], got[3], want[0], want[3])
        rel = max_abs / float(want[3].abs().max())
        check(rel < LOGIT_REL_TOL[mode],
              f"{name} B={b}: logits max|d| {max_abs:.4g} from the plain version")
        k_ms = cuda_ms(lambda: fc.generate_fused(
            pk, wcfg, ring, prev, 0, cnd, 5, 1.0, quantized=mode), 3) / TIMED_T
        p_ms = cuda_ms(lambda: fc.generate_fused_reference(
            pk, wcfg, ring, prev, 0, cnd[..., :PLAIN_T], 5, 1.0, quantized=mode),
            1) / PLAIN_T
        b_ms, by = sampler_bound(pk, wcfg, fc.device_plan(wcfg, mode, dev), b, mode)
        print(f"[measures] {name} B={b}: kernel {k_ms:.4f} ms/step at T={TIMED_T} a "
              f"launch, plain {p_ms:.4f} ms/step, bound {b_ms:.5f} ms/step by {by} "
              f"({100 * b_ms / k_ms:.2f}%); over {MEASURE_HELD_T} greedy steps "
              f"{sum(agree)} of {MEASURE_HELD_T * b} row-steps agree with the plain "
              f"version, logits max|d| {max_abs:.4g} there ({rel:.3g} of max |logits|) | "
              f"{card}")
        out["by_batch"][name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                 "bound_by": by, "max_abs_err": max_abs}
        del pk, got, want
    return out


def phase_measures(card: str, dev, tmp: str) -> dict:
    """The measuring scripts (``ae_wavenet_tpu_torch/scripts``) at the
    flagship width, each through its ``main`` as a user runs it, cut in
    iterations and steps only: ``bench_gated`` and ``ablate_step`` at 2
    iterations, ``bench_vq``'s whole sweep with the train step at 3 + 5
    steps, ``bench_gen`` at bench_gen_r5's batches (bf16 and int8 at B =
    128, int4 at B = 64) 256 steps each and one eager record at 64 steps,
    ``bench_mfcc``, ``bench_ckpt --flagship``, ``bench_chassis --steps 8``,
    ``probe_dispatch`` at K = 8, ``convergence_ab`` over 40 steps (its gate
    enforced) and ``train_curves`` at 40 steps a family.  First K9 at every
    sweep shape and K4-K6 at B = 128 against their plain versions
    (``measure_kernels``).  Each script exits 0, prints the JAX script's
    keys with every value finite, and launches exactly the kernels its path
    gives."""
    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.scripts import (ablate_step, bench_chassis, bench_ckpt,
                                              bench_gated, bench_gen, bench_mfcc,
                                              bench_vq, convergence_ab, probe_dispatch,
                                              train_curves)
    from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

    t_phase = time.perf_counter()
    with f32_numerics():
        kern = measure_kernels(card, dev)
    pairs = len(gated.stack_dils(WaveNetConfig())) // 2
    launches: dict = {}
    secs: dict = {}

    def run(script, argv, expect, label=None, **env):
        with _environ(**env):
            recs, text, got, s = _instrument(script, argv, expect, card)
        for k, v in got.items():
            if k != "plain":
                launches[k] = launches.get(k, 0) + v
        name = label or script.__name__.rsplit(".", 1)[-1]
        secs[name] = round(s, 1)
        return recs, text

    def steps(n, captures=1):
        """K1 and K2 launches of n training steps through ``captures``
        captures on the pair schedule."""
        return {"gated_pair_fused": pairs * warm_steps(n, captures),
                "gated_pair_bwd": pairs * warm_steps(n, captures)}

    def keys(name, recs, want):
        check(len(recs) == len(want), f"{name}: {len(recs)} records, expected "
              f"{len(want)}: {recs}")
        for r, w in zip(recs, want):
            check(set(r) == set(w), f"{name}: keys {sorted(r)}, the JAX script's "
                  f"{sorted(w)}")

    # bench_gated: each forward once for the check, then 1 + MEASURE_ITERS
    calls = 2 + MEASURE_ITERS
    recs, _ = run(bench_gated, ["--iters", str(MEASURE_ITERS)],
                  {"gated_pair_fused": pairs * calls, "gated_stack_fused": calls})
    keys("bench_gated", recs, [BENCH_GATED_KEYS])
    g = recs[0]
    check(g["max_abs_diff"] < STACK_ABS_TOL and g["full_fusion_max_abs_diff"]
          < STACK_FULL_ABS_TOL, f"bench_gated: max |d| {g['max_abs_diff']} (pairs, tol "
          f"{STACK_ABS_TOL}), {g['full_fusion_max_abs_diff']} (K7, tol "
          f"{STACK_FULL_ABS_TOL})")
    print(f"[measures] bench_gated --iters {MEASURE_ITERS}: {json.dumps(g)} | {card}")

    # bench_vq: the sweep, then 3 + 5 steps with the VQ kernel off and on
    n_shapes = len(bench_vq.SWEEP_K) * len(bench_vq.SWEEP_N)
    per_shape = 1 + bench_vq.OP_WARMUP + bench_vq.OP_ITERS
    old = bench_vq.TRAIN_ITERS
    bench_vq.TRAIN_ITERS = MEASURE_VQ_TRAIN_ITERS
    try:
        n_steps = 2 * (bench_vq.TRAIN_WARMUP + bench_vq.TRAIN_ITERS)
        recs, _ = run(bench_vq, [], {**steps(n_steps, 2), "plain": n_shapes * per_shape,
                                     "vq_lookup_fused": n_shapes * per_shape
                                     + warm_steps(n_steps // 2)}, BENCH_BATCH=None,
                      BENCH_NWIN=None)
    finally:
        bench_vq.TRAIN_ITERS = old
    keys("bench_vq", recs, [VQ_OP_KEYS] * n_shapes + [VQ_STEP_KEYS] * 2
         + [{"bench", "pallas_over_xla"}])
    for r in recs:
        print(f"[measures] bench_vq: {json.dumps(r)} | {card}")

    # bench_gen at the TPU record's batches, then one eager record
    gen_keys = {"path", "batch", "gen_steps", "vmem_dil_max", "wall_s",
                "samples_per_sec_per_stream", "rtf_16k", "aggregate_samples_per_sec"}
    gen_recs = []
    for label, batch, env in (("bf16", 128, {}), ("int8", 128, {"GEN_INT8": 1}),
                              ("int4", 64, {"GEN_INT4": 1})):
        recs, _ = run(bench_gen, [], {label: 4}, f"bench_gen_{label}_b{batch}",
                      GEN_BATCH=batch, GEN_STEPS=MEASURE_GEN_STEPS, GEN_SKIP_SCAN=1,
                      GEN_INT8=env.get("GEN_INT8"), GEN_INT4=env.get("GEN_INT4"),
                      GEN_DTYPE=None)
        keys(f"bench_gen {label}", recs, [gen_keys])
        gen_recs += recs
    recs, _ = run(bench_gen, [], {"bf16": 4}, "bench_gen_scan", GEN_BATCH=None,
                  GEN_STEPS=MEASURE_SCAN_STEPS, GEN_SKIP_SCAN=None, GEN_INT8=None,
                  GEN_INT4=None, GEN_DTYPE=None)
    keys("bench_gen scan", recs, [GEN_SCAN_KEYS, gen_keys])
    gen_recs += recs
    for r in gen_recs:
        print(f"[measures] bench_gen: {json.dumps(r)} | {card}")

    recs, _ = run(bench_mfcc, [], {}, MFCC_BATCH=None, MFCC_T=None, MFCC_TRAIN_SPS=None)
    keys("bench_mfcc", recs, MFCC_KEYS)
    print(f"[measures] bench_mfcc: {json.dumps(recs)} | {card}")

    recs, _ = run(bench_ckpt, ["--flagship", "--repeats", "1"], {})
    keys("bench_ckpt", recs, [CKPT_KEYS])
    print(f"[measures] bench_ckpt --flagship --repeats 1: {json.dumps(recs[0])} | {card}")

    chassis_steps = 8
    recs, _ = run(bench_chassis, ["--steps", str(chassis_steps)],
                  steps(bench_chassis.WARMUP + chassis_steps))
    keys("bench_chassis", recs, [{"metric", "value", "config"}])
    print(f"[measures] bench_chassis --steps {chassis_steps}: {json.dumps(recs[0])} "
          f"| {card}")

    # probe_dispatch at K = 8: 6 blocks, then Chassis.train at K = 1, 8, 16
    # (four captures)
    k = 8
    e2e = sum(2 * kk + max(3 * kk, 24 - 24 % kk) for kk in (1, k, 2 * k))
    recs, _ = run(probe_dispatch, [], steps(6 * k + e2e, 4), PROBE_TINY=None,
                  BENCH_BATCH=None, BENCH_NWIN=None, BENCH_STEPS_PER_CALL=k)
    keys("probe_dispatch", recs, [PROBE_KEYS | {f"e2e_{m}_k{kk}" for m in ("sps", "frac")
                                                for kk in (1, k, 2 * k)}])
    probe = recs[0]
    print(f"[measures] probe_dispatch: {json.dumps(probe)} | {card}")

    # ablate_step: the decoder's and the loss's forward and backward on pairs
    calls = 2 + MEASURE_ITERS
    _, text = run(ablate_step, ["--iters", str(MEASURE_ITERS)],
                  {"gated_pair_fused": 4 * pairs * calls, "gated_pair_bwd": 2 * pairs * calls})
    lines = text.strip().splitlines()
    check(len(lines) == 7 and lines[0] == "pallas_stack=True b8 x 24000"
          and [ln.split(" ms:")[0] for ln in lines[1:]] == list(ABLATE_LABELS),
          f"ablate_step printed {lines}")
    print(f"[measures] ablate_step --iters {MEASURE_ITERS}: " + "; ".join(lines) + f" | {card}")

    recs, _ = run(convergence_ab, ["--steps", str(CONV_STEPS)], steps(CONV_STEPS))
    # (its plain-stack twin's capture launches no kernel)
    keys("convergence_ab", recs, [CONV_KEYS])
    c = recs[0]
    check(c["mean_abs_ce_diff"] <= convergence_ab.MEAN_LIMIT
          and c["max_abs_ce_diff"] <= convergence_ab.MAX_LIMIT,
          f"convergence_ab: {c} outside mean {convergence_ab.MEAN_LIMIT} / max "
          f"{convergence_ab.MAX_LIMIT}")
    print(f"[measures] convergence_ab --steps {CONV_STEPS}: {json.dumps(c)} (limits: mean "
          f"{convergence_ab.MEAN_LIMIT}, max {convergence_ab.MAX_LIMIT}) | {card}")

    out = os.path.join(tmp, "training_curves_torch.json")
    run(train_curves, ["--out", out], {}, CURVE_STEPS=MEASURE_CURVE_STEPS)
    with open(out) as f:
        curves = json.load(f)
    check(list(curves) == ["ae", "vq", "vae"] and all(
        set(v) == {"steps", "recon_ce", "extra", "eval_recon_ce_holdout"} and _finite(v)
        for v in curves.values()), f"train_curves wrote {curves}")
    print(f"[measures] train_curves at {MEASURE_CURVE_STEPS} steps a family: " + "; ".join(
        f"{kind} train CE {v['recon_ce'][-1]} holdout {v['eval_recon_ce_holdout']}"
        for kind, v in curves.items()) + f" | {card}")

    total = time.perf_counter() - t_phase
    print(f"[measures] phase 12 in {total:.1f} s (scripts: {json.dumps(secs)}); "
          f"launches {launches} | {card}")
    return {"launches": launches, "seconds": total, "probe": probe, **kern}


def bench_keys() -> list:
    """The keys of the JAX bench's line: the dict of the last ``json.dumps``
    call in ``bench.py`` beside this file, read with ast."""
    import ast

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench.py")) as f:
        tree = ast.parse(f.read())
    dicts = [n.args[0] for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "dumps" and n.args and isinstance(n.args[0], ast.Dict)]
    check(bool(dicts), "bench.py has no json.dumps({...}) line")
    return [k.value for k in max(dicts, key=lambda d: d.lineno).keys]


def _bench_held(label: str, rec: dict, keys: list) -> None:
    """A bench line at the defaults: the JAX bench's keys, the e2e headline,
    the step's FLOP count, MFU and the e2e fraction in their bands, every
    number finite."""
    check(set(rec) == set(keys), f"bench {label}: keys {sorted(rec)}, bench.py's "
          f"{sorted(keys)}")
    check(rec["headline"] == "e2e" and rec["steps_per_call"] == BENCH_K
          and rec["metric"] == "train_audio_samples_per_sec_per_chip",
          f"bench {label}: {rec}")
    check(_finite(rec) and rec["value"] > 0 and rec["compute_only_value"] > 0,
          f"bench {label}: {rec}")
    check(round(rec["model_tflops_per_step"], 2) == BENCH_TFLOP,
          f"bench {label}: {rec['model_tflops_per_step']} TFLOP a step, expected "
          f"{BENCH_TFLOP}")
    check(rec["mfu"] is not None and 0 < rec["mfu"] <= BENCH_MFU_MAX,
          f"bench {label}: mfu {rec['mfu']} outside (0, {BENCH_MFU_MAX}]")
    check(0 < rec["e2e_fraction"] <= BENCH_E2E_MAX,
          f"bench {label}: e2e_fraction {rec['e2e_fraction']} outside (0, "
          f"{BENCH_E2E_MAX}]")


def _bench_text(rec: dict) -> str:
    """The line's rates as step times at the defaults' B x n_win."""
    n = TRAIN_B * TRAIN_WIN
    return (f"compute-only {rec['compute_only_value']} samples/s = "
            f"{n / rec['compute_only_value'] * 1e3:.1f} ms a step, e2e {rec['value']} = "
            f"{n / rec['value'] * 1e3:.1f} ms a step, e2e/compute {rec['e2e_fraction']}, "
            f"{rec['achieved_tflops_per_chip']} TFLOP/s, MFU {rec['mfu']}")


def phase_bench(card: str, dev, probe: dict | None = None) -> dict:
    """``ae_wavenet_tpu_torch/bench.py`` at the flagship width: (a) its
    functions at the defaults (pairs; B = 4, n_win = 48,000, 20 iterations,
    K = 8), (b) again under BENCH_FULL_FUSION=1 BENCH_BWD_GROUP=5 (the
    whole-stack path), the launch counters at 0 before each and exact after
    it (3 + 20 + 2K + 24 = 63 steps); (c) ``python -m
    ae_wavenet_tpu_torch.bench`` as a subprocess at the defaults: rc 0, the
    line last on stdout, the card's line on stderr.  Each line has the JAX
    bench's keys (``bench_keys``), the e2e headline, 15.36 TFLOP a step and
    MFU in (0, 1.05].  ``probe``: phase 12's ``probe_dispatch`` record, whose
    compute rate the bench's is printed beside."""
    import torch

    from ae_wavenet_tpu_torch import bench
    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.utils.config import WaveNetConfig

    t_phase = time.perf_counter()
    keys = bench_keys()
    n_layers = len(gated.stack_dils(WaveNetConfig()))
    steps = bench.WARMUP + BENCH_ITERS + 2 * BENCH_K + bench.e2e_steps(BENCH_ITERS, BENCH_K)
    check(steps == 63 and n_layers % GROUP == 0, f"{steps} steps, {n_layers} layers")
    steps = warm_steps(steps, 2)  # compute_only's capture and the e2e chassis's
    runs = [("pairs (defaults)", {}, {"gated_pair_fused": n_layers // 2 * steps,
                                      "gated_pair_bwd": n_layers // 2 * steps}),
            (f"whole stack (BENCH_FULL_FUSION=1 BENCH_BWD_GROUP={GROUP})",
             {"BENCH_FULL_FUSION": 1, "BENCH_BWD_GROUP": GROUP},
             {"gated_stack_fused": steps, "gated_group_bwd": n_layers // GROUP * steps})]
    launches: dict = {}
    recs = {}
    for label, env, want in runs:
        with _environ(**{**dict.fromkeys(BENCH_KNOBS), **env}), f32_numerics():
            cfg = bench.bench_config(os.environ)
            zero_launch_counts()
            _zero_train_counts()
            t0 = time.perf_counter()
            rec = bench.measure(cfg, dev, iters=BENCH_ITERS, k=BENCH_K)
            torch.cuda.synchronize()
            secs, got, step = time.perf_counter() - t0, launch_counts(), _train_counts()
        check(got == expect_launches(**want), f"bench {label}: launches {got}, expected "
              f"{expect_launches(**want)}")
        check(step == {"replays": 63, "captures": 2, "eager": 0},
              f"bench {label}: training step counters {step}")
        _bench_held(label, rec, keys)
        for k, v in want.items():
            launches[k] = launches.get(k, 0) + v
        recs[label] = rec
        print(f"[bench] {label}, in process: {json.dumps(rec)}; {_bench_text(rec)}; "
              f"63 steps, {step['replays']} replays of {step['captures']} captures and "
              f"{step['eager']} eager steps, launches {want} (the warm-up steps "
              f"included), plain 0; {secs:.1f} s | {card}")
    if probe is not None:
        rec = recs[runs[0][0]]
        print(f"[bench] pairs compute-only over probe_dispatch's compute_sps (phase 12, "
              f"same path and shape): {rec['compute_only_value'] / probe['compute_sps']:.4f}; "
              f"e2e over its e2e_sps_k{BENCH_K}: "
              f"{rec['value'] / probe[f'e2e_sps_k{BENCH_K}']:.4f} | {card}")

    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k not in BENCH_KNOBS}
    r = subprocess.run([sys.executable, "-m", "ae_wavenet_tpu_torch.bench"],
                       cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                       capture_output=True, text=True, timeout=BENCH_CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    out = r.stdout.strip().splitlines()
    check(r.returncode == 0 and out and out[-1].startswith("{"),
          f"python -m ae_wavenet_tpu_torch.bench: rc {r.returncode}, stdout "
          f"{r.stdout[-2000:]!r}, stderr {r.stderr[-2000:]!r}")
    rec = json.loads(out[-1])
    _bench_held("CLI", rec, keys)
    check(card in r.stderr.splitlines(), f"bench CLI: the card's line {card!r} not on "
          f"its stderr {r.stderr[-1000:]!r}")
    print(f"[bench] python -m ae_wavenet_tpu_torch.bench: rc 0, {json.dumps(rec)}; "
          f"{_bench_text(rec)}; stderr's card line {card!r}; {secs:.1f} s | {card}")
    total = time.perf_counter() - t_phase
    print(f"[bench] phase 13 in {total:.1f} s; launches {launches} | {card}")
    return {"launches": launches, "seconds": total, "records": {**recs, "CLI": rec}}


def _timed_grad_mean(events: list, nbytes: list):
    """A stand-in for ``Mesh.mean_`` that records CUDA events around each
    gradient all-reduce (the many-tensor call) and its bytes."""
    import torch

    from ae_wavenet_tpu_torch.parallel import mesh as mesh_mod

    orig = mesh_mod.Mesh.mean_

    def mean_(self, tensors):
        if len(tensors) == 1:  # the metrics, or an eval's totals
            return orig(self, tensors)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        orig(self, tensors)
        b.record()
        events.append((a, b))
        nbytes.append(sum(t.numel() * t.element_size() for t in tensors))
    return mean_


def train_rank(argv) -> int:
    """``chip_smoke.py --train-rank ARGV``: one rank of phase 10(a), the
    train CLI's ``main(ARGV)`` with every launch counter at 0 before it; then
    one line ``RANK_REPORT {...}``: the launches, the checkpoint files this
    rank wrote, the state digest after each ``resume`` and ``train``, the
    peak memory, each gradient all-reduce's bytes and device milliseconds,
    and the gated kernels' occupancy queries (blocks per SM)."""
    from unittest import mock

    import torch

    from ae_wavenet_tpu_torch.cli import train as cli
    from ae_wavenet_tpu_torch.ops import gated_cuda as gc
    from ae_wavenet_tpu_torch.parallel import mesh as mesh_mod
    from ae_wavenet_tpu_torch.training import chassis, weights

    writes, digests, events, nbytes = [], [], [], []
    orig_train, orig_resume = chassis.Chassis.train, chassis.Chassis.resume
    orig_write = weights.write_export

    def digest(ch):
        return mesh_mod.digest({**ch.model.state_dict(), **ch.opt.named_state()})

    def train(self, *a, **kw):
        out = orig_train(self, *a, **kw)
        digests.append(["train", self.step, digest(self)])
        return out

    def resume(self, *a, **kw):
        out = orig_resume(self, *a, **kw)
        digests.append(["resume", out, digest(self)])
        return out

    def write(path, *a, **kw):
        writes.append(os.path.basename(path))
        return orig_write(path, *a, **kw)

    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(chassis.Chassis, "train", train), \
            mock.patch.object(chassis.Chassis, "resume", resume), \
            mock.patch.object(weights, "write_export", write), \
            mock.patch.object(mesh_mod.Mesh, "mean_", _timed_grad_mean(events, nbytes)):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    print("RANK_REPORT " + json.dumps({
        "rc": rc, "counts": launch_counts(), "writes": writes, "digests": digests,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "allreduce_bytes": nbytes, "allreduce_ms": [a.elapsed_time(b) for a, b in events],
        "occupancy": {f"{k[0]} {k[1]}": v for k, v in gc._BLOCKS.items()}}))
    return rc


def _cli_ranks(argv: list, label: str, logs: str) -> list:
    """The train CLI as DP_RANKS subprocess ranks (``--train-rank``) on a
    local rendezvous, their output in files under ``logs`` (a rank blocked
    on a full pipe would stall the collective) -> per rank (records,
    RANK_REPORT, "resumed" lines); a rank that has not ended within
    DP_TIMEOUT_S is killed and the smoke fails."""
    from ae_wavenet_tpu_torch.parallel import mesh as mesh_mod

    here = os.path.abspath(__file__)
    port = mesh_mod.free_port()
    paths = [os.path.join(logs, f"{label.replace(' ', '_')}_rank{r}") for r in
             range(DP_RANKS)]
    procs = []
    try:
        for r, path in enumerate(paths):
            with open(path + ".out", "w") as out, open(path + ".err", "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, here, "--train-rank", *argv, "--distributed",
                     "--coordinator", f"localhost:{port}", "--num-processes",
                     str(DP_RANKS), "--process-id", str(r)],
                    cwd=os.path.dirname(here), stdout=out, stderr=err))
        deadline = time.monotonic() + DP_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                check(False, f"{label}: rank {r} did not end within {DP_TIMEOUT_S} s")
            with open(paths[r] + ".err") as f:
                check(p.returncode == 0, f"{label}: rank {r} returned {p.returncode}:\n"
                      f"{f.read()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for path in paths:
        with open(path + ".out") as f:
            lines = f.read().splitlines()
        recs = [json.loads(ln) for ln in lines if ln.startswith('{"step"')]
        rep = [json.loads(ln.split(" ", 1)[1]) for ln in lines
               if ln.startswith("RANK_REPORT ")]
        check(len(rep) == 1, f"{label}: {len(rep)} rank reports")
        got.append((recs, rep[0], [ln for ln in lines if ln.startswith("resumed")]))
    return got


def _halo_run(mesh) -> dict:
    """Phase 10(c) on this rank: ``make_sp_forward`` at the ``chorowski``
    decoder width, B = 2, HALO_T columns a rank, f32 (TF32 off), against
    the single-rank stack on the whole input -> max |d|, whether it is
    within rtol/atol 2e-4, the forward's ms (CUDA events) and peak GiB."""
    import torch

    from ae_wavenet_tpu_torch.models import wavenet as twn
    from ae_wavenet_tpu_torch.parallel import halo
    from ae_wavenet_tpu_torch.utils import config as config_mod

    wcfg = config_mod.chorowski_config().wavenet
    params = {k: v.detach().to(mesh.device) for k, v in
              twn.WaveNet(wcfg, torch.Generator().manual_seed(5)).named_parameters()}
    gen = torch.Generator().manual_seed(6)
    t = mesh.size * HALO_T
    x = torch.randn(2, wcfg.n_res, t, generator=gen).to(mesh.device)
    cond = torch.randn(2, wcfg.n_lc_out + wcfg.n_global_embed, t,
                       generator=gen).to(mesh.device)
    fwd = halo.make_sp_forward(params, wcfg.dilations, mesh)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), f32_numerics():
        got = fwd(x, cond)
        torch.cuda.synchronize()
        mesh.barrier()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fwd(x, cond)
        b.record()
        b.synchronize()
        sp_ms = a.elapsed_time(b)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = halo.make_sp_forward(params, wcfg.dilations, None)(x, cond)[
            ..., mesh.rank * HALO_T : (mesh.rank + 1) * HALO_T]
    return {"max_abs_err": float((got - want).abs().max()),
            "max_abs": float(want.abs().max()),
            "close": bool(torch.allclose(got, want, rtol=2e-4, atol=2e-4)),
            "ms": sp_ms, "peak_gib": peak}


def _halo_rank(rank: int, port: int, n: int) -> dict:
    """The halo on rank ``rank`` of n: phase 10(c), two ranks sharing one
    card (gloo), and ``--mesh-cards``, each rank on its own card (NCCL)."""
    from ae_wavenet_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.initialize_distributed(f"localhost:{port}", n, rank, "cuda")
    try:
        return {"backend": mesh.backend, **_halo_run(mesh)}
    finally:
        mesh.close()


def phase_parallel(card: str, dev, tmp: str) -> dict:
    """Phase 10: data parallelism and the halo on the card (module
    docstring).  -> the pair kernels' and the VQ kernel's launches."""
    import torch

    from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.ops import gated
    from ae_wavenet_tpu_torch.parallel import mesh as mesh_mod
    from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod
    from ae_wavenet_tpu_torch.utils import config as config_mod

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    base = config_mod.chorowski_config()
    u_len = ae.make_window_spec(base, TRAIN_WIN).u_len
    data, ckpt = os.path.join(tmp, "dp"), os.path.join(tmp, "ckpt_dp")
    make_synthetic_dataset(data, n_clips=8, n_speakers=8,
                           clip_len=(u_len + 4000, u_len + 30000), seed=1)
    n_pairs = len(gated.stack_dils(base.wavenet)) // 2
    per_step = expect_launches(gated_pair_fused=n_pairs, gated_pair_bwd=n_pairs,
                       vq_lookup_fused=1)

    def times(n: int) -> dict:
        return {k: v * n for k, v in per_step.items()}

    shape = ["--preset", "chorowski", "--pallas-stack", "--vq-use-pallas", "--batch-sz",
             str(TRAIN_B), "--n-win", str(TRAIN_WIN), "--data", data, "--log-every", "1"]
    launches = {k: 0 for k in ("gated_pair_fused", "gated_pair_bwd", "vq_lookup_fused")}

    # (a) two ranks of the train CLI on the one card: new, then resume
    t0 = time.perf_counter()
    new = _cli_ranks(["new", *shape, "--n-steps", str(DP_STEPS), "--ckpt-dir", ckpt],
                     "10(a) new", tmp)
    res = _cli_ranks(["resume", "--n-steps", str(DP_RESUME), "--data", data,
                      "--log-every", "1", "--ckpt-dir", ckpt], "10(a) resume", tmp)
    wall_a = time.perf_counter() - t0
    losses = []
    for rank, ((recs_n, rep_n, _), (recs_r, rep_r, resumed)) in enumerate(zip(new, res)):
        check(recs_n[0].get("dp_backend") == "gloo" and recs_n[0]["dp_size"] == DP_RANKS,
              f"10(a) rank {rank}: first log line {recs_n[0]}")
        check(rep_n["counts"] == times(DP_STEPS) and rep_r["counts"] == times(DP_RESUME),
              f"10(a) rank {rank}: launches {rep_n['counts']} / {rep_r['counts']}, "
              f"expected {times(DP_STEPS)} / {times(DP_RESUME)}")
        check(resumed == [f"resumed at step {DP_STEPS}"],
              f"10(a) rank {rank}: resume said {resumed}")
        steps = [r["step"] for r in recs_n + recs_r if "loss" in r]
        check(steps == list(range(1, DP_STEPS + DP_RESUME + 1)),
              f"10(a) rank {rank}: logged steps {steps}")
        losses.append([r["loss"] for r in recs_n + recs_r if "loss" in r])
        for k in launches:
            launches[k] += rep_n["counts"][k] + rep_r["counts"][k]
    (recs0, rep0, _), (recs1, rep1, _) = new
    check(losses[0] == losses[1], f"10(a): the ranks logged different losses {losses}")
    check(all(math.isfinite(v) for v in losses[0]), f"10(a): losses {losses[0]}")
    for (_, a, _), (_, b, _) in (new, res):
        check(a["digests"] == b["digests"] and len(a["digests"]) >= 1,
              f"10(a): state digests differ: {a['digests']} vs {b['digests']}")
    check([r[1]["digests"][0][:2] for r in res] == [["resume", DP_STEPS]] * DP_RANKS,
          "10(a): a rank resumed elsewhere than step "
          f"{DP_STEPS}: {[r[1]['digests'] for r in res]}")
    written = [rep["writes"] for rep in (rep0, rep1)]
    last = DP_STEPS + DP_RESUME
    check(written == [[f"step_{DP_STEPS:08d}.pt"], []]
          and [r[1]["writes"] for r in res] == [[f"step_{last:08d}.pt"], []],
          f"10(a): checkpoint writes by rank {written}, then "
          f"{[r[1]['writes'] for r in res]}")
    check(ckpt_mod.latest_step(ckpt) == last, "10(a): LATEST is not the last step")
    recs_all = [r for r in recs0 + res[0][0] if "loss" in r]
    step_a = statistics.median(TRAIN_B * TRAIN_WIN / r["samples_per_sec"]
                               for r in recs_all[1:DP_STEPS])
    ar_bytes = rep0["allreduce_bytes"][0]
    ar_ms = statistics.median(rep0["allreduce_ms"] + res[0][1]["allreduce_ms"])
    print(f"[parallel] (a) train CLI as {DP_RANKS} ranks on one card (--distributed, "
          f"gloo), new {DP_STEPS} + resume {DP_RESUME} steps in {wall_a:.1f} s: losses "
          f"{' '.join(f'{v:.6f}' for v in losses[0])} on both ranks bit for bit, state "
          f"digests equal ({rep0['digests'][-1][2][:12]}...), rank 0 wrote "
          f"{written[0]}, rank 1 nothing, both resumed at step {DP_STEPS}; launches per "
          f"rank per step {n_pairs} K1, {n_pairs} K2, 1 K9, plain 0; occupancy (blocks "
          f"per SM) rank 0 {rep0['occupancy']}, rank 1 {rep1['occupancy']} | {card}")
    print(f"[parallel] (a) median step {step_a * 1e3:.1f} ms -> "
          f"{TRAIN_B * TRAIN_WIN / step_a:.0f} samples/s (global B={TRAIN_B}, "
          f"n_win={TRAIN_WIN}, two ranks time-slicing one card); peak memory rank 0 "
          f"{rep0['peak_gib']:.2f} GiB, rank 1 {rep1['peak_gib']:.2f} GiB; gradient "
          f"all-reduce {ar_bytes} bytes a step, median {ar_ms:.1f} ms (CUDA events) | "
          f"{card}")

    # (d), started here: the multi-process dry run through its entry point,
    # on the card by default (DP_RANKS ranks sharing it), beside (b) and (c)
    t_e = time.perf_counter()
    dry = subprocess.Popen([sys.executable, "-m", "ae_wavenet_tpu_torch.dryrun",
                            str(DP_RANKS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
                           start_new_session=True)

    def end_dry() -> None:  # the dry run and the ranks it spawned
        if dry.poll() is None:
            os.killpg(dry.pid, signal.SIGKILL)
            dry.communicate()

    try:
        # (b) --mesh on the one card: a world of one, on NCCL, against the run
        # without it
        plain_run, n_plain, _, _ = _path_run(
            ["new", *shape, "--n-steps", "2"],
            {k: v for k, v in times(warm_steps(2)).items() if k in launches}, card,
            "10(b) without a mesh", 2)
        for k in launches:
            launches[k] += n_plain[k]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "ae_wavenet_tpu_torch.cli.train", "new",
                            *shape, "--n-steps", "2", "--mesh"], capture_output=True,
                           text=True, timeout=DP_TIMEOUT_S,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        check(r.returncode == 0, f"10(b) --mesh returned {r.returncode}:\n{r.stderr[-3000:]}")
        recs = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith('{"step"')]
        check(recs and recs[0].get("dp_backend") == "nccl" and recs[0]["dp_size"] == 1,
              f"10(b): first log line {recs[:1]}")
        mesh_loss = [x["loss"] for x in recs if "loss" in x]
        plain_loss = [x["loss"] for x in plain_run]
        check(mesh_loss == plain_loss, f"10(b): --mesh losses {mesh_loss} vs {plain_loss}")
        print(f"[parallel] (b) --mesh on one card: a world of {recs[0]['dp_size']:.0f} on "
              f"{recs[0]['dp_backend']} ({recs[0]['dp_device']}), 2 steps in "
              f"{time.perf_counter() - t0:.1f} s, losses "
              f"{mesh_loss} == the run without a mesh, bit for bit | {card}")

        # (c) the halo stack over the two ranks
        hs = mesh_mod.spawn(_halo_rank, DP_RANKS, (mesh_mod.free_port(), DP_RANKS),
                            timeout=DP_TIMEOUT_S)
        for rank, h in enumerate(hs):
            check(h["backend"] == "gloo" and h["close"], f"10(c) rank {rank}: halo "
                  f"stack on {h['backend']}, max |d| {h['max_abs_err']} (max |x| "
                  f"{h['max_abs']})")
        print(f"[parallel] (c) make_sp_forward at the chorowski decoder width "
              f"({len(base.wavenet.dilations)} layers), {DP_RANKS} ranks on one card (gloo, "
              f"halos staged through the host), B=2, T={DP_RANKS} x {HALO_T}, f32: max |d| "
              f"to the single-rank stack {[h['max_abs_err'] for h in hs]} (max |x| "
              f"{hs[0]['max_abs']:.3g}; rtol/atol 2e-4); forward "
              f"{[round(h['ms'], 1) for h in hs]} ms, peak memory "
              f"{[round(h['peak_gib'], 2) for h in hs]} GiB per rank | {card}")
        # (d) the dry run's end
        try:
            out, err = dry.communicate(timeout=max(1.0, DP_TIMEOUT_S
                                                   - (time.perf_counter() - t_e)))
        except subprocess.TimeoutExpired:
            end_dry()
            check(False, f"10(d) dryrun did not end within {DP_TIMEOUT_S} s")
        said = out.strip().splitlines()[-1:] or [""]
        check(dry.returncode == 0 and said[0].startswith(
            f"dryrun_multichip OK: {DP_RANKS} ranks (gloo, rank 0 on cuda:0)"),
              f"10(d) dryrun returned {dry.returncode}: {said}\n{err[-3000:]}")
        print(f"[parallel] (d) python -m ae_wavenet_tpu_torch.dryrun {DP_RANKS} beside (b) "
              f"and (c), ended after {time.perf_counter() - t_e:.1f} s: {said[0]} | {card}")
    finally:  # a failed check above leaves no dry-run rank behind
        end_dry()
    print(f"[parallel] phase 10 in {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches} | {card}")
    return {"launches": launches}


def mesh_cards(card: str) -> None:
    """``chip_smoke.py --mesh-cards``, on a machine with two or more cards:
    data parallelism over every visible card on NCCL, as a user runs it
    (``cli/train.py --mesh``: one spawned rank per card), global B =
    TRAIN_B, n_win = TRAIN_WIN, ``--vq-use-pallas``, new 3 + resume 1
    steps without jitter or restarts, against one process on one card at
    the same global batch (the first step's loss within DP_LOSS_REL_TOL);
    then the halo stack over the cards, NCCL moving the halos card to
    card."""
    import torch

    from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.parallel import mesh as mesh_mod
    from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    n = torch.cuda.device_count()
    check(n > 1 and TRAIN_B % n == 0, f"--mesh-cards: {n} cards for a batch of {TRAIN_B}")
    with tempfile.TemporaryDirectory() as tmp:
        data, ckpt = os.path.join(tmp, "dp"), os.path.join(tmp, "ckpt")
        u_len = ae.make_window_spec(chorowski_config(), TRAIN_WIN).u_len
        make_synthetic_dataset(data, n_clips=8, n_speakers=8,
                               clip_len=(u_len + 4000, u_len + 30000), seed=1)
        # no jitter or restarts: their draws differ per rank by design
        shape = ["--preset", "chorowski", "--pallas-stack", "--vq-use-pallas",
                 "--jitter-p", "0", "--vq-restart-thresh", "0", "--batch-sz",
                 str(TRAIN_B), "--n-win", str(TRAIN_WIN), "--data", data,
                 "--log-every", "1", "--ckpt-dir", ckpt]
        one = [r for r in _run_cli(["new", *shape, "--n-steps", "1"]) if "loss" in r]
        shutil.rmtree(ckpt)
        runs = []
        for argv in (["new", *shape, "--n-steps", "3"],
                     ["resume", "--n-steps", "1", "--data", data, "--log-every", "1",
                      "--ckpt-dir", ckpt]):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "ae_wavenet_tpu_torch.cli.train",
                                *argv, "--mesh"], capture_output=True, text=True,
                               timeout=DP_TIMEOUT_S,
                               cwd=os.path.dirname(os.path.abspath(__file__)))
            check(r.returncode == 0, f"--mesh {argv[0]} returned {r.returncode}:\n"
                  f"{r.stderr[-3000:]}")
            lines = r.stdout.splitlines()
            recs = [json.loads(ln) for ln in lines if ln.startswith('{"step"')]
            firsts = [x for x in recs if x["step"] == 0]
            check(len(firsts) == n and all(x["dp_backend"] == "nccl" and x["dp_size"] == n
                                           for x in firsts),
                  f"--mesh {argv[0]}: first log lines {firsts}")
            runs.append((recs, [ln for ln in lines if ln.startswith("resumed")],
                         time.perf_counter() - t0))
        (new, _, wall_new), (res, resumed, _) = runs
        train = [x for x in new + res if "loss" in x]
        by_step: dict = {}
        for x in train:
            by_step.setdefault(x["step"], set()).add(x["loss"])
        check(sorted(by_step) == [1, 2, 3, 4] and all(len(v) == 1 for v in by_step.values()),
              f"--mesh: the ranks logged {by_step}")
        check(resumed == ["resumed at step 3"] * n, f"--mesh resume said {resumed}")
        check(sorted(os.listdir(ckpt)) == ["LATEST", "step_00000003.pt",
                                           "step_00000004.pt"],
              f"--mesh wrote {sorted(os.listdir(ckpt))}")
        check(ckpt_mod.latest_step(ckpt) == 4, "--mesh: LATEST is not step 4")
        loss_dp, loss_1 = next(iter(by_step[1])), one[0]["loss"]
        rel = abs(loss_dp - loss_1) / abs(loss_1)
        check(rel < DP_LOSS_REL_TOL, f"--mesh first-step loss {loss_dp} vs one card's "
              f"{loss_1}")
        steps = [TRAIN_B * TRAIN_WIN / x["samples_per_sec"] for x in new if "loss" in x]
        step_s = statistics.median(steps[1:])
        print(f"[mesh-cards] --mesh over {n} cards (NCCL), global B={TRAIN_B}, n_win="
              f"{TRAIN_WIN}: new 3 + resume 1 steps, every rank logged the same losses "
              f"{[next(iter(by_step[s])) for s in sorted(by_step)]}; first-step loss "
              f"{loss_dp:.6f} vs one card's {loss_1:.6f} (rel {rel:.2g}); median step "
              f"{step_s * 1e3:.1f} ms -> {TRAIN_B * TRAIN_WIN / step_s:.0f} samples/s; "
              f"new in {wall_new:.1f} s | {card}")
        hs = mesh_mod.spawn(_halo_rank, n, (mesh_mod.free_port(), n), timeout=DP_TIMEOUT_S)
        for r, h in enumerate(hs):
            check(h["backend"] == "nccl" and h["close"],
                  f"--mesh-cards halo rank {r}: {h}")
        print(f"[mesh-cards] make_sp_forward over {n} cards (NCCL), B=2, T={n} x "
              f"{HALO_T}, f32: max |d| {[h['max_abs_err'] for h in hs]}; forward "
              f"{[round(h['ms'], 1) for h in hs]} ms | {card}")


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
        wn, ids, cond, spk = random_stack(wcfg, TRAIN_B, TRAIN_WIN, 1, dev)
        dils, x0, cond_tm, packed, xs, ys, cot = segment_inputs(wn, wcfg, ids, cond, spk)
        wrapper, call = segment_calls(dils, cond_tm, packed, xs, ys,
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


def serve_times(card: str, dev) -> None:
    """``--serve-times``: the B = 1 request through the generate CLI twice
    (encode, prime and generate seconds), ``reconstruct`` at B = BATCH, and
    ``bench_gen``'s records at B = BATCH over SERVE_TIMES_STEPS steps (the
    bf16 rollout of ``ops/fastgen.generate`` and K4); no checks, so that an
    older commit's package can be timed with the same code."""
    import numpy as np
    import torch

    from ae_wavenet_tpu_torch.cli import generate as cli
    from ae_wavenet_tpu_torch.data.dataset import PackedDataset, make_synthetic_dataset
    from ae_wavenet_tpu_torch.models import autoencoder as ae
    from ae_wavenet_tpu_torch.ops import _build
    from ae_wavenet_tpu_torch.scripts import bench_gen
    from ae_wavenet_tpu_torch.training.weights import save_export
    from ae_wavenet_tpu_torch.utils.config import chorowski_config

    t0 = time.perf_counter()
    _build.load()
    print(f"[times] build {time.perf_counter() - t0:.2f} s, package "
          f"{os.path.dirname(_build.CSRC)} | {card}")
    cfg = chorowski_config()
    with f32_numerics(), tempfile.TemporaryDirectory() as tmp:
        data, ckpt, out = (os.path.join(tmp, n) for n in ("synth", "model.pt", "out.wav"))
        make_synthetic_dataset(data, n_clips=BATCH, n_speakers=8,
                               clip_len=(12400, 14000), seed=0)
        save_export(ckpt, ae.init(cfg, torch.Generator().manual_seed(1), "cpu"), cfg, 0)
        for r in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["--ckpt", ckpt, "--data", data, "--clip", "0", "--n-samples",
                          str(CLI_SAMPLES), "--temperature", "1.0", "--device", str(dev),
                          "--out", out])
            m = re.search(r"encode [\d.]+ s, prime [\d.]+ s, generate [\d.]+ s",
                          buf.getvalue())
            print(f"[times] CLI B=1, {CLI_SAMPLES} samples, request {r + 1}: "
                  f"{m.group(0) if m else buf.getvalue()} | {card}")
        ds = PackedDataset(data)
        wav = np.stack([ds.clip(i, BATCH_WAV_LEN) for i in range(BATCH)])
        spk = torch.from_numpy(ds.speakers[:BATCH].astype(np.int64)).to(dev)
        model = ae.init(cfg, torch.Generator().manual_seed(1), dev).eval()
        timings: dict = {}
        ae.reconstruct(model, cfg, torch.from_numpy(wav).to(dev), spk,
                       torch.Generator().manual_seed(2), temperature=1.0,
                       n_samples=BATCH_SAMPLES, timings=timings)
        torch.cuda.synchronize()
        print(f"[times] reconstruct B={BATCH}, {BATCH_SAMPLES} samples: "
              f"{', '.join(f'{k} {v:.3f} s' for k, v in timings.items())} | {card}")
        del model
        buf = io.StringIO()
        with _environ(GEN_BATCH=BATCH, GEN_STEPS=SERVE_TIMES_STEPS), \
                contextlib.redirect_stdout(buf):
            bench_gen.main(["--device", str(dev)])
        for line in buf.getvalue().splitlines():
            print(f"[times] bench_gen {line} | {card}")


def train_times(card: str, dev) -> None:
    """``--train-times``: the main path's step (``bench.py``'s defaults:
    pairs, saved y, B = 4 x 48,000, its fixture, four batches on the card)
    in one process, replayed as a CUDA graph and run eagerly
    (``eager=True``), each on a fresh model of one seed, in the order graph,
    eager, eager, graph: the compute-only ms a step (TRAIN_TIMES_STEPS steps
    between two synchronisations, after 3 warm-up steps, the capture
    among them), the median ms of a step followed by a metrics fetch,
    the peak memory, and the device-busy share, kernels and copies a step
    and window of TRAIN_TIMES_PROFILED fetched steps under torch.profiler,
    and the digest of the training state after all those steps (equal
    digests: bit-identical training); no checks, so that an older commit's
    package, whose ``train_step`` runs only eagerly, is timed with the same
    code ("eager" is then its step)."""
    import gc
    import inspect

    import numpy as np
    import torch

    from ae_wavenet_tpu_torch import bench
    from ae_wavenet_tpu_torch.data.dataset import PackedDataset, WindowSampler
    from ae_wavenet_tpu_torch.models import registry
    from ae_wavenet_tpu_torch.ops import _build
    from ae_wavenet_tpu_torch.parallel import mesh as mesh_mod
    from ae_wavenet_tpu_torch.training import chassis
    from ae_wavenet_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    _build.load()
    print(f"[times] build {time.perf_counter() - t0:.2f} s, package "
          f"{os.path.dirname(_build.CSRC)} | {card}")
    graphed = "eager" in inspect.signature(chassis.train_step).parameters
    cfg = bench.bench_config({})
    fam, spec = registry.get(cfg.model_kind), bench.window_spec(cfg)
    with f32_numerics(), tempfile.TemporaryDirectory() as tmp:
        sampler = WindowSampler(PackedDataset(bench.fixture(os.path.join(tmp, "fx"), cfg)),
                                spec.u_len, cfg.train.batch_sz, seed=0)
        batches = [(torch.from_numpy(w).to(dev), torch.from_numpy(k.astype(np.int64)).to(dev))
                   for w, k in (sampler.batch_at(s) for s in range(4))]
        for mode in ("graph", "eager", "eager", "graph") if graphed else ("eager",) * 2:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = fam.init(cfg, torch.Generator().manual_seed(0), dev)
            opt = chassis.Adam(model.named_parameters(), cfg.train)
            kw = {"eager": mode == "eager"} if graphed else {}
            n = [0]

            def step():
                w, k = batches[n[0] % len(batches)]
                n[0] += 1
                return chassis.train_step(model, opt, cfg, spec, w, k, n[0] - 1, **kw)

            t0 = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(TRAIN_TIMES_STEPS):
                step()
            torch.cuda.synchronize()
            compute = (time.perf_counter() - t0) / TRAIN_TIMES_STEPS
            fetched = []
            for _ in range(TRAIN_TIMES_STEPS):
                t0 = time.perf_counter()
                chassis.fetch(step())
                fetched.append(time.perf_counter() - t0)
            with profiling.trace(os.path.join(tmp, f"prof_{mode}")) as prof:
                for _ in range(TRAIN_TIMES_PROFILED):
                    chassis.fetch(step())
            peak = torch.cuda.max_memory_allocated() / 2**30
            busy = prof["device_busy_share"]
            state = mesh_mod.digest({**model.state_dict(), **opt.named_state()})
            print(f"[times] train step, {mode}: compute-only {compute * 1e3:.2f} ms a step "
                  f"({TRAIN_TIMES_STEPS} steps; 3 warm-up steps in {warm:.2f} s), "
                  f"with a fetch after every step median "
                  f"{statistics.median(fetched) * 1e3:.2f} ms (min {min(fetched) * 1e3:.2f}, "
                  f"max {max(fetched) * 1e3:.2f}); peak memory {peak:.3f} GiB; "
                  f"profiled {TRAIN_TIMES_PROFILED} fetched steps: device busy "
                  f"{'not seen' if busy is None else f'{busy * 100:.2f}%'} of "
                  f"{prof['window_ms']:.1f} ms, "
                  f"{prof['n_kernels'] / TRAIN_TIMES_PROFILED:.1f} kernels and copies "
                  f"a step; state after {n[0]} steps {state[:16]} | {card}")
            del model, opt, step


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
    if sys.argv[1:] == ["--serve-times"]:
        serve_times(card, dev)
        return 0
    if sys.argv[1:] == ["--train-times"]:
        train_times(card, dev)
        return 0
    if sys.argv[1:2] == ["--train-rank"]:
        return train_rank(sys.argv[2:])
    if sys.argv[1:] == ["--three-tap"]:
        phase_build(card)
        print(json.dumps({"three_tap": phase_three_tap(card, dev)}))
        return 0
    if sys.argv[1:] == ["--mol"]:
        phase_build(card)
        print(json.dumps({"mol": phase_mol(card, dev)}))
        return 0
    if sys.argv[1:] == ["--mesh-cards"]:
        phase_build(card)
        mesh_cards(card)
        return 0
    t_start = time.perf_counter()
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
    mol = phase_mol(card, dev)
    g = phase_train_kernels(card, dev)
    phase_three_tap(card, dev)
    with tempfile.TemporaryDirectory() as tmp:
        t = phase_train(card, dev, tmp)
        e = phase_eval(card, t["data"], t["ckpt_vq"])
    with tempfile.TemporaryDirectory() as tmp:
        inv = phase_inverter(card, dev, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        par = phase_parallel(card, dev, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        instr = phase_instruments(card, dev, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        meas = phase_measures(card, dev, tmp)
    bench_ph = phase_bench(card, dev, meas["probe"])

    def extra(name: str) -> int:
        """Phases 9 to 13's launches of one kernel."""
        return sum(p["launches"].get(name, 0)
                   for p in (inv, par, instr, meas, bench_ph))

    for mode, row in meas["by_batch"].items():
        k[mode]["by_batch"][MEASURE_GEN_BATCH] = row

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
    # the mixture-of-logistics tail has no TPU kernel: the port's own, timed
    # at the MoL cell's batch
    kernels.append({"name": "fastgen_mol", "route": "cuda", "source": fastgen,
                    "replaces": None, "library_ms": None, "batch": MOL_B,
                    "per": "generated step", **mol})

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
    vq_by_n.update(meas["vq_by_n"])
    kernels.append({
        "name": "vq_lookup", "route": "cuda",
        "source": "ae_wavenet_tpu_torch/csrc/vq.cu",
        "replaces": "ae_wavenet_tpu/ops/vq_pallas.py:66",
        "launches": s["launches"]["vq"] + t["launches"]["vq_lookup_fused"]
        + e["launches"] + extra("vq_lookup_fused"), **vq_train, "library_ms": None,
        "n": v["training step"]["n"], "by_n": vq_by_n})
    print(f"[smoke] phases 1-13 in {time.perf_counter() - t_start:.1f} s | {card}")
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
