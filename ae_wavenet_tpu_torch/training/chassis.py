"""Training chassis: optimizer, train step, loop, checkpoints and eval.

Counterpart of ``ae_wavenet_tpu.training.chassis``:

* :class:`Adam` is ``make_optimizer`` (``:45``): optax's
  ``chain([clip_by_global_norm], adam | adamw)`` with a constant or
  piecewise-constant LR, computed as optax computes it, with its state
  under the names ``flatten_named`` gives optax's (``opt_state.<i>.0.count``,
  ``.mu.<param>``, ``.nu.<param>``, and the schedule's ``.count``).
* :func:`train_step` is ``make_train_step`` (``:63``): loss, backward,
  the global grad norm, the update; K steps per call report the last
  step's metrics.  The step's random draws (jitter, restarts, VAE eps)
  come from a generator seeded by (seed, step), so a resume continues the
  same stream; under data parallelism by (seed, step, rank) (the
  reference folds the replica index into the key).  They are drawn up
  front and every input of the step is a device tensor, so on the card the
  step is one CUDA graph replayed K times a call: the counterpart of the
  reference's one jitted step and its K-step ``lax.scan`` (``:110-124``).
* :class:`Chassis` (``:150``): holdout split, ``train`` (one metrics
  fetch per log point, async ``ckpt_every`` saves with keep-last-N and
  keep-best retention, SIGTERM/SIGINT save and stop, a profiler trace of
  the first ``profile_steps`` steps), ``evaluate``, ``save`` and ``resume``.

Data parallelism (``mesh``, a ``parallel.mesh.Mesh``) is the reference's
per-shard program (``dp_impl="shard_map"``, ``:80-84``): each rank trains
on its rows of the global batch; one all-reduce of the flattened f32
gradients, divided by the world size, comes before the optimizer (so the
global-norm clip sees the mean, as optax does), the metrics are averaged
before logging, the VQ-EMA statistics are summed (models/bottlenecks.py);
``evaluate`` averages over the ranks; the stop flags are all-gathered every
``min(log_every, 50)`` steps, at the same steps on every rank; rank 0
alone writes checkpoints, and the ranks meet after its writes.  At a world
size of 1 a step is bit for bit the step without a mesh.

Checkpoints are export files (``training/weights.py``) named
``step_XXXXXXXX.pt`` in the checkpoint directory, written and pruned by
``training/checkpoint.py``.  The model family (init, loss, window spec)
comes from ``models/registry`` by ``cfg.model_kind``.  With
``spec.norm="dataset"`` and no stored statistics, the dataset's frame
statistics are computed once and baked into the config, so every
checkpoint carries them.  It runs on the card unless the caller passes
``device="cpu"`` (under a mesh, on the mesh's device).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import signal
import sys
import threading
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ae_wavenet_tpu_torch.data.dataset import PackedDataset, WindowSampler
from ae_wavenet_tpu_torch.data.loader import device_batches
from ae_wavenet_tpu_torch.data.preprocess import dataset_frame_stats
from ae_wavenet_tpu_torch.models import registry
from ae_wavenet_tpu_torch.parallel import mesh as mesh_mod
from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod
from ae_wavenet_tpu_torch.training import weights
from ae_wavenet_tpu_torch.utils import device as device_mod
from ae_wavenet_tpu_torch.utils import profiling as prof_mod
from ae_wavenet_tpu_torch.utils.config import RunConfig, TrainConfig
from ae_wavenet_tpu_torch.utils.debug import assert_all_finite
from ae_wavenet_tpu_torch.utils.logging import MetricsLogger


class Adam:
    """optax ``chain([clip_by_global_norm(c)], adam|adamw(lr))`` on a
    module's parameters (f32 moments on the parameters' device).  The bias
    corrections change every update: they are computed on the host as
    optax computes them (:meth:`corrections`) and reach :meth:`update` as a
    device tensor, so an update can be captured in a CUDA graph.  The
    learning rate stays a host float (``alpha`` of the last add, fused into
    one FMA on the card; a tensor there would round twice): a schedule is
    piecewise constant, and a step program captures one graph per value.
    ``programs`` holds :func:`train_step`'s step programs for these
    parameters; a load drops them."""

    def __init__(self, named_params, cfg: TrainConfig):
        self.cfg = cfg
        self.params = dict(named_params)
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0          # scale_by_adam's count
        self.sched_count = 0    # the LR schedule's count (piecewise LR only)
        self.programs: dict = {}

    def lr(self, count: int) -> float:
        t = self.cfg
        if not t.lr_boundaries:
            return t.learning_rate
        k = sum(count >= b for b in t.lr_boundaries)
        return t.lr_values[k]

    def corrections(self, k: int, device) -> torch.Tensor:
        """The next ``k`` updates' bias corrections 1 - b1^t, 1 - b2^t (f32
        powers, as optax), [k, 2] f32 on the host, in the form the update
        on ``device`` applies them: on a CUDA device their reciprocals,
        taken in double precision, by which it multiplies; on the CPU the
        corrections, by which it divides.  That is how PyTorch divides by a
        host float on each, so the update is bit for bit the one that took
        them as host floats.  The counts move only by :meth:`advance`."""
        t = self.cfg
        f32 = torch.tensor([t.adam_b1, t.adam_b2], dtype=torch.float32)
        bc = torch.stack([1.0 - f32 ** (self.count + i + 1) for i in range(k)])
        if torch.device(device).type == "cuda":
            return (1.0 / bc.double()).float()
        return bc

    def rates(self, k: int = 1) -> list:
        """The next ``k`` updates' learning rates."""
        return [self.lr(self.sched_count + i) for i in range(k)]

    def advance(self, k: int = 1) -> None:
        """Count ``k`` updates done (the state's counts)."""
        self.count += k
        if self.cfg.lr_boundaries:
            self.sched_count += k

    @torch.no_grad()
    def update(self, grads: dict, bc: torch.Tensor, lr: float) -> torch.Tensor:
        """Update the parameters in place from ``grads`` ({name: tensor or
        None}, None = zero) with ``bc`` [2], one row of :meth:`corrections`
        on the parameters' device, at the learning rate ``lr`` (``alpha`` of
        the last add); the counts are left to :meth:`advance`.  Returns the
        global norm of the raw grads.  Multi-tensor (``torch._foreach_*``)
        ops: a few launches an update."""
        t = self.cfg
        names = list(self.params)
        ps = [self.params[k] for k in names]
        gs = [grads[k] if grads.get(k) is not None else torch.zeros_like(p)
              for k, p in zip(names, ps)]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
        if t.grad_clip > 0:
            keep = norm < t.grad_clip
            gs = [torch.where(keep, g, (g / norm) * t.grad_clip) for g in gs]
        bc1, bc2 = bc[0], bc[1]
        scale = torch._foreach_mul if ps[0].is_cuda else torch._foreach_div
        mu = [self.mu[k] for k in names]
        nu = [self.nu[k] for k in names]
        torch._foreach_mul_(mu, t.adam_b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - t.adam_b1)
        torch._foreach_mul_(nu, t.adam_b2)
        torch._foreach_add_(nu, torch._foreach_mul(gs, gs), alpha=1.0 - t.adam_b2)
        den = scale(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, t.adam_eps)
        u = torch._foreach_div(scale(mu, bc1), den)
        if t.weight_decay > 0:
            torch._foreach_add_(u, ps, alpha=t.weight_decay)
        torch._foreach_add_(ps, u, alpha=-lr)
        return norm

    def step(self, grads: dict) -> torch.Tensor:
        """One update; returns the global norm of the raw grads."""
        dev = next(iter(self.params.values())).device
        norm = self.update(grads, self.corrections(1, dev)[0].to(dev), self.rates(1)[0])
        self.advance(1)
        return norm

    # optax's state names (training/torch_compat.flatten_named)
    def _prefix(self) -> str:
        return f"opt_state.{1 if self.cfg.grad_clip > 0 else 0}"

    def _sched_name(self) -> str | None:
        if not self.cfg.lr_boundaries:
            return None
        return f"{self._prefix()}.{2 if self.cfg.weight_decay > 0 else 1}.count"

    def named_state(self) -> dict:
        pre = self._prefix()
        out = {f"{pre}.0.count": torch.tensor(self.count, dtype=torch.int32)}
        for k in self.params:
            out[f"{pre}.0.mu.{k}"] = self.mu[k]
            out[f"{pre}.0.nu.{k}"] = self.nu[k]
        if self._sched_name():
            out[self._sched_name()] = torch.tensor(self.sched_count, dtype=torch.int32)
        return out

    def load_named(self, named: dict) -> None:
        """The state from ``named``, copied into the moments' own storages (a
        captured step reads them by address); the step programs are
        dropped."""
        pre = self._prefix()
        weights.check_merge(
            {k: v.shape for k, v in self.named_state().items()},
            {k: v for k, v in named.items() if k.startswith("opt_state.")},
            "opt_state")
        self.count = int(named[f"{pre}.0.count"])
        for k, p in self.params.items():
            for slot, store in (("mu", self.mu), ("nu", self.nu)):
                v = torch.as_tensor(named[f"{pre}.0.{slot}.{k}"]).float()
                store[k].copy_(v.reshape(p.shape))
        if self._sched_name():
            self.sched_count = int(named[self._sched_name()])
        self.programs.clear()


def step_generator(seed: int, step: int, device, mesh=None) -> torch.Generator:
    """The step's draws: a generator seeded by (seed, step), and by the
    rank too on a mesh of more than one rank."""
    key = [seed, step] if mesh is None or mesh.size == 1 else [seed, step, mesh.rank]
    s = int(np.random.SeedSequence(key).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


WARMUP_STEPS = 1  # eager steps on the capture stream before a capture


def _launch_counts() -> dict:
    """{(function, attribute): count} of every launch counter of the
    kernels a training step can run and of their plain versions."""
    from ae_wavenet_tpu_torch.ops import gated, gated_cuda, vq_cuda

    out = {}
    for mod in (gated, gated_cuda, vq_cuda):
        for f in vars(mod).values():
            if inspect.isfunction(f):
                out.update(((f, a), v) for a, v in vars(f).items()
                           if a.startswith("launches"))
    return out


class _Captured(NamedTuple):
    """One capture of a step program's step at one learning rate: the graph,
    the step's metrics vector and the parameters' gradients it writes (at
    fixed addresses in its pool), and what one replay launches of each
    counted kernel."""
    graph: object
    out: torch.Tensor
    grads: dict
    per_replay: dict


class _StepProgram:
    """One training step whose every input is a tensor on the step's
    device, for calls of K steps at one batch shape:

    wav [K, B, U], spk [K, B]   the call's batches (one copy each a call);
    draws {name: [K, ...]}      each step's draws, made up front from its
                                step generator (the family's ``draws``);
    sc [K, 3] f32               each step's index (the bottlenecks' ramps
                                read it) and :meth:`Adam.corrections`, one
                                host-to-device copy a call;
    j [1] int64                 the step within the call, advanced by the
                                step itself.

    The learning rate is the one host float a step takes (:class:`Adam`).
    :meth:`run` plays the call's K steps: on a CUDA device without a mesh,
    unless ``eager``, a CUDA graph of the step replayed once a step (one
    capture per learning rate, made at its first call, :meth:`capture`),
    the counterpart of the reference's jitted step and its K-step scan;
    else the same step called in a Python loop.  The step returns its
    metrics as one f32 vector (``keys``)."""

    def __init__(self, model, opt: Adam, cfg: RunConfig, spec, wav, spk, k: int,
                 mesh):
        self.model, self.opt = model, weakref.proxy(opt)  # opt holds the program
        self.cfg, self.spec, self.k, self.mesh = cfg, spec, k, mesh
        self.family = registry.get(cfg.model_kind)
        dev = wav.device
        self.wav = torch.empty((k, *wav.shape[-2:]), dtype=wav.dtype, device=dev)
        self.spk = torch.empty((k, spk.shape[-1]), dtype=spk.dtype, device=dev)
        self.sc = torch.empty(k, 3, device=dev)
        self.j = torch.zeros(1, dtype=torch.long, device=dev)
        self.draws: dict | None = None
        self.keys: list = []
        self.rates: list = []
        self.graphs: dict = {}  # learning rate -> _Captured

    def load(self, wav, spk, step: int) -> None:
        """The call's inputs: steps ``step`` .. ``step`` + K - 1."""
        k, dev = self.k, self.wav.device
        self.wav.copy_(wav.reshape(self.wav.shape))
        self.spk.copy_(spk.reshape(self.spk.shape))
        made = [self.family.draws(self.model, self.cfg, self.spec, self.wav.shape[1],
                                  step_generator(self.cfg.train.seed, step + i, dev,
                                                 self.mesh), dev) for i in range(k)]
        if self.draws is None:
            self.draws = {n: torch.empty((k, *v.shape), dtype=v.dtype, device=dev)
                          for n, v in made[0].items()}
        for n, buf in self.draws.items():
            buf.copy_(torch.stack([m[n] for m in made]))
        host = torch.cat([torch.arange(step, step + k, dtype=torch.float32)[:, None],
                          self.opt.corrections(k, dev)], 1)
        self.sc.copy_(host.pin_memory() if dev.type == "cuda" else host,
                      non_blocking=True)
        self.rates = self.opt.rates(k)
        self.j.zero_()

    def _row(self, t: torch.Tensor) -> torch.Tensor:
        return t.index_select(0, self.j)[0]

    def _step(self, lr: float) -> torch.Tensor:
        """Step j of the call: loss, backward, (under a mesh the mean of the
        gradients and of the metrics,) the update at ``lr``."""
        params = self.opt.params
        for p in params.values():
            p.grad = None
        sc = self._row(self.sc)
        total, metrics = self.family.loss_fn(
            self.model, self.cfg, self.spec, self._row(self.wav), self._row(self.spk),
            sc[0], True, None, {n: self._row(v) for n, v in self.draws.items()},
            group=self.mesh)
        total.backward()
        keys = list(metrics)
        vec = torch.stack([metrics[n].detach().float().reshape(()) for n in keys])
        if self.mesh is not None:
            # loss and grads are local-batch means; equal shard sizes make the
            # mean over the ranks exactly the global-batch mean
            for p in params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.mesh.mean_([p.grad for p in params.values()])
            self.mesh.mean_([vec])
        norm = self.opt.update({n: p.grad for n, p in params.items()}, sc[1:], lr)
        self.j.add_(1)
        self.keys = [*keys, "grad_norm"]
        return torch.cat([vec, norm.float().reshape(1)])

    def graphed(self, eager: bool) -> bool:
        return self.wav.is_cuda and self.mesh is None and not eager

    def capture_rates(self) -> None:
        """A capture for each learning rate of the loaded call that has none;
        the captures of rates it does not take are dropped first (a schedule
        only moves on)."""
        for lr in [lr for lr in self.graphs if lr not in self.rates]:
            del self.graphs[lr]
        for lr in dict.fromkeys(self.rates):
            if lr not in self.graphs:
                self.graphs[lr] = self.capture(lr)

    def capture(self, lr: float) -> _Captured:
        """WARMUP_STEPS eager steps on a side stream on the call's inputs
        (cuBLAS, cuDNN, the kernels' attributes, the frontend's constants
        and the allocator initialise there), the training state they write
        restored after them, then the step at ``lr`` captured as a CUDA
        graph on that stream (``thread_local``: the loader thread may copy
        meanwhile).  The warm-up's launches count; the capture's record
        what each replay launches.  A failed capture raises."""
        dev = self.wav.device
        written = [*self.opt.params.values(), *self.opt.mu.values(),
                   *self.opt.nu.values(), *self.model.buffers()]
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.no_grad():
            saved = [t.clone() for t in written]
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._step(lr)
        finally:
            with torch.cuda.stream(side), torch.no_grad():
                for t, v in zip(written, saved):
                    t.copy_(v)
                self.j.zero_()
            for p in self.opt.params.values():
                p.grad = None
            main.wait_stream(side)
            del saved
        graph, before = torch.cuda.CUDAGraph(), _launch_counts()
        try:
            # the outer stream context gives the caller back its stream where
            # a failed capture raises from the graph context's exit
            with torch.cuda.stream(side), torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                out = self._step(lr)
        finally:
            after = _launch_counts()
            for (f, a), n in before.items():
                setattr(f, a, n)
        self.counted.captures += 1
        per_replay = {fa: after[fa] - n for fa, n in before.items() if after[fa] != n}
        return _Captured(graph, out, {n: p.grad for n, p in self.opt.params.items()},
                         per_replay)

    def run(self, eager: bool) -> dict:
        """The call's K steps -> the last step's metrics (0-d tensors)."""
        if not self.graphed(eager):
            for lr in self.rates:
                vec = self._step(lr)
            self.counted.eager_steps += self.k
            return dict(zip(self.keys, vec.unbind()))
        self.capture_rates()
        for lr in self.rates:
            self.graphs[lr].graph.replay()
        self.counted.graph_replays += self.k
        for lr in self.rates:
            for (f, a), n in self.graphs[lr].per_replay.items():
                setattr(f, a, getattr(f, a) + n)
        last = self.graphs[self.rates[-1]]
        for n, p in self.opt.params.items():
            p.grad = last.grads[n]
        return dict(zip(self.keys, last.out.clone().unbind()))


def _program(model, opt: Adam, cfg: RunConfig, spec, wav, spk, k_steps: int,
             mesh) -> _StepProgram:
    key = (tuple(wav.shape), wav.dtype, str(wav.device), k_steps, cfg, spec, mesh)
    if key not in opt.programs:
        opt.programs[key] = _StepProgram(model, opt, cfg, spec, wav, spk, k_steps, mesh)
    return opt.programs[key]


def train_step(model, opt: Adam, cfg: RunConfig, spec, wav, spk, step: int,
               k_steps: int = 1, mesh=None, eager: bool = False) -> dict:
    """One step (or K: wav/spk then carry a leading [K] axis and the
    metrics are the last step's).  Returns 0-d metric tensors, including
    ``grad_norm``.  On a ``mesh`` wav/spk are this rank's rows; the
    parameters' ``.grad`` then hold the mean over the ranks.

    The step is a :class:`_StepProgram`, cached on ``opt`` by the batch
    shape, K, the config (the schedule flags with it), the window spec and
    the mesh.  On a CUDA device without a mesh it runs as a CUDA graph
    replayed K times a call (captured once per learning rate);
    ``eager=True`` runs the same step in a Python loop (the graph's plain
    version), as the CPU always does.  Under a mesh
    the step stays eager: a gloo collective cannot be captured, and NCCL's
    capture is not yet checked.  A failed capture raises; nothing carries
    on eagerly.  Counts ``train_step.graph_replays``, ``.eager_steps`` and
    ``.captures``; a replay adds to each kernel's launch counter what its
    capture recorded."""
    prog = _program(model, opt, cfg, spec, wav, spk, k_steps, mesh)
    prog.load(wav, spk, step)
    metrics = prog.run(eager)
    opt.advance(k_steps)
    return metrics


train_step.graph_replays = train_step.eager_steps = train_step.captures = 0
_StepProgram.counted = staticmethod(train_step)  # its counters, where a caller wraps it


def prepare_step(model, opt: Adam, cfg: RunConfig, spec, wav, spk, step: int,
                 k_steps: int = 1, mesh=None) -> None:
    """Capture now what :func:`train_step` would capture at its first call
    on these inputs (nothing where it would run eagerly, or has captured):
    a profiled window then holds replays only.  The training state does not
    move."""
    prog = _program(model, opt, cfg, spec, wav, spk, k_steps, mesh)
    if prog.graphed(False):
        prog.load(wav, spk, step)
        prog.capture_rates()


def fetch(metrics: dict) -> dict:
    """All metrics in one device-to-host transfer."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys])
    return dict(zip(keys, vals.cpu().tolist()))


class Chassis:
    """Owns config, model, optimizer and data; ``train(n)`` runs the loop.
    ``mesh``: this rank's ``parallel.mesh.Mesh`` for data parallelism (the
    model then lives on the mesh's device)."""

    def __init__(self, cfg: RunConfig, data_prefix: str, ckpt_dir: str | None = None,
                 device="cuda", log_stream=None, nan_checks: bool = False,
                 mesh=None, profile_dir: str | None = None,
                 profile_steps: int = 0, tb_logdir: str | None = None):
        if mesh is not None:
            mesh_mod.check_batch_divisible(cfg.train.batch_sz, mesh)
        self.mesh = mesh
        self.family = registry.get(cfg.model_kind)
        if cfg.spec.norm == "dataset" and not cfg.spec.stats_mean:
            mean, var = dataset_frame_stats(data_prefix, cfg.spec)
            cfg = dataclasses.replace(cfg, spec=dataclasses.replace(
                cfg.spec, stats_mean=mean, stats_var=var))
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        self.device = mesh.device if mesh is not None else device_mod.resolve(device)
        self.logger = MetricsLogger(log_stream if log_stream is not None else sys.stdout,
                                    tb_logdir=tb_logdir)
        if mesh is not None:
            self.logger.log(0, mesh.describe())
        self.nan_checks = nan_checks
        if profile_dir and mesh is not None and mesh.size > 1:
            profile_dir = os.path.join(profile_dir, f"rank{mesh.rank}")
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps if profile_dir else 0
        self.profile_summary: dict = {}
        self.preempted = False
        self.spec = self.family.make_window_spec(cfg)
        self.dataset = PackedDataset(data_prefix)
        if self.dataset.n_speakers > cfg.wavenet.n_speakers:
            raise ValueError(
                f"dataset has {self.dataset.n_speakers} speakers but "
                f"wavenet.n_speakers={cfg.wavenet.n_speakers}")
        k = cfg.train.holdout_every
        n_clips = len(self.dataset)
        hold = train_idx = None
        if k > 0 and n_clips > 1:
            all_idx = np.arange(n_clips)
            hold, train_idx = all_idx[all_idx % k == 0], all_idx[all_idx % k != 0]
            if len(train_idx) == 0:
                raise ValueError(f"holdout_every={k} leaves no training clips "
                                 f"({n_clips} total)")
        self.sampler = WindowSampler(self.dataset, self.spec.u_len,
                                     cfg.train.batch_sz, cfg.train.seed,
                                     clip_indices=train_idx)
        # what this rank trains on: its rows of every global batch
        self._feed = self.sampler if mesh is None else mesh_mod.LocalRows(self.sampler,
                                                                         mesh)
        self.eval_sampler = None
        if hold is not None:
            try:
                self.eval_sampler = WindowSampler(
                    self.dataset, self.spec.u_len, cfg.train.batch_sz,
                    cfg.train.seed, clip_indices=hold)
            except ValueError as e:
                sys.stderr.write(f"warning: holdout split unusable ({e}); "
                                 "evaluate() falls back to the training clips\n")
        self.k_steps = max(1, cfg.train.steps_per_call)
        self.model = self.family.init(
            cfg, torch.Generator().manual_seed(cfg.train.seed + 1), self.device)
        self.opt = Adam(self.model.named_parameters(), cfg.train)
        self.step = 0
        self.stats: dict = {}
        self._saver: ckpt_mod.Saver | None = None
        self._unmet_saves = False  # a save issued since the ranks last met
        # best-holdout tracking for checkpoint retention: the last holdout
        # eval as (step, recon CE), and the (step, CE) of the best
        # checkpoint so far (kept by pruning, recorded in the BEST sidecar)
        self._last_eval: tuple[int, float] | None = None
        self.best_ckpt: tuple[int, float] | None = None

    # ------------------------------------------------------------ persist
    def save(self, blocking: bool = True) -> str:
        """``blocking=False`` (the loop's periodic saves): take the host
        snapshot and return while a background thread writes the file.  A
        holdout eval counts for the checkpoint that holds the weights it
        evaluated, so BEST names the step that was evaluated: an eval at
        another step than a save is attributed to no checkpoint.  Under a
        mesh rank 0 alone writes (every rank holds the same state), and a
        blocking save is a collective: the ranks return after rank 0's
        file is complete (``wait_for_saves``)."""
        if not self.ckpt_dir:
            raise ValueError("no checkpoint directory")
        ev = self._last_eval
        if ev is not None and ev[0] == self.step and (
                self.best_ckpt is None or ev[1] < self.best_ckpt[1]):
            self.best_ckpt = ev
        if self.mesh is not None and self.mesh.rank != 0:
            path = ckpt_mod.checkpoint_path(self.ckpt_dir, self.step)
        else:
            if self._saver is None:
                self._saver = ckpt_mod.Saver()
            state = weights.export_state(self.model, self.opt.named_state())
            path = self._saver.save(self.ckpt_dir, self.step, state, self.cfg,
                                    blocking=blocking,
                                    keep_last=self.cfg.train.ckpt_keep,
                                    best=self.best_ckpt)
        self._unmet_saves = True
        if blocking:
            self.wait_for_saves()
        return path

    def wait_for_saves(self, meet: bool = True) -> None:
        """Until every save issued is complete.  Under a mesh, with
        ``meet``, the ranks then meet at a barrier if a save was issued
        since they last met (every rank issues its saves at the same steps,
        so they agree): none reads a checkpoint before rank 0 has written
        it.  ``meet=False`` is for unwinding a fault, which the other ranks
        may never reach."""
        if self._saver is not None:
            self._saver.wait()
        if meet and self.mesh is not None and self._unmet_saves:
            self.mesh.barrier()
            self._unmet_saves = False

    def close(self) -> None:
        """Wait for the saves, close the TensorBoard writer, if any, and free
        the captured steps (their graphs hold the step's device memory)."""
        self.wait_for_saves()
        self.logger.close()
        self.opt.programs.clear()

    def resume(self, step: int | None = None) -> int:
        got, named, _cfg = ckpt_mod.load(self.ckpt_dir, step)
        weights.load_into(self.model, named)
        self.opt.load_named(named)
        self.step = got
        # go on tracking the best checkpoint, or the first save after the
        # resume could prune it
        self.best_ckpt = ckpt_mod.best_info(self.ckpt_dir)
        return got

    # --------------------------------------------------------------- eval
    @torch.no_grad()
    def evaluate(self, n_batches: int = 8, stream_offset: int = 1 << 30) -> dict:
        """Eval-mode metrics (no jitter, no state update) averaged over
        ``n_batches``, from the holdout clips when there are any."""
        sampler = self.eval_sampler if self.eval_sampler is not None else self.sampler
        if self.mesh is not None:
            sampler = mesh_mod.LocalRows(sampler, self.mesh)
        totals: dict = {}
        for i in range(n_batches):
            wav, spk = sampler.batch_at(stream_offset + self.step + i)
            gen = step_generator(self.cfg.train.seed + 2, self.step, self.device,
                                 self.mesh)
            _, m = self.family.loss_fn(
                self.model, self.cfg, self.spec, torch.from_numpy(wav).to(self.device),
                torch.from_numpy(spk.astype(np.int64)).to(self.device), self.step,
                False, gen, group=self.mesh)
            for k, v in fetch(m).items():
                totals[k] = totals.get(k, 0.0) + v / n_batches
        if self.mesh is not None:
            vec = torch.tensor(list(totals.values()), dtype=torch.float64,
                               device=self.device)
            self.mesh.mean_([vec])
            totals = dict(zip(totals, vec.tolist()))
        totals["split"] = "holdout" if self.eval_sampler is not None else "train"
        return totals

    # -------------------------------------------------------------- train
    def train(self, n_steps: int | None = None, eval_every: int = 0) -> list[dict]:
        t_cfg = self.cfg.train
        n_steps = t_cfg.n_steps if n_steps is None else n_steps
        self.preempted = False
        kk = self.k_steps
        if n_steps % kk:
            raise ValueError(f"n_steps={n_steps} must be a multiple of "
                             f"steps_per_call={kk}")

        def crossed(every: int, lo: int, hi: int) -> bool:
            return every > 0 and (hi // every) > (lo // every)

        # under a mesh every rank must save at the same step: the flags are
        # all-gathered at a fixed small cadence (the same steps on every
        # rank) and the ranks stop together iff any was signalled
        stop_check_every = min(t_cfg.log_every, 50)

        def stop_requested(lo: int, hi: int) -> bool:
            if self.mesh is None:
                return stop["flag"]
            return crossed(stop_check_every, lo, hi) and self.mesh.any(stop["flag"])

        history: list[dict] = []
        start = self.step
        t0 = time.perf_counter()
        samples_done = 0
        stop = {"flag": False}
        old_handlers = {}
        if self.ckpt_dir and threading.current_thread() is threading.main_thread():
            def _handler(signum, frame):
                stop["flag"] = True
            for sig in (signal.SIGTERM, signal.SIGINT):
                old_handlers[sig] = signal.signal(sig, _handler)
        # a trace of the first profile_steps steps (utils/profiling), opened
        # after the step's capture, so that it holds the replayed step
        prof_stack = contextlib.ExitStack()
        profiling = self.profile_steps > 0
        finished = False
        try:
            for s, (wav, spk) in device_batches(self._feed, self.step, n_steps,
                                                self.device, block=kk,
                                                stats=self.stats):
                if profiling and self.step == start:
                    prepare_step(self.model, self.opt, self.cfg, self.spec, wav, spk,
                                 s, kk, self.mesh)
                    self.profile_summary = prof_stack.enter_context(
                        prof_mod.trace(self.profile_dir))
                metrics = train_step(self.model, self.opt, self.cfg, self.spec,
                                     wav, spk, s, kk, self.mesh)
                self.step = s + kk
                samples_done += kk * t_cfg.batch_sz * self.spec.n_win
                if profiling and self.step - start >= self.profile_steps:
                    prof_stack.close()  # waits for the device, writes the trace
                    profiling = False
                    self.logger.log(self.step, {
                        "profile_trace": self.profile_dir,
                        "profile_window_ms": self.profile_summary["window_ms"],
                        "profile_device_busy_share":
                            self.profile_summary["device_busy_share"]})
                if crossed(t_cfg.log_every, s, self.step) or \
                        self.step == start + n_steps:
                    fetched = fetch(metrics)
                    if self.nan_checks:
                        if not all(np.isfinite(v) for v in fetched.values()):
                            raise FloatingPointError(
                                f"non-finite metrics at step {self.step}: {fetched}")
                        assert_all_finite(self.model.named_parameters(), "params")
                    dt = time.perf_counter() - t0
                    rec = {"step": self.step,
                           "samples_per_sec": samples_done / max(dt, 1e-9), **fetched}
                    history.append(rec)
                    self.logger.log(self.step, {k: v for k, v in rec.items()
                                                if k != "step"})
                    t0 = time.perf_counter()
                    samples_done = 0
                if eval_every and crossed(eval_every, s, self.step):
                    ev = {f"eval_{k}": v for k, v in self.evaluate().items()}
                    self.logger.log(self.step, ev)
                    self._last_eval = (self.step, float(ev["eval_recon_ce"]))
                if self.ckpt_dir and crossed(t_cfg.ckpt_every, s, self.step):
                    self.save(blocking=False)
                if stop_requested(s, self.step):
                    self.preempted = True
                    path = self.save()
                    self.logger.log(self.step, {"preempted_at": self.step,
                                                "saved": path})
                    break
            finished = True
        finally:
            prof_stack.close()
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            # the loop's async saves are complete before train() returns
            # (callers resume or read checkpoints right after)
            self.wait_for_saves(meet=finished)
        return history
