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
  same stream.
* :class:`Chassis` (``:150``): holdout split, ``train`` (one metrics
  fetch per log point, async ``ckpt_every`` saves with keep-last-N and
  keep-best retention, SIGTERM/SIGINT save and stop, a profiler trace of
  the first ``profile_steps`` steps), ``evaluate``, ``save`` and ``resume``.

Checkpoints are export files (``training/weights.py``) named
``step_XXXXXXXX.pt`` in the checkpoint directory, written and pruned by
``training/checkpoint.py``.  The model family (init, loss, window spec)
comes from ``models/registry`` by ``cfg.model_kind``.  With
``spec.norm="dataset"`` and no stored statistics, the dataset's frame
statistics are computed once and baked into the config, so every
checkpoint carries them.  It runs on the card unless the caller passes
``device="cpu"``.  Not ported yet (ROADMAP.md): data parallelism
(``mesh``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import sys
import threading
import time

import numpy as np
import torch

from ae_wavenet_tpu_torch.data.dataset import PackedDataset, WindowSampler
from ae_wavenet_tpu_torch.data.loader import device_batches
from ae_wavenet_tpu_torch.data.preprocess import dataset_frame_stats
from ae_wavenet_tpu_torch.models import registry
from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod
from ae_wavenet_tpu_torch.training import weights
from ae_wavenet_tpu_torch.utils import device as device_mod
from ae_wavenet_tpu_torch.utils import profiling as prof_mod
from ae_wavenet_tpu_torch.utils.config import RunConfig, TrainConfig
from ae_wavenet_tpu_torch.utils.debug import assert_all_finite
from ae_wavenet_tpu_torch.utils.logging import MetricsLogger


class Adam:
    """optax ``chain([clip_by_global_norm(c)], adam|adamw(lr))`` on a
    module's parameters (f32 moments on the parameters' device)."""

    def __init__(self, named_params, cfg: TrainConfig):
        self.cfg = cfg
        self.params = dict(named_params)
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0          # scale_by_adam's count
        self.sched_count = 0    # the LR schedule's count (piecewise LR only)

    def lr(self, count: int) -> float:
        t = self.cfg
        if not t.lr_boundaries:
            return t.learning_rate
        k = sum(count >= b for b in t.lr_boundaries)
        return t.lr_values[k]

    @torch.no_grad()
    def step(self, grads: dict) -> torch.Tensor:
        """Update the parameters in place from ``grads`` ({name: tensor or
        None}, None = zero).  Returns the global norm of the raw grads.
        Multi-tensor (``torch._foreach_*``) ops: a few launches per step."""
        t = self.cfg
        names = list(self.params)
        ps = [self.params[k] for k in names]
        gs = [grads[k] if grads.get(k) is not None else torch.zeros_like(p)
              for k, p in zip(names, ps)]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
        if t.grad_clip > 0:
            keep = norm < t.grad_clip
            gs = [torch.where(keep, g, (g / norm) * t.grad_clip) for g in gs]
        self.count += 1
        f32 = torch.tensor([t.adam_b1, t.adam_b2], dtype=torch.float32)
        bc1, bc2 = (1.0 - f32 ** self.count).tolist()
        lr = self.lr(self.sched_count)
        if t.lr_boundaries:
            self.sched_count += 1
        mu = [self.mu[k] for k in names]
        nu = [self.nu[k] for k in names]
        torch._foreach_mul_(mu, t.adam_b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - t.adam_b1)
        torch._foreach_mul_(nu, t.adam_b2)
        torch._foreach_add_(nu, torch._foreach_mul(gs, gs), alpha=1.0 - t.adam_b2)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, t.adam_eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if t.weight_decay > 0:
            torch._foreach_add_(u, ps, alpha=t.weight_decay)
        torch._foreach_add_(ps, u, alpha=-lr)
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
        pre = self._prefix()
        weights.check_merge(
            {k: v.shape for k, v in self.named_state().items()},
            {k: v for k, v in named.items() if k.startswith("opt_state.")},
            "opt_state")
        self.count = int(named[f"{pre}.0.count"])
        for k, p in self.params.items():
            for slot, store in (("mu", self.mu), ("nu", self.nu)):
                v = torch.as_tensor(named[f"{pre}.0.{slot}.{k}"]).float()
                store[k] = v.reshape(p.shape).to(p.device)
        if self._sched_name():
            self.sched_count = int(named[self._sched_name()])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's draws: a generator seeded by (seed, step)."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def train_step(model, opt: Adam, cfg: RunConfig, spec, wav, spk, step: int,
               k_steps: int = 1) -> dict:
    """One step (or K: wav/spk then carry a leading [K] axis and the
    metrics are the last step's).  Returns 0-d metric tensors, including
    ``grad_norm``."""
    if k_steps > 1:
        for i in range(k_steps):
            m = train_step(model, opt, cfg, spec, wav[i], spk[i], step + i)
        return m
    gen = step_generator(cfg.train.seed, step, wav.device)
    for p in opt.params.values():
        p.grad = None
    total, metrics = registry.get(cfg.model_kind).loss_fn(model, cfg, spec, wav, spk,
                                                          step, True, gen)
    total.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = opt.step({k: p.grad for k, p in opt.params.items()})
    return metrics


def fetch(metrics: dict) -> dict:
    """All metrics in one device-to-host transfer."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys])
    return dict(zip(keys, vals.cpu().tolist()))


class Chassis:
    """Owns config, model, optimizer and data; ``train(n)`` runs the loop."""

    def __init__(self, cfg: RunConfig, data_prefix: str, ckpt_dir: str | None = None,
                 device="cuda", log_stream=None, nan_checks: bool = False,
                 mesh=None, profile_dir: str | None = None,
                 profile_steps: int = 0, tb_logdir: str | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "data parallelism is not ported yet (ROADMAP.md, modules: data "
                "parallel)")
        self.family = registry.get(cfg.model_kind)
        if cfg.spec.norm == "dataset" and not cfg.spec.stats_mean:
            mean, var = dataset_frame_stats(data_prefix, cfg.spec)
            cfg = dataclasses.replace(cfg, spec=dataclasses.replace(
                cfg.spec, stats_mean=mean, stats_var=var))
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        self.device = device_mod.resolve(device)
        self.logger = MetricsLogger(log_stream if log_stream is not None else sys.stdout,
                                    tb_logdir=tb_logdir)
        self.nan_checks = nan_checks
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
        another step than a save is attributed to no checkpoint."""
        if not self.ckpt_dir:
            raise ValueError("no checkpoint directory")
        if self._saver is None:
            self._saver = ckpt_mod.Saver()
        ev = self._last_eval
        if ev is not None and ev[0] == self.step and (
                self.best_ckpt is None or ev[1] < self.best_ckpt[1]):
            self.best_ckpt = ev
        state = weights.export_state(self.model, self.opt.named_state())
        return self._saver.save(self.ckpt_dir, self.step, state, self.cfg,
                                blocking=blocking,
                                keep_last=self.cfg.train.ckpt_keep,
                                best=self.best_ckpt)

    def wait_for_saves(self) -> None:
        if self._saver is not None:
            self._saver.wait()

    def close(self) -> None:
        """Wait for the saves and close the TensorBoard writer, if any."""
        self.wait_for_saves()
        self.logger.close()

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
        totals: dict = {}
        for i in range(n_batches):
            wav, spk = sampler.batch_at(stream_offset + self.step + i)
            gen = step_generator(self.cfg.train.seed + 2, self.step, self.device)
            _, m = self.family.loss_fn(
                self.model, self.cfg, self.spec, torch.from_numpy(wav).to(self.device),
                torch.from_numpy(spk.astype(np.int64)).to(self.device), self.step,
                False, gen)
            for k, v in fetch(m).items():
                totals[k] = totals.get(k, 0.0) + v / n_batches
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
        # a trace of the first profile_steps steps (utils/profiling)
        prof_stack = contextlib.ExitStack()
        profiling = self.profile_steps > 0
        if profiling:
            self.profile_summary = prof_stack.enter_context(
                prof_mod.trace(self.profile_dir))
        try:
            for s, (wav, spk) in device_batches(self.sampler, self.step, n_steps,
                                                self.device, block=kk,
                                                stats=self.stats):
                metrics = train_step(self.model, self.opt, self.cfg, self.spec,
                                     wav, spk, s, kk)
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
                if stop["flag"]:
                    self.preempted = True
                    path = self.save()
                    self.logger.log(self.step, {"preempted_at": self.step,
                                                "saved": path})
                    break
        finally:
            prof_stack.close()
            # the loop's async saves are complete before train() returns
            # (callers resume or read checkpoints right after)
            self.wait_for_saves()
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        return history
