"""The port's checkpoints (``training/checkpoint.py``): async saves,
pointers, retention and the guarded merge.

Mirrors the JAX package's ``tests/test_async_ckpt.py`` case by case, in the
port's format: one export file ``step_XXXXXXXX.pt`` per step (config
inside), ``LATEST`` and ``BEST`` beside them.  Where that suite plants a
step directory without its config sidecar, this one plants a ``*.tmp``: an
interrupted write, which must never be loadable.
"""

import dataclasses
import functools
import io
import json
import os

import numpy as np
import pytest
import torch

from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset
from ae_wavenet_tpu_torch.models import autoencoder as tae
from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod
from ae_wavenet_tpu_torch.training import weights
from ae_wavenet_tpu_torch.training.chassis import Chassis
from ae_wavenet_tpu_torch.utils.config import tiny_config


def _state(v: float) -> dict:
    return {"params.w": torch.full((4, 3), v), "opt_state.0.0.count":
            torch.tensor(int(v), dtype=torch.int32)}


@pytest.fixture(scope="module")
def data_prefix(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("data") / "synth")
    make_synthetic_dataset(prefix, n_clips=4, n_speakers=2, clip_len=(4000, 6000))
    return prefix


def _cfg(**train):
    cfg = tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def _chassis(cfg, data_prefix, ckpt_dir, log=None):
    """A CPU chassis whose in-loop evals take 2 batches (8 cost the suite
    minutes and show nothing more here)."""
    ch = Chassis(cfg, data_prefix, ckpt_dir=ckpt_dir, device="cpu",
                 log_stream=io.StringIO() if log is None else log)
    ch.evaluate = functools.partial(ch.evaluate, n_batches=2)
    return ch


def test_saver_async_roundtrip(tmp_path):
    cfg = tiny_config()
    saver = ckpt_mod.Saver()
    d = str(tmp_path / "ck")
    saver.save(d, 10, _state(1.0), cfg, blocking=False)
    # a second save finishes the first before it starts
    saver.save(d, 20, _state(2.0), cfg, blocking=False)
    saver.close()  # waits

    assert ckpt_mod.latest_step(d) == 20
    step, named, cfg2 = ckpt_mod.load(d)
    assert step == 20
    assert torch.equal(named["params.w"], torch.full((4, 3), 2.0))
    assert named["opt_state.0.0.count"].dtype == torch.int32
    assert cfg2.train.n_win == cfg.train.n_win
    assert ckpt_mod.load_config(d) == (20, cfg2)
    # the earlier save is intact too
    step, named, _ = ckpt_mod.load(d, 10)
    assert step == 10 and float(named["params.w"][0, 0]) == 1.0
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000010.pt", "step_00000020.pt"]


def test_saver_snapshot_is_the_callers_and_errors_surface(tmp_path):
    """The write runs in the background from the snapshot it was given, and
    its error is raised by wait(), not lost."""
    cfg = tiny_config()
    model = tae.init(cfg, torch.Generator().manual_seed(0), "cpu")
    state = weights.export_state(model)
    name, before = next(iter(state.items()))
    before = before.clone()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)  # a later step must not reach the snapshot
    assert torch.equal(state[name], before)
    d = str(tmp_path / "ck")
    saver = ckpt_mod.Saver()
    saver.save(d, 1, state, cfg, blocking=True)
    assert torch.equal(ckpt_mod.load(d)[1][name], before)
    saver.save(d, 2, {"params.w": lambda: 0}, cfg)  # cannot be pickled
    with pytest.raises(Exception):
        saver.wait()
    assert ckpt_mod.complete_steps(d) == {1} and ckpt_mod.latest_step(d) == 1
    saver.wait()  # the error was handed over once


def test_interrupted_tmp_is_never_loadable(tmp_path):
    """A crash mid-write leaves ``step_*.pt.tmp``: resume picks the previous
    complete step, and retention leaves the write in flight alone."""
    cfg = tiny_config()
    d = str(tmp_path / "ck")
    ckpt_mod.save(d, 10, _state(1.0), cfg)
    with open(ckpt_mod.checkpoint_path(d, 20) + ".tmp", "wb") as f:
        f.write(b"half a file")
    assert ckpt_mod.complete_steps(d) == {10}
    assert ckpt_mod.latest_step(d) == 10
    assert ckpt_mod.load(d)[0] == 10
    assert ckpt_mod.prune(d, keep_last=1) == []
    assert os.path.exists(ckpt_mod.checkpoint_path(d, 20) + ".tmp")


def test_latest_pointer_wins_over_newer_file(tmp_path):
    """Rollback-resume: after a resume from an older step (its save repoints
    LATEST), a later abandoned checkpoint must not be picked."""
    cfg = tiny_config()
    d = str(tmp_path / "ck")
    ckpt_mod.save(d, 100, _state(1.0), cfg)   # the abandoned run
    ckpt_mod.save(d, 60, _state(2.0), cfg)    # the rollback save repoints LATEST
    assert ckpt_mod.latest_step(d) == 60
    assert ckpt_mod.load(d)[0] == 60
    # a stale pointer (it names a deleted step) falls back to the newest file
    os.remove(ckpt_mod.checkpoint_path(d, 60))
    assert ckpt_mod.latest_step(d) == 100
    # and a missing or unreadable pointer too
    os.remove(os.path.join(d, "LATEST"))
    assert ckpt_mod.latest_step(d) == 100
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("not a step")
    assert ckpt_mod.latest_step(d) == 100


def test_latest_pointer_to_nothing_loadable_returns_none(tmp_path):
    cfg = tiny_config()
    d = str(tmp_path / "ck")
    ckpt_mod.save(d, 100, _state(1.0), cfg)
    os.remove(ckpt_mod.checkpoint_path(d, 100))
    assert ckpt_mod.latest_step(d) is None
    assert ckpt_mod.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt_mod.load(d)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt_mod.load_config(d)


def test_prune_keep_last_and_protect(tmp_path):
    """Retention keeps the newest N, the protected best and LATEST's step."""
    cfg = tiny_config()
    d = str(tmp_path / "ck")
    saver = ckpt_mod.Saver()
    for s in (10, 20, 30):
        saver.save(d, s, _state(float(s)), cfg, blocking=True)
    # step 10 is the best checkpoint; keep_last = 2 through the next save
    saver.save(d, 40, _state(4.0), cfg, blocking=True, keep_last=2, best=(10, 3.14))
    saver.close()
    assert ckpt_mod.complete_steps(d) == {10, 30, 40}  # 20 pruned, 10 protected
    assert ckpt_mod.best_info(d) == (10, 3.14)
    assert ckpt_mod.latest_step(d) == 40
    # a BEST that names a removed step reads as None, not as a stale pointer
    os.remove(ckpt_mod.checkpoint_path(d, 10))
    assert ckpt_mod.best_info(d) is None
    assert ckpt_mod.best_info(str(tmp_path / "absent")) is None


def test_prune_never_removes_latest_pointer_target(tmp_path):
    cfg = tiny_config()
    d = str(tmp_path / "ck")
    for s in (10, 20, 30):
        ckpt_mod.save(d, s, _state(float(s)), cfg)
    ckpt_mod.save(d, 15, _state(1.5), cfg)   # rollback: LATEST -> 15
    pruned = ckpt_mod.prune(d, keep_last=1)
    assert pruned == [10, 20]
    assert ckpt_mod.latest_step(d) == 15
    assert ckpt_mod.prune(d, keep_last=0) == []  # 0 keeps every checkpoint


def test_guarded_merge_messages():
    """The reference's two messages (``checkpoint.merge_into``): another
    number of tensors, another shape."""
    cfg = tiny_config()
    model = tae.init(cfg, torch.Generator().manual_seed(0), "cpu")
    named = weights.export_state(model)
    weights.load_into(model, named)  # itself: fine
    fewer = dict(list(named.items())[1:])
    with pytest.raises(ValueError, match=r"tree has \d+ leaves but the current "
                                         r"config builds \d+.*architecture changed"):
        weights.load_into(model, fewer)
    name = next(k for k, v in named.items() if v.ndim == 2)
    bad = {**named, name: named[name].t().contiguous()[:, :1]}
    with pytest.raises(ValueError, match="leaf shape .* != model's .* architecture "
                                         "drift since the save"):
        weights.load_into(model, bad)


def test_resume_refuses_a_checkpoint_of_another_architecture(data_prefix, tmp_path):
    """aux_frame_weight flipped since the save: the aux head is missing."""
    d = str(tmp_path / "ck")
    ch = Chassis(_cfg(aux_frame_weight=1.0), data_prefix, ckpt_dir=d, device="cpu",
                 log_stream=io.StringIO())
    ch.train(1)
    ch.save()
    other = Chassis(_cfg(aux_frame_weight=0.0), data_prefix, ckpt_dir=d, device="cpu",
                    log_stream=io.StringIO())
    with pytest.raises(ValueError, match="leaves"):
        other.resume()


def test_chassis_async_periodic_saves_resume(data_prefix, tmp_path):
    """ckpt_every below n_steps: the periodic saves go through the async
    path, are complete when train() returns, and the run resumes to the same
    weights and optimizer state."""
    cfg = _cfg(ckpt_every=2, log_every=2)
    d = str(tmp_path / "ck")
    ch = Chassis(cfg, data_prefix, ckpt_dir=d, device="cpu", log_stream=io.StringIO())
    ch.train(6)
    assert ckpt_mod.latest_step(d) == 6
    assert ckpt_mod.complete_steps(d) == {2, 4, 6}
    ch2 = Chassis(cfg, data_prefix, ckpt_dir=d, device="cpu", log_stream=io.StringIO())
    assert ch2.resume() == 6
    for (k, a), (_, b) in zip(ch.model.state_dict().items(),
                              ch2.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert ch2.opt.count == ch.opt.count == 6
    for k in ch.opt.mu:
        assert torch.equal(ch.opt.mu[k], ch2.opt.mu[k])


def test_chassis_retention_e2e(data_prefix, tmp_path):
    """ckpt_keep: a run leaves keep + best checkpoints, BEST names the step
    that was evaluated, survives a resume, and a resume after pruning goes
    on from the newest file."""
    cfg = _cfg(ckpt_every=2, log_every=2, ckpt_keep=1, holdout_every=2)
    d = str(tmp_path / "ck")
    log = io.StringIO()
    ch = _chassis(cfg, data_prefix, d, log)
    ch.train(8, eval_every=2)
    ch.close()
    steps = ckpt_mod.complete_steps(d)
    best = ckpt_mod.best_info(d)
    assert best is not None and best == ch.best_ckpt
    assert steps == {8, best[0]}
    # the metric is the eval logged at that very step
    evals = {r["step"]: r["eval_recon_ce"] for r in
             (json.loads(ln) for ln in log.getvalue().splitlines())
             if "eval_recon_ce" in r}
    assert best[1] == evals[best[0]] == min(evals.values())
    ch2 = _chassis(cfg, data_prefix, d)
    assert ch2.resume() == 8 and ch2.best_ckpt == best
    ch2.train(4, eval_every=2)
    ch2.close()
    after = ckpt_mod.best_info(d)
    assert after is not None and after[1] <= best[1]
    assert ckpt_mod.complete_steps(d) == {12, after[0]}


def test_eval_between_saves_is_attributed_to_no_checkpoint(data_prefix, tmp_path):
    """An eval at a step that is not saved names no checkpoint: BEST is
    only ever labelled with a step whose weights were the ones evaluated."""
    cfg = _cfg(ckpt_every=2, log_every=3, ckpt_keep=2)
    d = str(tmp_path / "ck")
    ch = _chassis(cfg, data_prefix, d)
    ch.train(3, eval_every=3)  # a save at 2, an eval at 3
    assert ch.best_ckpt is None and ckpt_mod.best_info(d) is None
    ch.save()                  # step 3: the step the eval measured
    assert ch.best_ckpt is not None and ch.best_ckpt[0] == 3
    assert ckpt_mod.best_info(d) == ch.best_ckpt
    assert np.isfinite(ch.best_ckpt[1])
