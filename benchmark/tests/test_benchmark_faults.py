"""The whole of a run, past the look for a card, with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have
(and true for the same run unbroken).  Tiny widths on the CPU, the cells'
own limits."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests import tiny


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, cell, seed=21):
    root = tiny.make_root(tmp_path)
    man, run = tiny.open_run(root, cell, seed=seed)
    return harness.execute(man, run, root)


def _state_unchanged(monkeypatch):
    from ae_wavenet_tpu_torch.training import chassis

    def update(self, grads, bc, lr):
        gs = [g for g in grads.values() if g is not None]
        return torch.linalg.vector_norm(torch.stack([g.norm() for g in gs]))

    monkeypatch.setattr(chassis.Adam, "update", update)


def _planted(monkeypatch, plant, owner, attr: str):
    """Plant one of ``benchmark/calibrate``'s faults for the test only."""
    undo = plant()
    broken = getattr(owner, attr)
    undo()
    monkeypatch.setattr(owner, attr, broken)


def _half_batch(monkeypatch):
    from ae_wavenet_tpu_torch.models import autoencoder

    _planted(monkeypatch, calibrate.half_batch, autoencoder, "loss_fn")


def _ema_unchanged(monkeypatch):
    from ae_wavenet_tpu_torch.models import bottlenecks

    _planted(monkeypatch, calibrate.ema_unchanged, bottlenecks.VQBottleneck, "train_apply")


def _codebook_unchanged(monkeypatch):
    from ae_wavenet_tpu_torch.models import bottlenecks

    _planted(monkeypatch, calibrate.codebook_unchanged, bottlenecks.VQBottleneck,
             "train_apply")


def _altered(monkeypatch, sampled_only: bool):
    from ae_wavenet_tpu_torch.ops import fastgen_cuda

    real = fastgen_cuda.generate_fused

    def generate_fused(*a, **kw):
        out = real(*a, **kw)
        temperature = kw.get("temperature", a[7] if len(a) > 7 else 1.0)
        if temperature > 0.0 or not sampled_only:
            ids = out[0]
            ids[:, ids.shape[1] // 2] = (ids[:, ids.shape[1] // 2] + 128) % 256
        return out

    monkeypatch.setattr(fastgen_cuda, "generate_fused", generate_fused)


def _token_altered(monkeypatch):
    _altered(monkeypatch, False)


def _sampled_token_altered(monkeypatch):
    """Only the requests sampled at a temperature above 0."""
    _altered(monkeypatch, True)


@pytest.mark.parametrize("cell,fault", [
    (tiny.TRAIN, None), (tiny.TRAIN, _state_unchanged), (tiny.TRAIN, _half_batch),
    (tiny.TRAIN, _ema_unchanged), (tiny.TRAIN, _codebook_unchanged),
    (tiny.SERVE, None), (tiny.SERVE, _token_altered), (tiny.SERVE, _sampled_token_altered),
    (tiny.VOCODE, None), (tiny.VOCODE, _token_altered),
    (tiny.VOCODE, _sampled_token_altered)])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    if fault is not None:
        fault(monkeypatch)
    res = _run(tmp_path, cell)
    assert res["correct"] is (fault is None), res["checks"]
