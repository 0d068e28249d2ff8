"""The host window gather (``data/native.py`` over ``csrc/window_gather.c``),
the sampler that uses it, and the train CLI's TensorBoard output.

The C gather must equal numpy slicing, the C mu-law encoder the port's
``mu_encode`` on every int16 value, and ``WindowSampler.batch_at`` the
JAX package's, bit for bit.
"""

import glob
import io
import json
import sys

import numpy as np
import pytest
import torch

from ae_wavenet_tpu.data import dataset as jds
from ae_wavenet_tpu_torch.audio.mulaw import int16_to_float, mu_encode
from ae_wavenet_tpu_torch.cli import train as ttrain
from ae_wavenet_tpu_torch.data import dataset as tds
from ae_wavenet_tpu_torch.data import native
from ae_wavenet_tpu_torch.data import preprocess as tpre
from ae_wavenet_tpu_torch.utils.logging import MetricsLogger


@pytest.fixture(scope="module")
def data_prefix(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("nat") / "synth")
    tpre.make_synthetic_dataset(prefix, n_clips=5, n_speakers=3,
                                clip_len=(6000, 12000), seed=2)
    return prefix


@pytest.mark.parametrize("n,w", [(0, 10), (1, 1), (7, 333), (16, 4000)])
def test_gather_equals_numpy_slicing(data_prefix, n, w):
    data = tds.PackedDataset(data_prefix).data  # a memmap
    offs = np.random.default_rng(n).integers(0, data.size - w + 1, n)
    got = native.gather_windows(data, offs, w)
    assert got.dtype == np.int16 and got.shape == (n, w)
    assert np.array_equal(got, native.gather_windows_numpy(data, offs, w))
    assert all(np.array_equal(got[i], data[o : o + w]) for i, o in enumerate(offs))


@pytest.mark.parametrize("fn", [native.gather_windows, native.gather_windows_numpy])
def test_gather_checks_bounds_and_types(fn):
    data = np.arange(100, dtype=np.int16)
    for offs in ([-1], [91], [0, 95]):
        with pytest.raises(IndexError, match="out of bounds"):
            fn(data, np.array(offs), 10)
    assert np.array_equal(fn(data, np.array([90]), 10)[0], data[90:])
    with pytest.raises(TypeError, match="int16"):
        fn(data.astype(np.int32), np.array([0]), 10)


def test_mu_encode_host_equals_the_port_encoder():
    x = np.arange(-32768, 32768, dtype=np.int16)
    got = native.mu_encode_host(x)
    want = mu_encode(int16_to_float(torch.from_numpy(x)), 256).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No quiet numpy fallback: a compiler that fails makes the gather raise."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="window_gather.c failed"):
        native.gather_windows(np.zeros(10, np.int16), np.array([0]), 4)


@pytest.mark.parametrize("u_len,batch,subset", [(4000, 4, None), (11000, 3, [0, 2, 4]),
                                                 (257, 16, [1])])
def test_window_sampler_matches_jax(data_prefix, u_len, batch, subset, monkeypatch):
    """The same windows and speakers as the JAX sampler, bit for bit, through
    the C gather (its plain version is not called)."""
    calls = []
    monkeypatch.setattr(native, "gather_windows_numpy",
                        lambda *a: calls.append(a) or None)
    t = tds.WindowSampler(tds.PackedDataset(data_prefix), u_len, batch, 7,
                          clip_indices=subset)
    j = jds.WindowSampler(jds.PackedDataset(data_prefix), u_len, batch, 7,
                          clip_indices=subset)
    for step in (0, 1, 123456):
        (wt, st), (wj, sj) = t.batch_at(step), j.batch_at(step)
        assert wt.dtype == wj.dtype == np.int16
        assert np.array_equal(wt, wj) and np.array_equal(st, sj)
    assert not calls


def test_tb_logdir_writes_scalars(data_prefix, tmp_path, capsys):
    """``--tb-logdir``: an events file holding the metrics, recon_ce among
    them, beside the usual JSON records."""
    tb = tmp_path / "tb"
    assert ttrain.main(["new", "--preset", "tiny", "--n-steps", "2", "--log-every", "1",
                        "--data", data_prefix, "--device", "cpu",
                        "--tb-logdir", str(tb)]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"step"')]
    assert [r["step"] for r in recs] == [1, 2]
    files = glob.glob(str(tb / "events.out.tfevents.*"))
    assert len(files) == 1
    blob = open(files[0], "rb").read()
    assert b"recon_ce" in blob and b"grad_norm" in blob


def test_tb_logdir_without_the_package_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(RuntimeError, match="needs torch.utils.tensorboard"):
        MetricsLogger(io.StringIO(), tb_logdir=str(tmp_path))
    log = MetricsLogger(io.StringIO())  # without a logdir nothing is imported
    log.log(1, {"loss": 1.0})
    log.close()
