"""K steps a call (``TrainConfig.steps_per_call``) in the port's chassis:
the counterpart of ``tests/test_steps_per_call.py``.

``training/chassis.train_step`` runs a K-step call as K single steps over a
block of K staged batches, each with its own step's draws, so the contract
is exact: K steps a call leave the parameters, the optimizer state, the
bottleneck state and the log points' metrics bit for bit those of K calls
of one step.  ``probe_dispatch`` reads the e2e rate at three values of K on
the strength of it."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from ae_wavenet_tpu_torch.data.dataset import PackedDataset, WindowSampler
from ae_wavenet_tpu_torch.data.loader import device_batches
from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
from ae_wavenet_tpu_torch.training.chassis import Chassis
from ae_wavenet_tpu_torch.utils.config import BottleneckConfig, tiny_config


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_prefix(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("data") / "synth")
    make_synthetic_dataset(prefix, n_clips=6, n_speakers=3, seed=1)
    return prefix


def _cfg(k: int, bottleneck: str = "ae"):
    """The tiny config, K steps a call, a log point every 4 steps; the VQ
    variant with jitter, restarts and the aux head (every per-step draw)."""
    cfg = tiny_config()
    if bottleneck == "vq":
        cfg = dataclasses.replace(
            cfg, bottleneck=BottleneckConfig(kind="vq", n_dim=16, vq_k=32,
                                             vq_restart_thresh=0.5))
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, n_steps=8, log_every=4, steps_per_call=k,
        aux_frame_weight=1.0 if bottleneck == "vq" else 0.0))


def _state(ch: Chassis) -> dict:
    return {**{f"model.{k}": v for k, v in ch.model.state_dict().items()},
            **ch.opt.named_state()}


def test_block_loader_stacks_consecutive_batches(data_prefix):
    ds = PackedDataset(data_prefix)
    s = WindowSampler(ds, u_len=3000, batch_sz=2, seed=5)
    singles = [s.batch_at(i) for i in range(4)]
    got = list(device_batches(s, 0, 4, "cpu", block=2))
    assert [g[0] for g in got] == [0, 2]
    for (first, (wavs, spks)), lo in zip(got, [0, 2]):
        assert wavs.shape == (2, 2, 3000) and spks.shape == (2, 2)
        for i in range(2):
            np.testing.assert_array_equal(wavs[i].numpy(), singles[lo + i][0])
            np.testing.assert_array_equal(spks[i].numpy(), singles[lo + i][1])


def test_block_loader_rejects_ragged(data_prefix):
    ds = PackedDataset(data_prefix)
    s = WindowSampler(ds, u_len=3000, batch_sz=2, seed=5)
    with pytest.raises(ValueError, match="multiple of block"):
        list(device_batches(s, 0, 5, "cpu", block=2))


@pytest.mark.parametrize("bottleneck", ["ae", "vq"])
@pytest.mark.parametrize("k", [2, 4])
def test_k_step_chassis_matches_single_step_bit_for_bit(data_prefix, k, bottleneck):
    """K steps a call against one: the log points land on the same steps
    and carry the same metrics; parameters, optimizer state and bottleneck
    state end equal, bit for bit."""
    a = Chassis(_cfg(1, bottleneck), data_prefix, device="cpu", log_stream=io.StringIO())
    hist_a = a.train(8)
    b = Chassis(_cfg(k, bottleneck), data_prefix, device="cpu", log_stream=io.StringIO())
    hist_b = b.train(8)
    assert [h["step"] for h in hist_a] == [h["step"] for h in hist_b] == [4, 8]
    for ha, hb in zip(hist_a, hist_b):
        assert {m: v for m, v in ha.items() if m != "samples_per_sec"} == \
            {m: v for m, v in hb.items() if m != "samples_per_sec"}
    sa, sb = _state(a), _state(b)
    assert list(sa) == list(sb)
    for name in sa:
        assert torch.equal(torch.as_tensor(sa[name]), torch.as_tensor(sb[name])), name
    assert a.step == b.step == 8


def test_k_step_checkpoint_cadence(data_prefix, tmp_path):
    """ckpt_every=4 with K=2 saves at steps 4 and 8; a resume continues at 8."""
    cfg = _cfg(2)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ckpt_every=4))
    ck = str(tmp_path / "ck")
    ch = Chassis(cfg, data_prefix, ckpt_dir=ck, device="cpu", log_stream=io.StringIO())
    ch.train(8)
    ch.close()
    ch2 = Chassis(cfg, data_prefix, ckpt_dir=ck, device="cpu", log_stream=io.StringIO())
    assert ch2.resume() == 8


@pytest.mark.parametrize("k,n", [(4, 6), (2, 3)])
def test_rejects_nondivisible_n_steps(data_prefix, k, n):
    ch = Chassis(_cfg(k), data_prefix, device="cpu", log_stream=io.StringIO())
    with pytest.raises(ValueError, match="multiple of"):
        ch.train(n)
    assert ch.step == 0
