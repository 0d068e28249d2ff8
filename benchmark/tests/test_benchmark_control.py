"""The control: the precision below the configuration's bf16 (the reference
in fp8 for training, the program's int8 sampler for serving) reads far
above the program's sound readings.  At tiny widths on the CPU it reads
several times the program's largest; at the cells' own sizes on the card
(``cuda``) it fails the cells' limits, which the program's readings pass."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests import tiny

SEEDS = (31, 32, 2**31 + 33)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _readings(run, device, n_requests=2):
    if run.traffic["loop"] == "train":
        return dict(calibrate.train_seed(run, device, True, False))
    return dict(calibrate.serve_seed(run, device, n_requests, True))


@pytest.mark.parametrize("cell,key,ratio", [(tiny.TRAIN, "grad_diff", 2.0),
                                            (tiny.SERVE, "widest_gap", 2.0)])
def test_control_reads_far_above_the_program_at_tiny_widths(tmp_path, cell, key, ratio):
    root = tiny.make_root(tmp_path)
    sound, control = [], []
    for seed in SEEDS:
        _, run = tiny.open_run(root, cell, seed=seed)
        r = _readings(run, torch.device("cpu"))
        sound.append(r["program"][key])
        control.append(next(v for k, v in r.items() if k.startswith("control"))[key])
    assert min(control) > ratio * max(sound), (sound, control)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["train.chorowski_vq.b4x48k", "serve.chorowski_vq.b1",
                                  "serve.mfcc_inverter.b64"])
def test_control_fails_the_cells_limits_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' sizes and kernels")
    man = harness.manifest()
    for seed in SEEDS:
        run = harness.open_run(man, cell, seed, 0.0, False)
        r = _readings(run, torch.device("cuda"))
        assert all(r["program"][k] <= v for k, v in run.limits.items()), r
        ctl = next(v for k, v in r.items() if k.startswith("control"))
        assert any(ctl[k] > v for k, v in run.limits.items()), r
