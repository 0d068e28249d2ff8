"""The generate CLI reads a training run's checkpoint directory
(``--ckpt-dir DIR [--step N]``, as the reference's CLI does) as well as
one export file (``--ckpt FILE``): all three give the same wav."""

import pytest
import torch

from ae_wavenet_tpu_torch.cli import generate as tgen
from ae_wavenet_tpu_torch.cli import train as ttrain
from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
from ae_wavenet_tpu_torch.training import checkpoint as ckpt_mod


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny width gains nothing from more, and the
    suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory, one_thread):
    """The tiny preset (VQ) trained 4 steps by the train CLI, saving at
    steps 2 and 4, on the reference's v2 fixture."""
    tmp = tmp_path_factory.mktemp("gen_ckpt")
    data, ckpt = str(tmp / "synth"), str(tmp / "ckpt")
    make_synthetic_dataset(data, n_clips=3, n_speakers=2, clip_len=(9000, 11000), seed=0)
    assert ttrain.main(["new", "--preset", "tiny", "--bottleneck", "vq", "--vq-k", "32",
                        "--data", data, "--ckpt-dir", ckpt, "--device", "cpu",
                        "--n-steps", "4", "--ckpt-every", "2"]) == 0
    assert ckpt_mod.complete_steps(ckpt) == {2, 4}
    return tmp, data, ckpt


def _wav(run, capsys, name, *source):
    """-> (the wav's bytes, the step the CLI says it loaded)."""
    tmp, data, _ = run
    out = str(tmp / f"{name}.wav")
    capsys.readouterr()
    assert tgen.main([*source, "--data", data, "--clip", "1", "--n-samples", "400",
                      "--seed", "3", "--device", "cpu", "--out", out]) == 0
    loaded = capsys.readouterr().out.splitlines()[0]
    with open(out, "rb") as f:
        return f.read(), loaded.split()[2]


@pytest.mark.parametrize("step", [2, 4])
def test_dir_step_and_file_give_the_same_wav(run, capsys, step):
    """LATEST (step 4) or ``--step``, and the export file of that step: the
    same step loaded and the same bytes at one seed."""
    ckpt = run[2]
    by_file = _wav(run, capsys, f"file{step}", "--ckpt",
                   ckpt_mod.checkpoint_path(ckpt, step))
    assert by_file[1] == str(step)
    assert _wav(run, capsys, f"dir{step}", "--ckpt-dir", ckpt, "--step",
                str(step)) == by_file
    if step == 4:
        assert _wav(run, capsys, "latest", "--ckpt-dir", ckpt) == by_file


@pytest.mark.parametrize("argv", [
    [],                                           # neither source
    ["--ckpt-dir", "D", "--ckpt", "F.pt"],        # both
    ["--ckpt", "F.pt", "--step", "2"],            # --step without --ckpt-dir
], ids=["none", "both", "step_without_dir"])
def test_exactly_one_source(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tgen.main([*argv, "--data", "P", "--device", "cpu", "--out", "o.wav"])
    assert e.value.code == 2 and "usage" in capsys.readouterr().err


def test_missing_step_raises(run, capsys):
    with pytest.raises(FileNotFoundError):
        _wav(run, capsys, "gone", "--ckpt-dir", run[2], "--step", "3")
