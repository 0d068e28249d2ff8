"""``utils/profiling.py`` and ``--profile-steps`` on the CPU: the trace
file, the summary's keys, the log record.  Device shares come only from a
run on the card (``chip_smoke.py``)."""

import json
import os

import pytest
import torch

from ae_wavenet_tpu_torch.cli import train as ttrain
from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset
from ae_wavenet_tpu_torch.utils import profiling

KEYS = {"trace_file", "window_ms", "device_busy_ms", "device_busy_share",
        "n_kernels", "top_kernels"}


def test_trace_writes_a_chrome_trace_and_a_summary(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as summary:
        assert summary == {}  # filled when the body has ended
        a = torch.randn(64, 64)
        (a @ a).sum().item()
    assert set(summary) == KEYS
    assert summary["trace_file"] == str(tmp_path / "prof" / profiling.TRACE_FILE)
    with open(summary["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert summary["window_ms"] > 0
    # no device in this trace: no share is claimed
    assert summary["device_busy_share"] is None and summary["top_kernels"] == []
    assert summary["n_kernels"] == 0 and summary["device_busy_ms"] == 0


@pytest.mark.parametrize("spans,want", [
    ([], 0.0), ([(0, 4)], 4.0), ([(0, 4), (2, 6), (10, 11)], 7.0),
    ([(5, 6), (0, 10)], 10.0)])
def test_device_busy_time_is_the_union_of_the_intervals(spans, want):
    assert profiling._union_us(spans) == want


def test_step_timer_counts_ticks():
    t = profiling.StepTimer()
    t.tick()
    t.tick(3)
    assert t._steps == 4 and t.rate() > 0 and t.rate(fence=True) > 0
    t.reset()
    assert t.rate() == 0


def test_train_cli_profile_steps_logs_the_trace(tmp_path, capsys):
    prefix = str(tmp_path / "synth")
    make_synthetic_dataset(prefix, n_clips=4, n_speakers=2, clip_len=(9000, 12000))
    prof = str(tmp_path / "prof")
    with pytest.raises(SystemExit, match="--profile-dir"):
        ttrain.setup(["new", "--preset", "tiny", "--data", prefix, "--device", "cpu",
                      "--profile-steps", "2"])
    assert ttrain.main(["new", "--preset", "tiny", "--data", prefix, "--device", "cpu",
                        "--n-steps", "3", "--log-every", "1", "--profile-steps", "2",
                        "--profile-dir", prof]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"')]
    traced = [r for r in recs if "profile_trace" in r]
    assert len(traced) == 1 and traced[0]["step"] == 2
    assert traced[0]["profile_trace"] == prof and traced[0]["profile_window_ms"] > 0
    summary = [r["profile"] for r in recs if "profile" in r]
    assert len(summary) == 1 and set(summary[0]) == KEYS
    assert os.path.exists(os.path.join(prof, profiling.TRACE_FILE))
    assert [r["step"] for r in recs if "recon_ce" in r] == [1, 2, 3]
