"""The program's spans (``utils/profiling.span``) and counters on the CPU.

A span marks ``awt.<name>`` on the profiler's clock while a profiler
records and is one shared no-op otherwise.  Under ``torch.profiler`` a
tiny ``reconstruct`` and a tiny ``Chassis.train`` hold the spans the
benchmark's readers and the trace's idle-gap labels read, nested as the
program nests them; the same intervals land in ``profiling.SPANS``.  Prime
runs one pass and captures nothing; on the CPU the training step runs its
eager loop, so no capture span appears.  Two gloo ranks hold ``awt.mesh.all_reduce`` inside the
eager step, one span a call, and the all-reduce counts the flattened
buffer's bytes.  Tiny widths, one torch thread, a few seconds.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parallel_worker as worker
from ae_wavenet_tpu_torch.data.dataset import make_synthetic_dataset
from ae_wavenet_tpu_torch.models import autoencoder as tae
from ae_wavenet_tpu_torch.ops import fastgen
from ae_wavenet_tpu_torch.training import chassis as tch
from ae_wavenet_tpu_torch.utils import config as tcfg
from ae_wavenet_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(k_steps: int = 2):
    cfg = tcfg.tiny_config()
    return dataclasses.replace(
        cfg, bottleneck=tcfg.BottleneckConfig(kind="vq", n_dim=16, vq_k=16),
        train=dataclasses.replace(cfg.train, batch_sz=2, steps_per_call=k_steps))


def _spans(events) -> list:
    """(name without ``awt.``, start ns, end ns) of the ``awt.*`` events,
    outer before inner."""
    got = [(n[len("awt."):], a, b) for n, a, b in events if n.startswith("awt.")]
    return sorted(got, key=lambda s: (s[1], -s[2]))


def _profiled(fn) -> list:
    """fn() under torch.profiler -> :func:`_spans` of its host events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events())


def _parent(spans: list, i: int):
    """The innermost span that holds span ``i`` (None at the top)."""
    _, a, b = spans[i]
    outer = [(sb - sa, n) for j, (n, sa, sb) in enumerate(spans)
             if j != i and sa <= a and b <= sb]
    return min(outer)[1] if outer else None


def _parents(spans: list) -> dict:
    """{name: {parent names}} over every occurrence."""
    out: dict = {}
    for i, (n, _, _) in enumerate(spans):
        out.setdefault(n, set()).add(_parent(spans, i))
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("spans") / "synth")
    make_synthetic_dataset(prefix, n_clips=8, n_speakers=4, clip_len=(9000, 14000), seed=0)
    return prefix


@pytest.fixture(scope="module")
def served():
    cfg = _cfg()
    model = tae.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    wav = torch.from_numpy((3000 * rng.normal(size=(2, 8000))).astype(np.int16))
    spk = torch.tensor([1, 3])
    timings: dict = {}
    before = (fastgen.prime.passes, fastgen.prime.positions)
    profiling.SPANS.clear()
    spans = _profiled(lambda: tae.reconstruct(model, cfg, wav, spk,
                                              torch.Generator().manual_seed(1), 1.0,
                                              12, timings))
    return {"spans": spans, "timings": timings, "recorded": list(profiling.SPANS),
            "passes": fastgen.prime.passes - before[0],
            "positions": fastgen.prime.positions - before[1], "rf": sum(cfg.wavenet.dilations)}


@pytest.fixture(scope="module")
def trained(data):
    ch = tch.Chassis(_cfg(), data, device="cpu", log_stream=io.StringIO())
    profiling.SPANS.clear()
    spans = _profiled(lambda: ch.train(4))
    return {"spans": spans, "recorded": list(profiling.SPANS)}


@pytest.mark.parametrize("name,parent", [
    ("serve.encode", None), ("serve.prime", None), ("serve.generate", None),
    ("prime.pack", "serve.prime"), ("prime.pass", "serve.prime"),
    ("sampler.pack", "serve.generate"), ("sampler.launch", "serve.generate"),
])
def test_reconstruct_holds_its_spans_nested(served, name, parent):
    assert _parents(served["spans"])[name] == {parent}


def test_reconstruct_on_the_cpu_primes_eagerly_without_a_capture_span(served):
    names = [n for n, _, _ in served["spans"]]
    assert "prime.capture" not in names and names.count("prime.pass") == 1
    # one pass over the rf consumed context samples of each of the 2 rows
    assert (served["passes"], served["positions"]) == (1, 2 * served["rf"])
    assert set(served["timings"]) == {"encode", "prime", "generate"}


def test_the_f32_rollout_opens_no_span():
    """Prime marks its pass; the f32 rollout, which no benchmark cell
    runs, marks none."""
    cfg = _cfg()
    wn = tae.init(cfg, torch.Generator().manual_seed(0), "cpu").wavenet
    cond = 0.3 * torch.randn(2, cfg.wavenet.n_lc_out, 6,
                             generator=torch.Generator().manual_seed(2))
    before = fastgen.generate.eager_steps
    spans = _profiled(lambda: fastgen.generate(
        wn, cfg.wavenet, fastgen.init_state(cfg.wavenet, 2), cond,
        torch.Generator().manual_seed(1), gc_ids=torch.tensor([1, 3])))
    assert spans == [] and fastgen.generate.eager_steps - before == 6


@pytest.mark.parametrize("name,parent", [
    ("loader.wait", None), ("train.call", None), ("train.fetch", None),
    ("train.load", "train.call"), ("train.eager", "train.call"),
    ("step.forward", "train.eager"), ("step.backward", "train.eager"),
    ("step.update", "train.eager"),
])
def test_train_holds_its_spans_nested(trained, name, parent):
    assert _parents(trained["spans"])[name] == {parent}


def test_train_counts_one_call_span_a_block_and_its_steps(trained):
    names = [n for n, _, _ in trained["spans"]]
    assert names.count("train.call") == 2 and names.count("train.load") == 2
    assert names.count("step.forward") == names.count("step.update") == 4
    assert names.count("train.fetch") == 1
    assert "train.capture" not in names and "train.replay" not in names


@pytest.mark.parametrize("case", ["served", "trained"])
def test_spans_land_in_the_record_on_the_profilers_clock(request, case):
    """``profiling.SPANS`` holds each span once, its interval inside the
    profiler's own (``time.time_ns`` taken inside the RecordFunction)."""
    got = request.getfixturevalue(case)
    events, recorded = got["spans"], _spans(("awt." + n, a, b) for n, a, b in got["recorded"])
    assert [n for n, _, _ in events] == [n for n, _, _ in recorded]
    for (_, a, b), (_, ra, rb) in zip(events, recorded):
        assert a <= ra <= rb <= b
        assert (ra - a) + (b - rb) < 5e6  # ns


def test_span_is_one_shared_no_op_unless_a_profiler_records():
    assert profiling.span("a") is profiling.span("b") is profiling._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("a", on=False) is profiling._OFF
        on = profiling.span("a")
        assert on is not profiling._OFF and on is not profiling.span("a")
    assert profiling.span("a") is profiling._OFF


def test_train_without_a_profiler_opens_no_record_function(data, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a RecordFunction was opened with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    ch = tch.Chassis(_cfg(), data, device="cpu", log_stream=io.StringIO())
    n = len(profiling.SPANS)
    hist = ch.train(4)
    assert np.isfinite(hist[-1]["loss"]) and len(profiling.SPANS) == n


@pytest.fixture(scope="module")
def ranks(data):
    return worker.run_ranks(worker.span_ranks, 2, 2, data)


def test_mesh_counts_calls_and_the_flattened_bytes(ranks):
    for r in ranks:
        c = r["counted"]
        assert c["calls"] == 1 and c["bytes"] == c["want_bytes"] == (15 + 7 + 8) * 4


def test_mesh_all_reduce_is_a_span_inside_the_eager_step(ranks):
    for r in ranks:
        spans = _spans(r["events"])
        parents = _parents(spans)
        # the gradients' and the metrics' means in the backward; the VQ
        # statistics' sum in the forward
        assert parents["mesh.all_reduce"] == {"step.backward", "step.forward"}
        names = [n for n, _, _ in spans]
        assert names.count("mesh.all_reduce") == 2 * 3
