"""The flow vocoder's serving cell and the mixture vocoder's training cell,
at tiny widths on the CPU (``flow_cells.py``): ``correct`` for the program,
not for the planted faults of ``calibrate_flow.py`` and
``calibrate_vocoder.py``; the traced flow run reads its layers where the
CPU has them; the WaveGlow reference against the program's forward."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import calibrate_flow, calibrate_vocoder, harness
from benchmark.tests import flow_cells, tiny


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAULTS = {**calibrate_flow.FLOW_FAULTS, "fault_half_batch": calibrate_vocoder.half_batch,
          "fault_step_left_out": calibrate_vocoder.step_left_out}


def _run(tmp_path, cell, fault=None, trace=False):
    root = tiny.make_root(tmp_path)
    man, run = tiny.open_run(root, cell, seed=2**31 + 13, trace=trace)
    if fault is None:
        return run, harness.execute(man, run, root)
    with FAULTS[fault]():
        return run, harness.execute(man, run, root)


@pytest.mark.parametrize("cell,fault", [
    (flow_cells.FLOW, None), (flow_cells.FLOW, "fault_tap_dropped"),
    (flow_cells.FLOW, "fault_inverse_is_w"),
    (flow_cells.FLOW, "fault_early_zeroed"), (flow_cells.FLOW, "fault_cond_from_neighbour"),
    (flow_cells.MOL_TRAIN, None), (flow_cells.MOL_TRAIN, "fault_half_batch"),
    (flow_cells.MOL_TRAIN, "fault_step_left_out")])
def test_the_new_cells_hold_the_program_and_refuse_its_faults(tmp_path, cell, fault):
    run, res = _run(tmp_path, cell, fault)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["correct"] is (fault is None), res["checks"]
    want = ({"wave_gap", "peak_gap"} if cell == flow_cells.FLOW
            else {"grad_gap", "grad_diff", "change_gap"})
    assert set(res["checks"]) == want


def test_the_traced_flow_cell_reads_its_layers(tmp_path):
    """On the CPU no kernel runs: the readers of device time find nothing
    and leave their metrics out; the counts are there for the card's."""
    run, res = _run(tmp_path, flow_cells.FLOW, trace=True)
    assert res["correct"] is True, res["checks"]
    assert {"layer_ops", "layer_bytes", "request_flops"} <= set(run.counts)
    assert "gated_roofline_pct.flow" not in res["metrics"]
    assert "flow_glue_ms.flow" not in res["metrics"]
    names = {n for n, _, _ in run.trace.program}
    assert {"flow.upsample", "flow.cond", "flow.wn", "flow.coupling"} <= names


def test_the_manifest_names_the_new_cells():
    man = harness.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    assert cells["serve.waveglow_22k.b16"]["config"] == "waveglow_22k"
    assert cells["train.wavenet_mol_24k.b4x24k"]["traffic"] == "train_b4x24k"
    for m in man["per_layer"]:
        if m["name"] in ("gated_roofline_pct.flow", "flow_glue_ms.flow"):
            assert m["workloads"] == ["serve.waveglow_22k.b16"]
    conf = json.loads((harness.ROOT / "benchmark/configs/waveglow_22k.json").read_text())
    assert conf["reduced"] == [] and conf["flow"]["sigma"] == 0.6


def test_the_reference_inverts_its_own_forward_and_the_program_agrees():
    """The reference's forward of its own inverse gives back the noise, and
    so does the program's float32 forward (``waveglow.forward``) of the
    reference's audio, on the tiny widths' seeded weights."""
    from ae_wavenet_tpu_torch.models import waveglow
    from ae_wavenet_tpu_torch.utils import config as prog_config

    from benchmark import weights, weights_waveglow
    from benchmark.reference import waveglow as ref_glow

    doc = json.dumps(flow_cells.flow_config())
    cfg = prog_config.from_json(doc)
    model = waveglow.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    w = weights_waveglow.make(model, 5, "cpu")
    weights.load(model, w)
    g = ref_glow.from_json(doc)
    ref = ref_glow.build(g, w, "cpu")
    gen = torch.Generator().manual_seed(1)
    mel = torch.randn(2, g.n_mels, 6, generator=gen) * 3 - 5
    z = torch.randn(2, g.n_group, 6 * g.hop // g.n_group, generator=gen) * g.sigma
    with torch.no_grad():
        audio = ref_glow.infer(ref, g, mel, z)
        back = ref_glow.forward(ref, g, audio, ref_glow.upsample(ref, g, mel))[0]
        assert float((back - z).abs().max()) < 1e-4
        got = waveglow.forward(model, cfg, audio, waveglow.upsample(model, cfg, mel))[0]
        assert float((got - z).abs().max()) < 1e-4
