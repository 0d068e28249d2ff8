"""The reference against the program at tiny widths on the CPU, both in
float32: where the program computes what the reference restates, they
agree to rounding (the training steps through ``Chassis.train``, the
served logits through prime and the f32 rollout)."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark.loops import reconstruct as serve_loop
from benchmark.loops import train as train_loop
from benchmark.reference import config as ref_config
from benchmark.reference import data as ref_data
from benchmark.reference import models as ref_models
from benchmark.tests import tiny


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(run):
    run.config_doc["train"]["compute_dtype"] = "float32"
    run.config_doc["wavenet"]["use_pallas_stack"] = False


@pytest.mark.parametrize("cell", [tiny.TRAIN])
@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_first_three_steps_match_the_program_in_f32(tmp_path, cell, seed):
    root = tiny.make_root(tmp_path)
    _, run = tiny.open_run(root, cell, seed=seed)
    _f32(run)
    prog = train_loop.setup(run, train_loop.write_data(run))
    got = train_loop.first_steps(prog)
    w = prog.weights
    prog.chassis.close()
    ref = train_loop.reference_steps(run, w, prog.prefix, torch.device("cpu"))
    gaps = train_loop.readings(got, ref, train_loop.reference_config(run, prog.prefix).bottleneck)
    assert max(gaps["loss_gap_first_last"]) < 1e-5
    assert max(gaps["grad_gap"], gaps["grad_diff"], gaps["change_gap"],
               gaps["codebook_gap"]) < 1e-3
    k = run.traffic["steps_per_call"]
    assert len(ref) == 1 + k and ref[0]["loss"] != ref[-1]["loss"]
    # the window program's call moved the VQ codebook and its EMA state
    for leaf in ("bottleneck.codebook", "bottleneck.ema_counts", "bottleneck.ema_sums"):
        assert not torch.equal(got["after"][leaf], got["before"][leaf])


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.VOCODE])
def test_teacher_logits_match_the_programs_f32_rollout(tmp_path, cell):
    from ae_wavenet_tpu_torch.models import common
    from ae_wavenet_tpu_torch.ops import fastgen

    root = tiny.make_root(tmp_path)
    _, run = tiny.open_run(root, cell, seed=11)
    prog = serve_loop.setup(run)
    rows = torch.tensor([0, 1])
    wav, spk = prog.wav[rows], prog.spk[rows]
    n = run.traffic["gen_samples"]
    prep = common.prime_for_generation(prog.family.encode, prog.model, prog.cfg, wav, spk, n)
    ids, _, logits = fastgen.generate(prog.model.wavenet, prog.cfg.wavenet, prep.state,
                                      prep.gen_cond, gc_ids=spk, temperature=0.0,
                                      return_logits=True)
    cfg = ref_config.from_json(run.config_json())
    if cfg.spec.norm == "dataset":  # worked out again from the pool's file
        mean, var = ref_data.frame_stats(serve_loop._prefix(run), cfg.spec)
        assert mean == pytest.approx(prog.cfg.spec.stats_mean, rel=1e-6, abs=1e-9)
        cfg = dataclasses.replace(cfg, spec=dataclasses.replace(
            cfg.spec, stats_mean=mean, stats_var=var))
    model = ref_models.build(cfg, prog.weights, "cpu")
    with torch.no_grad():
        ref = ref_models.teacher_logits(model, cfg, wav, spk, ids, n)
    assert ref.shape == (2, n, cfg.wavenet.n_quant)
    assert torch.allclose(ref, logits.permute(0, 2, 1), atol=1e-4, rtol=1e-4)


def test_the_samplers_draws_are_worked_out_again():
    """The reference's Gumbel draws and kernel seed are the program's."""
    from ae_wavenet_tpu_torch.ops import fastgen_cuda

    from benchmark.reference import sampling

    seed = sampling.kernel_seed(serve_loop.request_seed(2**31 + 9, 3))
    g = torch.Generator().manual_seed(serve_loop.request_seed(2**31 + 9, 3))
    assert seed == int(torch.randint(0, 2**31 - 1, (), generator=g)) & 0x7FFFFFFF
    rows = torch.tensor([0, 5, 63])
    ref = sampling.gumbel(seed, rows, 1021, 3, 256)
    for t in range(3):
        assert torch.equal(ref[:, t], fastgen_cuda.gumbel_noise(seed, rows, 1021 + t, 256))
