"""The port's measuring scripts (``ae_wavenet_tpu_torch/scripts``: bench_gated,
bench_vq, bench_gen, bench_mfcc, bench_ckpt, bench_chassis, probe_dispatch,
ablate_step, convergence_ab, train_curves) against the JAX package's
``scripts/``, at the tiny width on the CPU: each prints the JAX script's
records key for key (the JAX script's own output where it runs here at a
tiny size, else its source's record or the reference's records under
``docs/``), takes its flags, and the numbers that can be held to the
reference are: the gated forwards on the same weights, the eager sampler's
greedy ids, the frontend's frame count, the two stacks' training curves."""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ae_wavenet_tpu.models import wavenet as jwn
from ae_wavenet_tpu.ops import fastgen as jfg
from ae_wavenet_tpu.training import torch_compat
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu_torch.models import wavenet as twn
from ae_wavenet_tpu_torch.ops import fastgen as tfg
from ae_wavenet_tpu_torch.ops import fastgen_cuda as tfc
from ae_wavenet_tpu_torch.ops import gated, vq_cuda
from ae_wavenet_tpu_torch.scripts import (ablate_step, bench_chassis, bench_ckpt,
                                          bench_gated, bench_gen, bench_mfcc, bench_vq,
                                          convergence_ab, probe_dispatch, train_curves)
from ae_wavenet_tpu_torch.training import weights
from ae_wavenet_tpu_torch.utils import config as tcfg
from scripts import bench_ckpt as jbench_ckpt
from scripts import bench_gen as jbench_gen
from scripts import bench_mfcc as jbench_mfcc
from scripts import probe_dispatch as jprobe_dispatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
STACK_TOL = 0.02    # stack forward against the bf16 plain path, tests/test_gated_pallas.py:48
CE_MEAN_TOL, CE_MAX_TOL = 0.01, 0.05  # the two stacks' recon CE, bf16 at the tiny width


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny widths gain nothing from more, and the
    suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _printed(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _source(name: str) -> str:
    with open(os.path.join(ROOT, "scripts", f"{name}.py")) as f:
        return f.read()


def _source_keys(name: str) -> list[set]:
    """The keys of every ``json.dumps({...})`` record in a JAX script's
    source, one set per record."""
    out = []
    for block in re.findall(r"json\.dumps\(\{(.*?)\}\)", _source(name), re.S):
        out.append(set(re.findall(r'"(\w+)":', block)))
    return out


def _tiny(cfg: tcfg.RunConfig, batch_sz: int = 2, n_win: int = 320) -> tcfg.RunConfig:
    """``cfg`` at the tiny preset's widths (every other field kept) and a
    small batch."""
    t = tcfg.tiny_config()
    wn = dataclasses.replace(
        t.wavenet, use_pallas_stack=cfg.wavenet.use_pallas_stack,
        gated_tile=cfg.wavenet.gated_tile)
    bn = dataclasses.replace(cfg.bottleneck, n_dim=16, vq_k=min(cfg.bottleneck.vq_k, 32))
    train = dataclasses.replace(cfg.train, batch_sz=batch_sz, n_win=n_win)
    return dataclasses.replace(cfg, encoder=t.encoder, bottleneck=bn, wavenet=wn,
                               train=train)


def _tiny_decoder(cfg: tcfg.WaveNetConfig) -> tcfg.WaveNetConfig:
    return _tiny(tcfg.RunConfig(wavenet=cfg)).wavenet


def _carried_decoder(seed: int):
    """The JAX package's tiny decoder, with its config: (params, cfg)."""
    wcfg = jcfg.tiny_config().wavenet
    return jwn.init(jax.random.PRNGKey(seed), wcfg), wcfg


def _port_decoder(jparams, wcfg):
    """The port's decoder holding the JAX decoder's weights, carried over
    by ``training/weights`` under their dotted names."""
    wn = twn.WaveNet(tcfg.from_json(jcfg.to_json(jcfg.RunConfig(wavenet=wcfg))).wavenet)
    return weights.load_into(wn, torch_compat.flatten_named({"params": jparams}))


# ----------------------------------------------------------- bench_gated

def test_bench_gated_forwards_match_jax_on_the_same_weights():
    """The plain bf16 forward, the pair kernels' and the whole-stack
    kernel's (their plain versions here) against the JAX ``wavenet.apply``
    in bf16 on weights carried over by ``training/weights``."""
    jw, wcfg = _carried_decoder(0)
    rng = np.random.default_rng(0)
    t_in = 200 + jwn.receptive_field(wcfg)
    x_ids = rng.integers(0, wcfg.n_quant, (2, t_in))
    cond = (rng.normal(size=(2, wcfg.n_lc_out, t_in)) * 0.5).astype(np.float32)
    spk = rng.integers(0, wcfg.n_speakers, (2,))
    apply = jax.jit(lambda p, i, c, k: jwn.apply(p, wcfg, i, c, k, dtype=jnp.bfloat16))
    want = np.asarray(apply(jw, jnp.asarray(x_ids), jnp.asarray(cond, jnp.bfloat16),
                            jnp.asarray(spk)), np.float32)
    arms = bench_gated.forwards(_port_decoder(jw, wcfg), wcfg, torch.from_numpy(x_ids),
                                torch.from_numpy(cond).to(torch.bfloat16),
                                torch.from_numpy(spk))
    with torch.no_grad():
        for name, fn in zip(("plain", "pairs", "full_fusion"), arms):
            got = fn().float().numpy()
            assert got.shape == want.shape
            assert np.abs(got - want).max() < STACK_TOL, (name, np.abs(got - want).max())


def test_bench_gated_records_the_jax_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench_gated, "decoder_config",
                        lambda a, f=bench_gated.decoder_config: _tiny_decoder(f(a)))
    before = gated.gated_pair_fused_reference.launches
    assert bench_gated.main(["--device", "cpu", "--batch", "2", "--n-win", "100",
                             "--iters", "1", "--tile", "512"]) == 0
    rec, = _printed(capsys.readouterr().out)
    assert set(rec) == _source_keys("bench_gated")[0]
    assert rec["config"] == "b2 x 100, tile 512" and rec["full_fusion_applied"]
    assert rec["max_abs_diff"] < STACK_TOL and rec["full_fusion_max_abs_diff"] < STACK_TOL
    # the pair path's forward: one check and two timed calls
    pairs = len(gated.stack_dils(_tiny_decoder(tcfg.WaveNetConfig()))) // 2
    assert gated.gated_pair_fused_reference.launches - before == 3 * pairs


# -------------------------------------------------------------- bench_vq

def _tiny_sweep(monkeypatch):
    monkeypatch.setattr(bench_vq, "SWEEP_K", (32, 64))
    monkeypatch.setattr(bench_vq, "SWEEP_N", (100,))
    monkeypatch.setattr(bench_vq, "D", 16)
    monkeypatch.setattr(bench_vq, "OP_ITERS", 2)
    monkeypatch.setattr(bench_vq, "TRAIN_WARMUP", 1)
    monkeypatch.setattr(bench_vq, "TRAIN_ITERS", 1)
    monkeypatch.setattr(bench_vq, "step_config",
                        lambda *a, f=bench_vq.step_config: _tiny(f(*a)))
    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.setenv("BENCH_NWIN", "320")


def test_bench_vq_records_the_jax_keys(monkeypatch, capsys):
    _tiny_sweep(monkeypatch)
    assert bench_vq.main(["--device", "cpu"]) == 0
    recs = _printed(capsys.readouterr().out)
    want = _source_keys("bench_vq")
    ops = [r for r in recs if r["bench"] == "vq_op"]
    assert [(r["k"], r["n"]) for r in ops] == [(32, 100), (64, 100)]
    assert all(set(r) == want[0] and r["tile_n"] is None for r in ops)
    steps = [r for r in recs if r["bench"] == "train_step"]
    assert [r["vq_use_pallas"] for r in steps] == [False, True]
    assert all(set(r) == want[1] for r in steps)
    assert set(recs[-1]) == want[2] and recs[-1]["bench"] == "decision"


def test_bench_vq_rejects_a_kernel_that_disagrees(monkeypatch):
    """A kernel that leaves |e|^2 out of its distances fails the script."""
    _tiny_sweep(monkeypatch)

    def wrong(z, e, stats=True):
        codes = (-2.0 * (z @ e.t())).argmin(1)
        onehot = torch.nn.functional.one_hot(codes, e.shape[0]).float()
        return codes.to(torch.int32), e[codes], onehot.sum(0), onehot.t() @ z

    monkeypatch.setattr(vq_cuda, "vq_lookup_fused", wrong)
    with pytest.raises(RuntimeError, match="codes differ|no tie"):
        bench_vq.main(["--device", "cpu"])


# ------------------------------------------------------------- bench_gen

def test_bench_gen_xla_scan_record_matches_the_jax_script(monkeypatch, capsys):
    """The JAX script's ``xla_scan`` record on the CPU and the port's, key
    for key, at the tiny decoder; the port's ``pallas_fused`` records hold
    the keys of the TPU record ``docs/bench_gen_r5.jsonl``."""
    monkeypatch.setenv("GEN_BATCH", "2")
    monkeypatch.setenv("GEN_STEPS", "6")
    jtiny = jcfg.tiny_config().wavenet
    monkeypatch.setattr(jcfg, "WaveNetConfig", lambda: jtiny)
    capsys.readouterr()
    assert jbench_gen.main() == 0
    want, = _printed(capsys.readouterr().out)  # no fused record off the TPU
    ttiny = tcfg.tiny_config().wavenet
    monkeypatch.setattr(bench_gen, "decoder_config", lambda: ttiny)
    with open(os.path.join(DOCS, "bench_gen_r5.jsonl")) as f:
        tpu = [json.loads(ln) for ln in f if ln.strip()]
    for mode, path in (("", "pallas_fused"), ("GEN_INT8", "pallas_fused_int8"),
                       ("GEN_INT4", "pallas_fused_int4")):
        if mode:
            monkeypatch.setenv(mode, "1")
            monkeypatch.setenv("GEN_SKIP_SCAN", "1")
        launches = tfc.generate_fused_reference.launches
        assert bench_gen.main(["--device", "cpu"]) == 0
        recs = _printed(capsys.readouterr().out)
        assert tfc.generate_fused_reference.launches - launches == 4
        if not mode:
            scan = recs.pop(0)
            assert set(scan) == set(want) and scan["path"] == "xla_scan"
            assert (scan["platform"], scan["batch"], scan["dtype"], scan["gen_steps"]) == \
                ("cpu", 2, "bfloat16", 6) == (want["platform"], want["batch"],
                                              want["dtype"], want["gen_steps"])
        rec, = recs
        assert rec["path"] == path and rec["batch"] == 2
        assert set(rec) == set(next(r for r in tpu if r["path"] == path))
        if mode:
            monkeypatch.delenv(mode)


def test_eager_sampler_in_bf16_matches_jax_greedy():
    """``fastgen.generate(dtype=bfloat16)``, the record's ``xla_scan`` arm,
    against the reference's ``generate(dtype=bfloat16)`` at temperature 0 on
    the same weights: the greedy ids over the agreeing prefix (at least 8
    steps), the logits there within 2e-2 of their largest."""
    jw, wcfg = _carried_decoder(3)
    jw["post2"]["w"] = jw["post2"]["w"] * 30.0  # informative logits
    wn = _port_decoder(jw, wcfg)
    rng = np.random.default_rng(1)
    n = 24
    cond = (rng.normal(size=(2, wcfg.n_lc_out, n)) * 0.3).astype(np.float32)
    spk = np.array([1, 3])
    ids_j, _, lg_j = jfg.generate(jw, wcfg, jfg.init_state(wcfg, 2),
                                  jnp.asarray(cond), jax.random.PRNGKey(0),
                                  gc_ids=jnp.asarray(spk), temperature=0.0,
                                  dtype=jnp.bfloat16, return_logits=True)
    tw = wn.cfg
    ids_t, _, lg_t = tfg.generate(wn, tw, tfg.init_state(tw, 2),
                                  torch.from_numpy(cond), gc_ids=torch.from_numpy(spk),
                                  temperature=0.0, return_logits=True,
                                  dtype=torch.bfloat16)
    ids_j, lg_j = np.asarray(ids_j), np.asarray(lg_j)
    scale = np.abs(lg_j).max()
    for r in range(2):
        diff = np.nonzero(ids_t[r].numpy() != ids_j[r])[0]
        t_div = n if len(diff) == 0 else int(diff[0])
        assert t_div >= 8, (r, t_div)
        hi = min(t_div + 1, n)
        err = np.abs(lg_t[r, :, :hi].numpy() - lg_j[r, :, :hi]).max() / scale
        assert err < 2e-2, (r, err)


# ------------------------------------------------------------ bench_mfcc

def test_bench_mfcc_records_match_the_jax_script(monkeypatch, capsys):
    """The device row against the JAX script's on the CPU (the same frame
    count), the host row and the share row key for key with the TPU record
    ``docs/bench_mfcc_tpu_r5.jsonl``, and the share at the port's rate."""
    monkeypatch.setenv("MFCC_T", "4000")
    capsys.readouterr()
    assert jbench_mfcc.main() == 0
    want = _printed(capsys.readouterr().out)
    assert bench_mfcc.main(["--device", "cpu"]) == 0
    got = _printed(capsys.readouterr().out)
    with open(os.path.join(DOCS, "bench_mfcc_tpu_r5.jsonl")) as f:
        tpu = [json.loads(ln) for ln in f if ln.strip()]
    assert [set(r) for r in got] == [set(r) for r in want] == [set(r) for r in tpu]
    assert got[0]["frames_per_call"] == want[0]["frames_per_call"] == 4 * 15
    assert [r["path"] for r in got] == ["torch_device_cpu", "host_torch_cpu",
                                        "train_step_share"]
    assert got[2]["train_samples_per_sec_assumed"] == 1313028.0
    assert got[2]["frames_per_sec_needed"] == round(1313028 / 160, 1)


# ------------------------------------------------------------ bench_ckpt

def test_bench_ckpt_record_matches_the_jax_script(capsys):
    """Tiny config on both sides: the same keys; the port's snapshot holds
    the params, the optimizer state and the bottleneck state, as the
    reference's tree does (within 1%: the port's optimizer state has one
    count where optax keeps two)."""
    capsys.readouterr()
    assert jbench_ckpt.main(["--repeats", "1"]) == 0
    want, = _printed(capsys.readouterr().out)
    assert bench_ckpt.main(["--repeats", "1", "--device", "cpu"]) == 0
    got, = _printed(capsys.readouterr().out)
    assert set(got) == set(want) and got["metric"] == "ckpt_save_pause_sec"
    assert abs(got["params_mb"] - want["params_mb"]) <= 0.01 * want["params_mb"] + 0.05
    assert got["blocking_save_sec"] > 0 and got["async_save_return_sec"] > 0


# --------------------------------------------------------- bench_chassis

def test_bench_chassis_record_and_one_log_window(monkeypatch, capsys):
    from ae_wavenet_tpu_torch.training import chassis

    logged = []
    train = chassis.Chassis.train

    def recording(self, n=None, eval_every=0):
        hist = train(self, n, eval_every)
        logged.append([h["step"] for h in hist])
        return hist

    monkeypatch.setattr(chassis.Chassis, "train", recording)
    monkeypatch.setattr(bench_chassis, "run_config",
                        lambda a, s, f=bench_chassis.run_config: _tiny(f(a, s), 2, 320))
    assert bench_chassis.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                               "--n-win", "320"]) == 0
    rec, = _printed(capsys.readouterr().out)
    assert set(rec) == _source_keys("bench_chassis")[0]
    assert rec["config"] == "b2 x 320, 4 steps, loader included" and rec["value"] > 0
    assert logged == [[3], [7]]


# -------------------------------------------------------- probe_dispatch

def test_probe_dispatch_record_matches_the_jax_script(monkeypatch, capsys):
    """``PROBE_TINY`` on both sides: the same keys, K and the same block."""
    monkeypatch.setenv("PROBE_TINY", "1")
    capsys.readouterr()
    assert jprobe_dispatch.main() == 0
    want, = _printed(capsys.readouterr().out)
    assert probe_dispatch.main(["--device", "cpu"]) == 0
    got, = _printed(capsys.readouterr().out)
    assert set(got) == set(want)
    assert {k: got[k] for k in ("k", "batch", "n_win", "block_mbytes")} == \
        {k: want[k] for k in ("k", "batch", "n_win", "block_mbytes")}
    assert all(np.isfinite(v) and v >= 0 for v in got.values())


# ----------------------------------------------------------- ablate_step

def test_ablate_step_prints_the_jax_lines(monkeypatch, capsys):
    monkeypatch.setattr(ablate_step, "run_config",
                        lambda a, f=ablate_step.run_config: _tiny(f(a), a.batch, a.n_win))
    for flag in ([], ["--no-pallas"]):
        before = gated.gated_pair_bwd_reference.launches
        assert ablate_step.main(["--device", "cpu", "--iters", "1", "--batch", "2",
                                 "--n-win", "160", *flag]) == 0
        lines = capsys.readouterr().out.splitlines()
        labels = re.findall(r'print\(f"([a-z +]+ms): ', _source("ablate_step"))
        assert len(labels) == 6
        assert lines[0] == f"pallas_stack={not flag} b2 x 160"
        assert [ln[:len(lab) + 1] for ln, lab in zip(lines[1:], labels)] == \
            [lab + ":" for lab in labels]
        assert all(float(ln.split()[-1]) > 0 for ln in lines[1:])
        # the decoder's and the loss's backward: 3 calls each, on pairs
        pairs = len(tcfg.tiny_config().wavenet.dilations) // 2
        assert gated.gated_pair_bwd_reference.launches - before == \
            (0 if flag else 2 * 3 * pairs)


# -------------------------------------------------------- convergence_ab

def test_convergence_ab_arms_agree(monkeypatch, capsys):
    """The plain stack and the kernels' (plain versions here) from one init
    on one stream of batches: the recon CE within CE_MEAN_TOL on average
    and CE_MAX_TOL at every step; the record carries the JAX keys."""
    monkeypatch.setattr(convergence_ab, "run_config",
                        lambda s, f=convergence_ab.run_config: _tiny(f(s), 2, 320))
    assert convergence_ab.main(["--device", "cpu", "--steps", "6"]) == 0
    rec, = _printed(capsys.readouterr().out)
    assert set(rec) == _source_keys("convergence_ab")[0]
    assert rec["steps"] == 6 and rec["xla_first_last"][0] > 0
    assert rec["mean_abs_ce_diff"] <= CE_MEAN_TOL and rec["max_abs_ce_diff"] <= CE_MAX_TOL


def test_convergence_ab_returns_1_outside_its_limit(monkeypatch, capsys):
    monkeypatch.setattr(convergence_ab, "run_config",
                        lambda s, f=convergence_ab.run_config: _tiny(f(s), 2, 320))
    monkeypatch.setattr(convergence_ab, "MAX_LIMIT", -1.0)
    assert convergence_ab.main(["--device", "cpu", "--steps", "2"]) == 1
    assert len(_printed(capsys.readouterr().out)) == 1


# ----------------------------------------------------------- train_curves

def test_train_curves_writes_the_reference_record_under_out(tmp_path, monkeypatch,
                                                            capsys):
    monkeypatch.setenv("CURVE_STEPS", "20")
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "curves" / "c.json"
    assert train_curves.main(["--device", "cpu", "--out", str(out)]) == 0
    assert sorted(os.listdir(tmp_path)) == ["curves"]
    assert os.listdir(tmp_path / "curves") == ["c.json"]
    got = json.loads(out.read_text())
    with open(os.path.join(DOCS, "training_curves.json")) as f:
        want = json.load(f)
    assert list(got) == list(want) == ["ae", "vq", "vae"]
    for kind in got:
        assert set(got[kind]) == set(want[kind])
        assert set(got[kind]["extra"]) == set(want[kind]["extra"])
        assert got[kind]["steps"] == [10, 20]
        assert all(np.isfinite(got[kind]["recon_ce"]))
    assert "wrote " + str(out) in capsys.readouterr().out
    with pytest.raises(SystemExit, match="JAX package's record"):
        train_curves.main(["--device", "cpu", "--out", "docs/training_curves.json"])
    assert train_curves.DEFAULT_OUT == os.path.join("docs", "training_curves_torch.json")


# --------------------------------------------------------- flags, device

SCRIPTS = {"bench_gated": bench_gated, "bench_vq": bench_vq, "bench_gen": bench_gen,
           "bench_mfcc": bench_mfcc, "bench_ckpt": bench_ckpt,
           "bench_chassis": bench_chassis, "probe_dispatch": probe_dispatch,
           "ablate_step": ablate_step, "convergence_ab": convergence_ab,
           "train_curves": train_curves}


def _options(text: str) -> set:
    return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', text))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_takes_the_jax_flags_and_environment(name):
    """Every flag and environment variable of the JAX script; beside them
    only ``--device`` (and train_curves' ``--out``)."""
    ref = _source(name)
    with open(os.path.join(ROOT, "ae_wavenet_tpu_torch", "scripts", f"{name}.py")) as f:
        port = f.read()
    extra = {"--device", "--out"} if name == "train_curves" else {"--device"}
    assert _options(port) - _options(ref) == extra
    assert _options(ref) <= _options(port)
    env = set(re.findall(r'os\.environ\.get\("(\w+)"', ref)) - {"XLA_FLAGS"}
    assert env <= set(re.findall(r'os\.environ\.get\("(\w+)"', port)), sorted(env)


@pytest.mark.parametrize("name", ["bench_gated", "bench_gen", "probe_dispatch",
                                  "train_curves"])
def test_scripts_take_the_cpu_only_when_asked(name, monkeypatch):
    """No ``--device``: the card, which this machine does not have."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("PROBE_TINY", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRIPTS[name].main([])
