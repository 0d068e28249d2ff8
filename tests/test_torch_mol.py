"""The mixture-of-logistics vocoder (Tacotron 2's WaveNet, the port's own
``n_mix`` key and log-mel conditioning at ``n_mfcc`` = 0) against the benchmark's plain reference
``benchmark/reference/mol.py``, on the CPU at tiny widths.

The same seeded weights load into both by their dotted names.  Tolerances:
the f32 teacher-forced mixture parameters, the loss and its gradients
within 1e-5 of the largest value (two f32 reduction orders); prime's rings
within rtol = atol = 1e-5 of the f32 step loop's (``fastgen_oracle``); the
plain sampler's draws equal to the reference's worked from the same
mixture parameters within 1e-6.
"""

import dataclasses
import json
import math
import pathlib
import shutil

import numpy as np
import pytest
import torch

import fastgen_oracle as oracle
from ae_wavenet_tpu_torch.audio import mfcc as tmfcc
from ae_wavenet_tpu_torch.models import autoencoder as tae
from ae_wavenet_tpu_torch.models import common as tcommon
from ae_wavenet_tpu_torch.models import mfcc_inverter as tmi
from ae_wavenet_tpu_torch.models import wavenet as twn
from ae_wavenet_tpu_torch.ops import fastgen as tfg
from ae_wavenet_tpu_torch.ops import fastgen_cuda as tfc
from ae_wavenet_tpu_torch.utils import config as tcfg
from ae_wavenet_tpu_torch.utils import flops as tflops
from benchmark import calibrate_vocoder, harness, weights
from benchmark.reference import mol

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = ROOT / "benchmark/configs/wavenet_mol_24k.json"
TINY_WAVENET = {"n_blocks": 1, "n_block_layers": 6, "n_res": 32, "n_dil": 32, "n_skp": 32,
                "n_post": 32, "n_lc_in": 16, "n_lc_out": 16, "n_mix": 3,
                "use_pallas_stack": False}
SAMPLE_TINY = dict(n_mels=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _doc(**wavenet) -> dict:
    doc = json.loads(CONFIG.read_text())
    doc["wavenet"].update(TINY_WAVENET, **wavenet)
    doc["spec"].update(SAMPLE_TINY, norm="window")
    doc["train"].update(batch_sz=2, n_win=320, steps_per_call=2, compute_dtype="float32")
    return doc


def _configs(**wavenet):
    """(the port's config, the reference's vocoder) of one tiny document."""
    doc = json.dumps({k: v for k, v in _doc(**wavenet).items()
                      if k not in ("source", "reduced", "assumed")})
    return tcfg.from_json(doc), mol.from_json(doc)


def _models(cfg, voc, seed=3):
    """The program's model and the reference's with one set of seeded
    weights (the benchmark's draw)."""
    model = tmi.init(cfg, None, "cpu")
    w = weights.make(model, seed, torch.device("cpu"))
    weights.load(model, w)
    return model, mol.build(voc, w, torch.device("cpu"))


def _wav(n, b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(n) / 24000.0
    x = 0.3 * torch.sin(2 * math.pi * 180.0 * t) + 0.05 * torch.randn(b, n, generator=g)
    return torch.clamp(torch.round(x * 32768), -32768, 32767).to(torch.int16)


def _close(a, b, tol=1e-5):
    a, b = a.detach().double(), b.detach().double()
    assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


# ------------------------------------------------------------------ config
def test_the_configuration_file_round_trips_and_keeps_its_keys():
    doc = json.loads(CONFIG.read_text())
    cfg = tcfg.from_json(json.dumps(doc))
    assert cfg.wavenet.n_mix == 10 and cfg.spec.log_mel and cfg.wavenet.n_out == 30
    assert cfg.wavenet.log_scale_min == math.log(1e-14)
    assert tcfg.from_json(tcfg.to_json(cfg)) == cfg
    written = json.loads(tcfg.to_json(cfg))
    assert written["wavenet"]["n_mix"] == 10 and written["spec"]["n_mfcc"] == 0
    assert "log_scale_min" not in written["wavenet"]  # the default is not written
    for group in ("spec", "wavenet", "train"):
        for k, v in written[group].items():
            want = doc[group][k]
            assert (list(v) if isinstance(v, list) else v) == want, (group, k)
    for key, default in tcfg.PORT_KEYS["wavenet"].items():
        assert key not in json.loads(tcfg.to_json(tcfg.RunConfig()))["wavenet"]
        assert getattr(tcfg.WaveNetConfig(), key) == default


def test_the_published_widths_stream_12_of_30_layers():
    cfg = tcfg.from_json(CONFIG.read_text())
    wn = cfg.wavenet
    assert (len(wn.dilations), wn.n_res, wn.n_dil, wn.n_skp, wn.n_post) == (30, 512, 256, 256, 256)
    assert wn.dilations[:11] == (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1) and sum(wn.dilations) == 3069
    plan = tfc.plan_for(wn, None, 132, 232448)
    assert (plan.n_blocks, plan.resident_layers, plan.n_layers) == (132, 18, 30)
    assert plan.streamed_bytes == 18_481_152
    assert plan.smem_bytes <= 232448
    # the same widths without the mixture's input map: an embedding of 30 rows
    old = tfc.share_plan(512, 256, 256, 256, 30, 80, 30, None, 132, 232448)
    assert (old.resident_layers, old.smem_bytes) == (18, 228512)
    spec = tmi.make_window_spec(cfg)
    assert spec.n_win == 48000 and spec.rf == 3069


def test_the_mixture_pack_takes_the_bf16_launch_path_on_the_host():
    """The mixture's pack (the input map in place of the embedding) is
    ``"mol"``'s type, passes the launch's argument checks and lays out its
    layers and post-net in the blocks' shares as a bf16 pack of the same
    tensors does; the kernel instance and counters come from one table."""
    cfg, _ = _configs()
    wn = cfg.wavenet
    model = tmi.init(cfg, torch.Generator().manual_seed(0), "cpu")
    packed = tfc.pack_for_kernel(model.wavenet, wn)
    assert type(packed) is tfc.MolKernelParams and tfc._mode_for(wn, False) == "mol"
    assert packed.in0.shape == (2, wn.n_res) and packed.in0.dtype == torch.float32
    batch = 3
    flat = torch.zeros(sum(wn.dilations), batch, wn.n_res, dtype=torch.bfloat16)
    cond = torch.zeros(batch, wn.n_lc_out, 5)
    tfc._check_cuda_args(packed, "mol", wn, flat, torch.zeros(batch), cond)
    with pytest.raises(ValueError, match="f32 samples"):
        tfc._check_cuda_args(packed, "mol", wn, flat, torch.zeros(batch, dtype=torch.int32),
                             cond)
    plan = tfc.plan_for(wn, None, 8, 232448)
    as_bf16 = tfc.KernelParams(**{k: v for k, v in packed._asdict().items() if k != "in0"},
                               embed=torch.zeros(wn.n_out, wn.n_res, dtype=torch.bfloat16))
    assert torch.equal(tfc.pack_shares(packed, plan), tfc.pack_shares(as_bf16, plan))
    assert (tfc._MODES["mol"], tfc._COUNTERS["mol"]) == (3, ("launches", "mol_launches"))
    assert tfc.PACKERS["mol"](model.wavenet, wn)._fields == tfc.MolKernelParams._fields


def test_the_quantized_samplers_refuse_a_mixture():
    cfg, _ = _configs()
    model = tmi.init(cfg, torch.Generator().manual_seed(0), "cpu")
    st = tfg.init_state(cfg.wavenet, 1)
    for q in ("int8", "int4", True):
        with pytest.raises(ValueError, match="bf16 weights only"):
            tfc.generate_auto(model.wavenet, cfg.wavenet, st, torch.zeros(1, 16, 4),
                              quantized=q)
    with pytest.raises(NotImplementedError):
        tfg.generate(model.wavenet, cfg.wavenet, st, torch.zeros(1, 16, 4))
    with pytest.raises(ValueError, match="mfcc_inverter"):
        tae.init(dataclasses.replace(tcfg.tiny_config(), wavenet=cfg.wavenet), None, "cpu")


def test_no_speaker_table_without_global_embedding():
    cfg, _ = _configs()
    assert cfg.wavenet.n_global_embed == 0
    model = tmi.init(cfg, torch.Generator().manual_seed(0), "cpu")
    names = dict(model.named_parameters())
    assert "wavenet.gc_embed" not in names and "wavenet.embed" not in names
    assert names["wavenet.in0.w"].shape == (32, 1) and names["wavenet.post2.w"].shape == (9, 32)
    cond = torch.randn(2, 16, 5)
    assert tfg.with_gc(model.wavenet, cfg.wavenet, cond, torch.tensor([0, 0])) is cond
    w = weights.make(model, 7, torch.device("cpu"))  # every tensor drawn, none empty
    assert all(t.numel() for t in w.values())


# ----------------------------------------------------------- the frontend
def test_log_mel_features_and_stats_have_n_mels_channels(tmp_path):
    cfg, voc = _configs()
    wav = _wav(9000).float() / 32768.0
    f = tmfcc.features(wav, cfg.spec)
    assert f.shape == (2, 16, (9000 - 1200) // 300 + 1)
    _close(f, mol.log_mel(wav, voc.cfg.spec), 1e-6)
    from benchmark import traffic
    from ae_wavenet_tpu_torch.data.preprocess import dataset_frame_stats

    prefix = traffic.write_packed(str(tmp_path / "p"), [np.asarray(_wav(9000, 1)[0])] * 2,
                                  np.zeros(2, np.int64), 1)
    mean, var = dataset_frame_stats(prefix, cfg.spec)
    rm, rv = mol.frame_stats(prefix, voc.cfg.spec)
    assert len(mean) == 16
    np.testing.assert_allclose(mean, rm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var, rv, rtol=1e-5, atol=1e-5)


# --------------------------------------------- teacher forcing and the loss
def test_teacher_forced_mixture_parameters_match_the_reference():
    cfg, voc = _configs()
    model, ref = _models(cfg, voc)
    wav = _wav(12000)
    served = _wav(40, seed=1)
    n = served.shape[1]
    params = mol.teacher_params(ref, voc, wav, served, n)
    cond, c_off = tmi.encode(model, cfg, wav)
    rf = twn.receptive_field(cfg.wavenet)
    x = torch.cat([wav[:, c_off : c_off + rf + 1], served[:, : n - 1]], 1).float() / 32768.0
    got = twn.apply(model.wavenet, cfg.wavenet, x, cond[..., : rf + n], btq=True)
    assert got.shape == (2, n, 9)
    _close(got, params)


def _loss_case(kind):
    g = torch.Generator().manual_seed({"inside": 0, "edges": 1, "floor": 2}[kind])
    params = torch.randn(2, 9, 50, generator=g)
    x = torch.rand(2, 50, generator=g) * 1.6 - 0.8
    if kind == "edges":
        x[:, ::3] = 1.0
        x[:, 1::3] = -1.0
        x[:, 2::6] = 32767 / 32768
    if kind == "floor":
        params[:, 6:] = -40.0  # every log-scale under the floor
        params[:, 3:6] = x[:, None, :] + 1e-9  # the means on the samples
    return params, x


@pytest.mark.parametrize("kind", ["inside", "edges", "floor"])
def test_mixture_loss_and_gradients_match_the_reference(kind):
    params, x = _loss_case(kind)
    lsm = math.log(1e-14)
    a = params.clone().requires_grad_(True)
    b = params.clone().requires_grad_(True)
    got = tcommon.mol_nll(a, x, 65536, lsm)
    want = mol.mol_nll(b, x, 65536, lsm)
    got.backward()
    want.backward()
    assert math.isfinite(float(got.detach()))
    _close(got, want)
    _close(a.grad, b.grad)
    if kind == "floor":  # the clamped log-scales take no gradient
        assert float(a.grad[:, 6:].abs().max()) == 0.0
    # time-major layout, as the fused stack gives it
    _close(tcommon.mol_nll(params.transpose(1, 2), x, 65536, lsm, btq=True), want)


def test_training_loss_matches_the_reference_window():
    cfg, voc = _configs()
    model, ref = _models(cfg, voc)
    spec = tmi.make_window_spec(cfg)
    win = mol.window(voc)
    assert (spec.u_len, spec.fb, spec.fe, spec.w0, spec.t_in, spec.n_frames) == (
        win.u_len, win.fb, win.fe, win.w0, win.t_in, win.n_frames)
    wav = _wav(spec.u_len)
    got, aux = tmi.loss_fn(model, cfg, spec, wav, torch.zeros(2, dtype=torch.long))
    _close(got, mol.window_loss(ref, voc, win, wav))
    got.backward()
    assert float(model.wavenet.in0["w"].grad.abs().max()) > 0.0


def test_the_fused_stack_takes_the_sample_input_in_bf16():
    cfg, _ = _configs()
    cfg = dataclasses.replace(cfg, wavenet=dataclasses.replace(cfg.wavenet, use_pallas_stack=True),
                              train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))
    model = tmi.init(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = tmi.make_window_spec(cfg)
    wav = _wav(spec.u_len)
    loss, _ = tmi.loss_fn(model, cfg, spec, wav, torch.zeros(2, dtype=torch.long))
    f32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    want, _ = tmi.loss_fn(model, f32, spec, wav, torch.zeros(2, dtype=torch.long))
    assert abs(float(loss) - float(want)) < 0.02 * abs(float(want))
    loss.backward()
    assert float(model.wavenet.in0["w"].grad.abs().max()) > 0.0


def test_flops_count_the_log_mel_frontend_and_the_mixture_head():
    cfg, _ = _configs()
    spec = tmi.make_window_spec(cfg)
    mfcc = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec, n_mfcc=13))
    f = tflops.forward_flops(cfg, spec)
    sp = cfg.spec
    f0 = (spec.fe - spec.fb - sp.win_sz) // sp.hop_sz + 1
    assert f["mfcc"] == tflops.forward_flops(mfcc, spec)["mfcc"] - 2 * f0 * 13 * sp.n_mels
    assert f["decoder"] - 2 * spec.n_win * cfg.wavenet.n_post * 9 == (
        tflops.forward_flops(dataclasses.replace(cfg, wavenet=dataclasses.replace(
            cfg.wavenet, n_mix=0, n_quant=1)), spec)["decoder"] - 2 * spec.n_win * 32)


# ----------------------------------------------------- prime and the draws
def test_prime_rings_match_the_f32_step_loop():
    cfg, voc = _configs()
    model, _ = _models(cfg, voc)
    wn = cfg.wavenet
    rf = twn.receptive_field(wn)
    x = _wav(rf + 1, b=3, seed=4).float() / 32768.0
    cond = torch.randn(3, wn.n_lc_out, rf, generator=torch.Generator().manual_seed(5))
    got = tfg.prime(model.wavenet, wn, tfg.init_state(wn, 3), x, cond)
    want = oracle.old_prime(model.wavenet, wn, tfg.init_state(wn, 3), x, cond)
    for a, b in zip(got.bufs, want.bufs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert got.prev_id.dtype == torch.float32 and torch.equal(got.prev_id, x[:, -1])
    assert got.t == rf


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_plain_sampler_draws_as_the_reference_works_them_out(temperature):
    cfg, voc = _configs()
    model, _ = _models(cfg, voc)
    wn = cfg.wavenet
    packed = tfc.pack_for_kernel(model.wavenet, wn)
    flat = torch.zeros(sum(wn.dilations), 3, wn.n_res, dtype=torch.bfloat16)
    prev = torch.tensor([0.1, -0.2, 0.0])
    cond = torch.randn(3, 16, 24, generator=torch.Generator().manual_seed(6))
    t0, seed = 17, 12345
    samples, _, last, mix = tfc.generate_fused(packed, wn, flat, prev, t0, cond, seed,
                                               temperature, debug_logits=True)
    assert samples.dtype == torch.float32 and torch.equal(last, samples[:, -1])
    rows = torch.arange(3)
    g, v = mol.draws(seed, rows, t0, 24, 3) if temperature else (None, None)
    p = mix.permute(1, 0, 2)  # [B, T, 3K]
    k = mol.scores(p, 3, temperature, g).argmax(-1, keepdim=True)
    want = mol.component_draws(p, 3, voc.log_scale_min, temperature, v).gather(-1, k)[..., 0]
    torch.testing.assert_close(samples, want, rtol=0, atol=1e-6)
    mg, vg = mol.served_gaps(mol.scores(p, 3, temperature, g), mol.component_draws(
        p, 3, voc.log_scale_min, temperature, v), samples, 1e-3, 1e-3)
    assert float(mg.max()) == 0.0 and float(vg.max()) <= 1e-6
    assert (samples.abs() < 1).any()
    if temperature:  # the draws move the samples off the means
        assert not torch.allclose(samples, torch.clamp(p[..., 3:6], -1, 1).gather(-1, k)[..., 0])


def test_reconstruct_serves_int16_through_prime_and_the_sampler():
    cfg, voc = _configs()
    model, _ = _models(cfg, voc)
    before = tfg.prime.passes
    out, start = tmi.reconstruct(model, cfg, _wav(9000), torch.zeros(2, dtype=torch.long),
                                 torch.Generator().manual_seed(1), 1.0, 30)
    assert out.dtype == torch.int16 and out.shape == (2, 30)
    assert tfg.prime.passes == before + 1
    assert start == tmi.make_window_spec(cfg).w0 + twn.receptive_field(cfg.wavenet) + 1


def test_train_and_generate_clis_take_the_configuration_file(tmp_path, capsys):
    """``cli.train new --config``: the file's vocoder with the job's batch
    and window over it, two steps and a checkpoint; ``cli.generate``
    writes its 16-bit samples as they are, at 24 kHz."""
    from benchmark import traffic
    from ae_wavenet_tpu_torch.cli import generate as tgen
    from ae_wavenet_tpu_torch.cli import train as ttrain
    from ae_wavenet_tpu_torch.training import checkpoint as tckpt
    from ae_wavenet_tpu_torch.utils.wavio import read_wav

    doc = _doc()
    doc["spec"]["norm"] = "dataset"
    (tmp_path / "mol.json").write_text(json.dumps(doc))
    clips, spk = traffic.clips({"n_clips": 4, "clip_len": [9000, 12000], "n_speakers": 1,
                                "sample_rate": 24000}, 1)
    data = traffic.write_packed(str(tmp_path / "data" / "p"), clips, spk, 1, 24000)
    ckpt = str(tmp_path / "ckpt")
    assert ttrain.main(["new", "--config", str(tmp_path / "mol.json"), "--data", data,
                        "--ckpt-dir", ckpt, "--device", "cpu", "--batch-sz", "3",
                        "--n-win", "200", "--n-steps", "2", "--log-every", "1"]) == 0
    cfg = tckpt.load_config(ckpt, 2)[1]
    assert (cfg.wavenet.n_mix, cfg.spec.log_mel, cfg.train.batch_sz, cfg.train.n_win) == (
        3, True, 3, 200)
    assert len(cfg.spec.stats_mean) == 16
    out = str(tmp_path / "out.wav")
    assert tgen.main(["--ckpt", f"{ckpt}/step_00000002.pt", "--data", data, "--n-samples",
                      "30", "--max-input", "9000", "--device", "cpu", "--out", out]) == 0
    x, sr = read_wav(out)
    assert sr == 24000 and len(x) == 30 and x.dtype == np.int16
    capsys.readouterr()


# ------------------------------------------------------ the benchmark cell
def _tiny_root(tmp_path):
    root = tmp_path / "root"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = _doc()
    doc["spec"]["norm"] = "dataset"
    (root / "benchmark/configs/tiny_mol.json").write_text(json.dumps(doc))
    (root / "benchmark/traffic/tiny_mol.json").write_text(json.dumps(
        {"loop": "vocode_mol", "batch": 3, "gen_samples": 40, "temperature": 1.0,
         "greedy_every": 2, "check_rows": 2, "max_requests": 3,
         "pool": {"n_clips": 4, "clip_len": [9000, 9001], "n_speakers": 1,
                  "sample_rate": 24000}}))
    (root / "benchmark/limits/tiny.mol.json").write_text(json.dumps(
        {"mix_gap": 0.02, "value_gap": 0.015, "clipped_share": 0.05}))
    man = harness.manifest()
    man["configs"].append({"name": "tiny_mol", "source": "https://arxiv.org/abs/1712.05884",
                           "file": "benchmark/configs/tiny_mol.json", "reduced": [],
                           "why": "tiny"})
    man["workloads"] = [{"name": "tiny.mol", "config": "tiny_mol", "traffic": "tiny_mol",
                         "chips": 1, "why": "tiny"}]
    for m in man["end_to_end"] + man["per_layer"]:
        if "serve.wavenet_mol_24k.b64" in m.get("workloads", []):
            m["workloads"] = ["tiny.mol"]
        elif "workloads" in m:
            m["workloads"] = []
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def _execute(man, run, root) -> dict:
    """``harness.execute`` short of its look for JAX's modules, which this
    process holds for the other tests: the loop, the metrics and the
    checks."""
    harness.loop_of(run, root).run(run)
    return {"correct": bool(run.checks) and all(c.ok for c in run.checks),
            "attempted": run.attempted, "failed": run.failed,
            "metrics": harness.read_metrics(man, run, root),
            "checks": {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}}


def _tiny_run(tmp_path, trace=False):
    root = _tiny_root(tmp_path)
    man = harness.manifest(root)
    run = harness.open_run(man, "tiny.mol", 2**31 + 5, 0.5, trace, root=root, device="cpu")
    run.tmp = str(root / "tmp")
    return man, run, root


@pytest.mark.parametrize("fault", [None, "component_altered", "sample_altered"])
def test_the_vocoder_cell_is_correct_and_its_faults_are_not(tmp_path, fault):
    man, run, root = _tiny_run(tmp_path)
    if fault is None:
        result = _execute(man, run, root)
    else:
        with getattr(calibrate_vocoder, fault)():
            result = _execute(man, run, root)
    checks = result["checks"]
    if fault is None:
        assert result["correct"], checks
        assert set(result["metrics"]) == {"gen_samples_per_s", "setup_s"}
        assert result["attempted"] >= 1 and result["failed"] == 0
    else:
        assert not result["correct"], checks
        assert max(c["value"] / c["limit"] for c in checks.values()) > 5, checks


def test_the_traced_vocoder_cell_reads_its_layers(tmp_path):
    man, run, root = _tiny_run(tmp_path, trace=True)
    before = tfc.generate_fused_reference.launches
    result = _execute(man, run, root)
    assert tfc.generate_fused_reference.launches > before
    got = result["metrics"]
    # on the CPU: no device kernels (no roofline, no idle share), no card
    # (no peak), and the plain sampler streams nothing
    assert {"prime_ms.batch", "sampler_streamed_mb.mol"} <= set(got)
    assert got["sampler_streamed_mb.mol"]["value"] == 0.0
    assert result["correct"], result["checks"]


def test_the_control_reads_far_above_the_program(tmp_path):
    from benchmark.loops import reconstruct, vocode_mol

    man, run, root = _tiny_run(tmp_path)
    prog = vocode_mol.setup(run)
    tr = run.traffic
    done = [reconstruct.request(prog, tr, run.seed, i, [0, 1, 2]) for i in range(2)]
    sound = vocode_mol.reference_gaps(run, prog.weights, done, prog.wav, torch.device("cpu"))
    ctl = calibrate_vocoder.control_gaps(run, prog.weights, done, prog.wav,
                                         torch.device("cpu"))
    assert ctl["value_gap"] > 10 * sound["value_gap"], (sound, ctl)
    assert ctl["value_gap"] > json.loads(
        (root / "benchmark/limits/tiny.mol.json").read_text())["value_gap"]
