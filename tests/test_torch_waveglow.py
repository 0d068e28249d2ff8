"""WaveGlow (``models/waveglow.py``) and K1b's three-tap mode's plain version
on the CPU at tiny widths, against the benchmark's plain float32 reference
(``benchmark/reference/waveglow.py``) on its seeded weights."""

import json

import pytest
import torch

from ae_wavenet_tpu_torch.models import registry, waveglow
from ae_wavenet_tpu_torch.ops import gated, gated_cuda
from ae_wavenet_tpu_torch.utils import config as tcfg
from benchmark import weights, weights_waveglow
from benchmark.reference import waveglow as ref_glow

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(**flow) -> tcfg.RunConfig:
    """4 flows of 3 layers of 24 channels, 8 mel bands, a hop of 16."""
    return tcfg.RunConfig(
        model_kind="waveglow",
        spec=tcfg.SpecConfig(sample_rate=22050, win_sz=64, hop_sz=16, n_fft=64, n_mels=8,
                             n_mfcc=0, mel_fmin=0.0, mel_fmax=8000.0),
        wavenet=tcfg.WaveNetConfig(n_blocks=1, n_block_layers=3, filter_sz=3, n_res=24,
                                   n_dil=16, n_skp=24, n_lc_in=8, n_lc_out=8,
                                   lc_upsample_strides=(16,), lc_upsample_filters=(64,),
                                   n_global_embed=0, n_speakers=1),
        flow=tcfg.FlowConfig(**{"n_flows": 4, "n_early_every": 2, **flow}))


@pytest.fixture(scope="module")
def glow():
    """(config, program model, reference model, reference widths) on one
    set of seeded weights."""
    cfg = tiny_config()
    model = waveglow.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    w = weights_waveglow.make(model, 3, "cpu")
    weights.load(model, w)
    g = ref_glow.from_json(tcfg.to_json(cfg))
    return cfg, model, ref_glow.build(g, w, "cpu"), g


def _mel(g, frames=6, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(2, g.n_mels, frames, generator=gen) * 3 - 5


# ------------------------------------------------------------ the kernel's plain version
def _layer_operands(r=16, d=8, s=24, p=40, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, sd=1.0):
        return torch.randn(*shape, generator=gen) * sd

    conv_w = rnd(2 * d, r, 3, sd=(3 * r) ** -0.5)  # conv1d's layout, as WaveGlow's in-layer
    return {"x": rnd(2, p, r).to(BF16), "skip": rnd(2, p, s), "conv_w": conv_w,
            "w_in": conv_w.permute(2, 1, 0).reshape(3 * r, 2 * d), "b_in": rnd(2 * d, sd=0.3),
            "w_out": rnd(d, r + s, sd=d ** -0.5), "b_out": rnd(r + s, sd=0.3),
            "addend": rnd(2, p, 2 * d).to(BF16)}


@pytest.mark.parametrize("dd", [1, 4, 16])
@pytest.mark.parametrize("with_addend", [False, True])
def test_three_tap_plain_layer_against_the_reference_conv(dd, with_addend):
    """``gated_layer_fused_reference`` with cond None against WaveGlow's
    ``conv1d(padding=d, dilation=d)`` layer on the same bf16-rounded
    operands, every row (the first and last dd among them, where a tap
    reads the zero padding); the addend joins y before the gate."""
    o = _layer_operands()
    add = o["addend"] if with_addend else None
    x_new, skip = gated.gated_layer_fused_reference(
        o["x"], None, o["skip"].clone(), o["w_in"], o["b_in"], o["w_out"], o["b_out"],
        dd=dd, r0=0, addend=add)
    r, d = o["x"].shape[-1], o["w_out"].shape[0]
    xc = o["x"].float().transpose(1, 2)
    w = o["conv_w"].to(BF16).float()
    y = ref_glow._conv(xc, w, o["b_in"], ref_glow.exact, padding=dd, dilation=dd)
    if with_addend:
        y = y + add.float().transpose(1, 2)
    h = (torch.tanh(y[:, :d]) * torch.sigmoid(y[:, d:])).to(BF16).float()
    out = ref_glow._conv(h, o["w_out"].to(BF16).float().t(), o["b_out"], ref_glow.exact)
    want_x = (xc + out[:, :r].to(BF16).float()).to(BF16).transpose(1, 2)
    want_skip = o["skip"] + out[:, r:].transpose(1, 2)
    p = o["x"].shape[1]
    for rows in (slice(0, dd), slice(dd, p - dd), slice(p - dd, p)):
        assert torch.equal(x_new[:, rows], want_x[:, rows]) or float(
            (x_new[:, rows].float() - want_x[:, rows].float()).abs().max()) <= 2 ** -6
        torch.testing.assert_close(skip[:, rows], want_skip[:, rows], rtol=1e-4, atol=1e-4)


def test_three_tap_mode_refuses_what_it_cannot_take():
    o = _layer_operands()
    with pytest.raises(ValueError, match="every row"):
        gated.gated_layer_fused_reference(o["x"], None, o["skip"], o["w_in"], o["b_in"],
                                          o["w_out"], o["b_out"], dd=1, r0=2)
    with pytest.raises(ValueError, match="three-tap"):
        gated.gated_layer_fused_reference(o["x"], o["x"], o["skip"], o["w_in"], o["b_in"],
                                          o["w_out"], o["b_out"], dd=1, r0=0,
                                          addend=o["addend"])


def test_wrapper_counts_its_taps_on_the_cpu():
    o = _layer_operands()
    gated_cuda.gated_layer_fused(o["x"], None, o["skip"].clone(), o["w_in"], o["b_in"],
                                 o["w_out"], o["b_out"], dd=2, r0=0, addend=o["addend"])
    assert gated_cuda.gated_layer_fused.taps == 3


# --------------------------------------------------------------------- the model
def test_invertible_convolutions_are_orthogonal_with_determinant_one(glow):
    cfg, model, _, _ = glow
    assert [fl.W.shape[0] for fl in model.flows] == waveglow.flow_channels(cfg) == [8, 8, 6, 6]
    for fl in model.flows:
        w = fl.W.detach().double()
        torch.testing.assert_close(w @ w.t(), torch.eye(w.shape[0], dtype=torch.float64),
                                   rtol=0, atol=1e-6)
        assert abs(float(torch.det(w)) - 1.0) < 1e-6
    fresh = waveglow.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert all(abs(float(torch.det(fl.W.detach().double())) - 1.0) < 1e-6 for fl in fresh.flows)


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("part", ["wn", "flow", "inverse"])
def test_model_against_the_reference(glow, part):
    """One WN in float32 (the training direction's) against the reference;
    one flow's inverse step and the whole inverse on the served path (bf16
    upsampler, cond projection and three-tap layers) within bf16's reach
    of it."""
    cfg, model, ref, g = glow
    mel = _mel(g)
    c = waveglow.upsample(model, cfg, mel)
    cr = ref_glow.upsample(ref, g, mel)
    torch.testing.assert_close(c, cr.transpose(1, 2), rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(2)
    z = torch.randn(2, g.n_group, c.shape[1], generator=gen) * g.sigma
    with torch.no_grad():
        if part == "wn":
            a0 = z[:, :4]
            got = waveglow.wn_plain(cfg, model.flows[0], a0.transpose(1, 2), c)
            want = ref_glow.wn(ref.flows[0], g, a0, cr)
            torch.testing.assert_close(got, want.transpose(1, 2), rtol=1e-4, atol=1e-5)
        elif part == "flow":
            k, half = 3, 3
            out = ref_glow.wn(ref.flows[k], g, z[:, :half], cr)
            a1 = (z[:, half:6] - out[:, :half]) / torch.exp(out[:, half:])
            want = ref_glow.inverse_1x1(ref.flows[k], torch.cat([z[:, :half], a1], 1))
            got = waveglow.inverse_step(cfg, waveglow.pack(model)[k], z[:, :6].transpose(1, 2),
                                        waveglow.upsample(model, cfg, mel, BF16))
            assert _rel(got, want.transpose(1, 2)) < 1e-2
        else:
            want = ref_glow.infer(ref, g, mel, z)
            served = waveglow.infer(cfg, waveglow.upsample(model, cfg, mel, BF16), z,
                                    waveglow.pack(model))
            assert _rel(served, want) < 2e-2


@pytest.mark.parametrize("k", range(4))
def test_served_wn_of_each_flow_against_the_reference(glow, k):
    """Each flow's served WN (``wn_fused``: the bf16 cond GEMM and K1b's
    three-tap layers) gives the reference's b and log s within bf16's
    reach, each on its own: the waveform alone would hide a WN error under
    the noise that passes the coupling untouched."""
    cfg, model, ref, g = glow
    mel = _mel(g, seed=7)
    half = waveglow.flow_channels(cfg)[k] // 2
    a0 = torch.randn(2, half, mel.shape[-1] * g.hop // g.n_group,
                     generator=torch.Generator().manual_seed(8)) * g.sigma
    with torch.no_grad():
        want = ref_glow.wn(ref.flows[k], g, a0, ref_glow.upsample(ref, g, mel)).transpose(1, 2)
        got = waveglow.wn_fused(cfg, waveglow.pack(model)[k], a0.transpose(1, 2),
                                waveglow.upsample(model, cfg, mel, BF16))
    assert _rel(got[..., :half], want[..., :half]) < 2e-2
    assert _rel(got[..., half:], want[..., half:]) < 2e-2


def test_forward_of_the_inverse_gives_back_the_noise(glow):
    """The program's float32 forward of the reference's inverse gives back
    the noise."""
    cfg, model, ref, g = glow
    mel = _mel(g, seed=5)
    c = waveglow.upsample(model, cfg, mel)
    z = waveglow.noise(cfg, 2, c.shape[1], torch.Generator().manual_seed(6), "cpu")
    with torch.no_grad():
        audio = ref_glow.infer(ref, g, mel, z)
        back, log_s, log_det = waveglow.forward(model, cfg, audio, c)
    torch.testing.assert_close(back, z, rtol=1e-4, atol=1e-5)
    assert len(log_s) == len(log_det) == cfg.flow.n_flows
    assert all(abs(float(v)) < 1e-2 for v in log_det)  # det W = 1
    assert max(float(v.abs().max()) for v in log_s) < 1.0


def test_vocode_serves_int16_and_counts(glow):
    cfg, model, _, g = glow
    mel = _mel(g, frames=5)
    flows, positions = waveglow.flows, waveglow.positions
    out = registry.get("waveglow").vocode(model, cfg, mel, torch.Generator().manual_seed(0))
    assert out.dtype == torch.int16 and out.shape == (2, 5 * 16)
    assert waveglow.flows == flows + 4 and waveglow.positions == positions + 2 * 10
    wav = torch.randint(-3000, 3000, (1, 64 + 16 * 7), dtype=torch.int16)
    got, start = waveglow.reconstruct(model, cfg, wav, None, torch.Generator().manual_seed(1))
    assert got.shape == (1, 8 * 16) and start == 24


def test_json_round_trip_of_the_new_keys():
    cfg = tiny_config(sigma=0.5)
    doc = json.loads(tcfg.to_json(cfg))
    assert doc["flow"] == {"n_early_every": 2, "n_flows": 4, "sigma": 0.5}
    assert tcfg.from_json(tcfg.to_json(cfg)) == cfg
    assert "flow" not in json.loads(tcfg.to_json(tcfg.RunConfig()))


def test_training_is_refused_until_the_three_tap_backward_exists(glow):
    cfg, model, _, _ = glow
    fam = registry.get("waveglow")
    with pytest.raises(NotImplementedError, match="backward"):
        fam.loss_fn(model, cfg, None, None, None)
    with pytest.raises(NotImplementedError, match="backward"):
        fam.make_window_spec(cfg)


def test_generate_cli_vocodes_a_waveglow_export(glow, tmp_path, capsys):
    """``cli/generate.py`` on a WaveGlow export file writes the clip's
    16-bit samples at the configuration's rate, one hop a frame."""
    from ae_wavenet_tpu_torch.cli import generate
    from ae_wavenet_tpu_torch.data.preprocess import make_synthetic_dataset
    from ae_wavenet_tpu_torch.training.weights import save_export
    from ae_wavenet_tpu_torch.utils.wavio import read_wav

    cfg, model, _, _ = glow
    path = str(tmp_path / "glow.pt")
    save_export(path, model, cfg, 7)
    data = str(tmp_path / "synth")
    make_synthetic_dataset(data, n_clips=1, n_speakers=1, clip_len=(300, 301), seed=0)
    out = str(tmp_path / "out.wav")
    assert generate.main(["--ckpt", path, "--data", data, "--device", "cpu",
                          "--n-samples", "100000", "--out", out]) == 0
    wav, sr = read_wav(out)
    frames = (300 - 64) // 16 + 1
    assert sr == 22050 and wav.shape == (frames * 16,)
    assert "loaded step 7 (waveglow" in capsys.readouterr().out
