"""The port's preprocessing (``data/preprocess.py``, ``cli/preprocess.py``)
against the JAX package's, on the CPU.

Decoded clips must be equal sample for sample, and the packed datasets
(the reference's v2 and v3 synthetic fixtures, a catalog's output) equal
byte for byte.  The dataset frame statistics come from the port's torch
MFCC in float32 frames summed in float64, the reference's from its numpy
MFCC: within relative 1e-4.
"""

import dataclasses
import filecmp
import io
import json
import wave

import numpy as np
import pytest

from ae_wavenet_tpu.cli import preprocess as jcli
from ae_wavenet_tpu.data import preprocess as jpre
from ae_wavenet_tpu.utils import config as jcfg
from ae_wavenet_tpu_torch.cli import preprocess as tcli
from ae_wavenet_tpu_torch.data import preprocess as tpre
from ae_wavenet_tpu_torch.training import chassis as tch
from ae_wavenet_tpu_torch.training import checkpoint as tckpt
from ae_wavenet_tpu_torch.utils import config as tcfg


def _write_wav(path, x, sr, channels=1, width=2):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(np.ascontiguousarray(x).tobytes())
    return str(path)


def _tone(sr, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (8000 * np.sin(2 * np.pi * 220 * t) + 500 * rng.normal(size=n)).astype("<i2")


def _same_files(a, b):
    return all(filecmp.cmp(a + ext, b + ext, shallow=False) for ext in (".dat", ".json"))


@pytest.mark.parametrize("sr", [16000, 8000, 22050, 44100])
def test_load_clip_matches_jax(tmp_path, sr):
    """At 16 kHz the samples as written; from 8, 22.05 and 44.1 kHz the
    reference's resampling, sample for sample."""
    x = _tone(sr, sr // 2)
    path = _write_wav(tmp_path / f"a{sr}.wav", x, sr)
    got, want = tpre.load_clip(path), jpre.load_clip(path)
    assert got.dtype == np.int16 and np.array_equal(got, want)
    if sr == 16000:
        assert np.array_equal(got, x)
    else:
        assert abs(len(got) - 8000) <= 1


def test_load_clip_downmixes_stereo_and_refuses_8_bit(tmp_path):
    left, right = _tone(16000, 4000, 1), _tone(16000, 4000, 2)
    path = _write_wav(tmp_path / "st.wav", np.stack([left, right], 1), 16000, channels=2)
    got = tpre.load_clip(path)
    assert np.array_equal(got, jpre.load_clip(path))
    assert np.array_equal(got, ((left.astype(np.float64) + right) / 2).astype(np.int16))
    path8 = _write_wav(tmp_path / "u8.wav", np.full(100, 128, np.uint8), 16000, width=1)
    with pytest.raises(ValueError, match="only 16-bit PCM"):
        tpre.load_clip(path8)


def test_preprocess_catalog_is_byte_identical(tmp_path):
    rates = {"bob": [16000, 22050], "amy": [8000]}
    lines = ["# speaker path", ""]
    for spk, srs in rates.items():
        for i, sr in enumerate(srs):
            p = _write_wav(tmp_path / f"{spk}{i}.wav", _tone(sr, sr // 3, i), sr)
            lines.append(f"{spk} {p}")
    cat = tmp_path / "cat.txt"
    cat.write_text("\n".join(lines) + "\n")
    idx = tpre.preprocess_catalog(str(cat), str(tmp_path / "t"))
    jpre.preprocess_catalog(str(cat), str(tmp_path / "j"))
    assert _same_files(str(tmp_path / "t"), str(tmp_path / "j"))
    assert idx["speakers"] == ["amy", "bob"]
    assert [c["speaker"] for c in idx["clips"]] == [1, 1, 0]


@pytest.mark.parametrize("style", ["v2", "v3"])
def test_synthetic_fixture_is_byte_identical(tmp_path, style):
    kw = dict(n_clips=3, n_speakers=2, clip_len=(5000, 12000), seed=4, style=style)
    idx = tpre.make_synthetic_dataset(str(tmp_path / "t"), **kw)
    jpre.make_synthetic_dataset(str(tmp_path / "j"), **kw)
    assert _same_files(str(tmp_path / "t"), str(tmp_path / "j"))
    assert idx["fixture_version"] == {"v2": 2, "v3": 31}[style]
    assert tpre.synthetic_fixture_current(str(tmp_path / "t"), style)
    assert not tpre.synthetic_fixture_current(str(tmp_path / "t"),
                                              {"v2": "v3", "v3": "v2"}[style])
    assert not tpre.synthetic_fixture_current(str(tmp_path / "missing"), style)


def test_dataset_frame_stats_match_jax(tmp_path):
    prefix = str(tmp_path / "d")
    # one clip too short for a frame, which both skip
    tpre.make_synthetic_dataset(prefix, n_clips=4, n_speakers=2,
                                clip_len=(300, 9000), seed=5)
    spec = jcfg.RunConfig().spec
    mt, vt = tpre.dataset_frame_stats(prefix, tcfg.SpecConfig())
    mj, vj = jpre.dataset_frame_stats(prefix, spec)
    assert len(mt) == len(vt) == 39
    np.testing.assert_allclose(mt, mj, rtol=1e-4)
    np.testing.assert_allclose(vt, vj, rtol=1e-4)


def test_cli_in_both_modes_matches_jax(tmp_path, capsys):
    """``--synthetic`` and catalog mode: the same files and the same
    summary line as the reference's CLI."""
    argv = ["--synthetic", "--n-clips", "3", "--n-speakers", "2", "--seed", "1"]
    assert tcli.main([*argv, str(tmp_path / "t")]) == 0
    assert jcli.main([*argv, str(tmp_path / "j")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(tmp_path / "t"), "P") == out[1].replace(
        str(tmp_path / "j"), "P")
    assert out[0].startswith(f"wrote {tmp_path / 't'}.dat: 3 clips, 2 speakers, ")
    assert _same_files(str(tmp_path / "t"), str(tmp_path / "j"))
    p = _write_wav(tmp_path / "c.wav", _tone(16000, 3000), 16000)
    (tmp_path / "cat.txt").write_text(f"s1 {p}\n")
    assert tcli.main([str(tmp_path / "cat.txt"), str(tmp_path / "c")]) == 0
    assert capsys.readouterr().out == (
        f"wrote {tmp_path / 'c'}.dat: 1 clips, 1 speakers, 3000 samples (0.2s)\n")
    with pytest.raises(SystemExit):
        tcli.main([str(tmp_path / "only_prefix")])


def test_chassis_with_dataset_norm_bakes_the_statistics_in(tmp_path):
    """``spec.norm="dataset"`` without statistics: the chassis computes them
    once, trains on them, and every checkpoint's config carries them."""
    prefix = str(tmp_path / "d")
    tpre.make_synthetic_dataset(prefix, n_clips=4, n_speakers=2,
                                clip_len=(9000, 12000), seed=6)
    base = tcfg.tiny_config()
    cfg = dataclasses.replace(base, spec=dataclasses.replace(base.spec, norm="dataset"))
    ch = tch.Chassis(cfg, prefix, ckpt_dir=str(tmp_path / "ck"), device="cpu",
                     log_stream=io.StringIO())
    mean, var = tpre.dataset_frame_stats(prefix, base.spec)
    assert (ch.cfg.spec.stats_mean, ch.cfg.spec.stats_var) == (mean, var)
    hist = ch.train(2)
    assert all(np.isfinite(h["loss"]) for h in hist)
    ch.save()
    saved = tckpt.load_config(str(tmp_path / "ck"), 2)[1]
    assert saved.spec.norm == "dataset" and saved.spec.stats_mean == mean
    assert json.loads(tcfg.to_json(saved))["spec"]["stats_var"] == list(var)
