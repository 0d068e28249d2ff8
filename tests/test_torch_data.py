"""The port's packed datasets and wav files read and write the reference's
formats, both ways."""

import numpy as np

from ae_wavenet_tpu.data import dataset as jds
from ae_wavenet_tpu.data.preprocess import make_synthetic_dataset as jax_synth
from ae_wavenet_tpu.utils import wavio as jwav
from ae_wavenet_tpu_torch.data import dataset as tds
from ae_wavenet_tpu_torch.utils import wavio as twav


def _same_dataset(a, b):
    assert (a.sample_rate, a.n_speakers, len(a)) == (b.sample_rate, b.n_speakers, len(b))
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.speakers, b.speakers)
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))


def test_reads_the_reference_dataset(tmp_path):
    prefix = str(tmp_path / "ref")
    jax_synth(prefix, n_clips=3, n_speakers=2, clip_len=(900, 1200), seed=4)
    ref, port = jds.PackedDataset(prefix), tds.PackedDataset(prefix)
    _same_dataset(ref, port)
    o, n = int(ref.offsets[2]), int(ref.lengths[2])
    np.testing.assert_array_equal(port.clip(2), ref.data[o : o + n])
    np.testing.assert_array_equal(port.clip(2, 100), ref.data[o : o + 100])


def test_reference_reads_the_port_dataset(tmp_path):
    prefix = str(tmp_path / "port")
    index = tds.make_synthetic_dataset(prefix, n_clips=5, n_speakers=3,
                                       clip_len=(1500, 2500), seed=1)
    port, ref = tds.PackedDataset(prefix), jds.PackedDataset(prefix)
    _same_dataset(ref, port)
    assert index["speakers"] == ["synth0", "synth1", "synth2"]
    np.testing.assert_array_equal(port.speakers, [0, 1, 2, 0, 1])
    assert ((port.lengths >= 1500) & (port.lengths < 2500)).all()
    peak = np.abs(np.asarray(port.data, np.int32))
    assert peak.max() == 12000 and np.count_nonzero(peak > 100) > len(peak) // 4
    again = str(tmp_path / "again")
    tds.make_synthetic_dataset(again, n_clips=5, n_speakers=3, clip_len=(1500, 2500),
                               seed=1)
    _same_dataset(tds.PackedDataset(again), port)


def test_wav_files_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, size=501)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    twav.write_wav(a, x, 8000)
    jwav.write_wav(b, x, 8000)
    ya, sra = jwav.read_wav(a)
    yb, srb = twav.read_wav(b)
    assert sra == srb == 8000
    np.testing.assert_array_equal(ya, yb)
    assert ya.dtype == np.int16 and ya.max() == 32767 and ya.min() == -32768
    i16 = rng.integers(-32768, 32768, size=64).astype(np.int16)
    twav.write_wav(a, i16)
    np.testing.assert_array_equal(twav.read_wav(a)[0], i16)
