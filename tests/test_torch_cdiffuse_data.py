"""The port's standalone-CDiffuSE host data (speech_enhancement_tpu_torch/
data/preprocess.py, data/numpy_dataset.py, cli/preprocess.py and the host
conditioners of cli/cdiffuse_inference.py) against the JAX package's, on
the CPU:

* ``make_spectrum`` (every feature type and normalization, a silent
  input, odd lengths), ``mel_transform``, ``_se_conditioner`` and
  ``_mel_conditioner`` equal the JAX functions within 1e-12 at float64;
* ``preprocess_dir`` and ``cli.preprocess`` (``--se``, ``--voc``) write the
  JAX package's files, float32 bit for bit;
* ``NumpyDataset``, ``SpecCollator`` and ``from_path`` give the JAX
  records and batches bit for bit on the same seed, at 1 and 2 workers and
  over two epochs; records shorter than the crop are dropped alike;
* ``DataLoader.iterate(start)`` gives a whole epoch's batches from
  ``start`` on.
"""

import numpy as np
import pytest

from speech_enhancement_tpu.cli.cdiffuse_inference import _mel_conditioner as jax_mel_conditioner
from speech_enhancement_tpu.cli.cdiffuse_inference import _se_conditioner as jax_se_conditioner
from speech_enhancement_tpu.data import NumpyDataset as JaxNumpyDataset
from speech_enhancement_tpu.data import SpecCollator as JaxSpecCollator
from speech_enhancement_tpu.data import from_path as jax_from_path
from speech_enhancement_tpu.data import preprocess as jax_preprocess
from speech_enhancement_tpu_torch.cli import preprocess as preprocess_cli
from speech_enhancement_tpu_torch.cli.cdiffuse_inference import _mel_conditioner, _se_conditioner
from speech_enhancement_tpu_torch.data import (
    NumpyDataset,
    SpecBatch,
    SpecCollator,
    from_path,
    preprocess,
    save_wav,
)

TIGHT = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def wav_dirs(tmp_path_factory):
    """Four pairs of tone-plus-noise wavs of 0.4-1.3 s (odd lengths; the
    shortest is under the dataset tests' crop)."""
    root = tmp_path_factory.mktemp("cdiffuse_data")
    clean_dir, noisy_dir = root / "clean", root / "noisy"
    clean_dir.mkdir()
    noisy_dir.mkdir()
    rng = np.random.default_rng(0)
    for i, length in enumerate((16037, 20011, 6403, 12345)):
        t = np.arange(length) / 16000
        clean = (0.4 * np.sin(2 * np.pi * (200 + 30 * i) * t)).astype(np.float32)
        noisy = clean + 0.05 * rng.standard_normal(length).astype(np.float32)
        save_wav(clean_dir / f"p{i}.wav", clean)
        save_wav(noisy_dir / f"p{i}.wav", noisy)
    return root


def signal(length, seed=1, scale=0.3):
    return scale * np.random.default_rng(seed).standard_normal(length)


@pytest.mark.parametrize("length", [16037, 4000, 401])
@pytest.mark.parametrize("feature_type, mode", [("logmag", None), ("lps", None),
                                                ("mag", None), ("logmag", "mean_std"),
                                                ("logmag", "minmax")])
def test_make_spectrum_equals_jax(length, feature_type, mode):
    y = signal(length)
    kw = dict(y=y, feature_type=feature_type, mode=mode, frame_length=400, shift=100,
              _max=3.0, _min=-1.0)
    got, want = preprocess.make_spectrum(**kw), jax_preprocess.make_spectrum(**kw)
    assert got[0].shape == (201, 1 + length // 100) and got[2] == want[2] == length
    np.testing.assert_allclose(got[0], want[0], **TIGHT)
    np.testing.assert_allclose(got[1], want[1], **TIGHT)


def test_make_spectrum_silent_input_equals_jax():
    y = np.zeros(4000)
    got, want = preprocess.make_spectrum(y=y), jax_preprocess.make_spectrum(y=y)
    assert np.isfinite(got[0]).all() and np.all(got[0] == 0.0)
    np.testing.assert_array_equal(got[0], want[0])


def test_make_spectrum_window_is_symmetric_hamming():
    """An impulse at sample 0 sits at window index n / 2 - hop of frame 1,
    so every bin of that frame's magnitude is the window's value there: the
    symmetric Hamming's, 1.8e-3 from the periodic one's."""
    n, hop = 400, 100
    mag, _, _ = preprocess.make_spectrum(y=np.eye(1, 2000, 0)[0], feature_type="mag",
                                         frame_length=n, shift=hop)
    ours = mag[:, 1]
    k = n // 2 - hop
    symmetric = 0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))
    np.testing.assert_allclose(ours, symmetric, rtol=1e-12)
    assert abs(symmetric - (0.54 - 0.46 * np.cos(2 * np.pi * k / n))) > 1e-3


@pytest.mark.parametrize("length, n_mels", [(16037, 80), (8000, 40)])
def test_mel_transform_equals_jax(length, n_mels):
    y = signal(length, seed=2)
    got = preprocess.mel_transform(y, n_mels=n_mels)
    want = jax_preprocess.mel_transform(y, n_mels=n_mels)
    assert got.shape[0] == n_mels and (got >= 0).all() and (got <= 1).all()
    np.testing.assert_allclose(got, want, **TIGHT)
    np.testing.assert_allclose(preprocess._mel_filterbank(16000, 512, 64, 20.0, 8000.0),
                               jax_preprocess._mel_filterbank(16000, 512, 64, 20.0, 8000.0),
                               **TIGHT)


@pytest.mark.parametrize("length", [16037, 3000])
@pytest.mark.parametrize("n_fft, hop", [(400, 100), (512, 256), (158, 256)])
def test_se_conditioner_equals_jax(length, n_fft, hop):
    y = signal(length, seed=3).astype(np.float32)
    got, want = _se_conditioner(y, n_fft, hop), jax_se_conditioner(y, n_fft, hop)
    assert got.shape == (1, 1 + length // hop, n_fft // 2 + 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # both float32 casts of equal float64
    sxx, _, _ = preprocess.make_spectrum(y=y.astype(np.float64), frame_length=n_fft,
                                         shift=hop)
    want64, _, _ = jax_preprocess.make_spectrum(y=y.astype(np.float64), frame_length=n_fft,
                                                shift=hop)
    np.testing.assert_allclose(sxx, want64, **TIGHT)


@pytest.mark.parametrize("length", [16037, 3000])
@pytest.mark.parametrize("hop, n_mels", [(100, 80), (256, 80), (100, 201)])
def test_mel_conditioner_equals_jax(length, hop, n_mels):
    y = signal(length, seed=4).astype(np.float32)
    got, want = _mel_conditioner(y, 400, hop, n_mels), jax_mel_conditioner(y, 400, hop, n_mels)
    assert got.shape == (1, 1 + length // hop, n_mels) and (got >= 0).all() and (got <= 1).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("se", [True, False])
def test_preprocess_dir_writes_the_jax_files(wav_dirs, tmp_path, se):
    indir = str(wav_dirs / "noisy")
    got = preprocess.preprocess_dir(indir, str(tmp_path / "port"), se=se, max_workers=2)
    want = jax_preprocess.preprocess_dir(indir, str(tmp_path / "jax"), se=se, max_workers=2)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == [
        f"p{i}.wav.spec.npy" for i in range(4)]
    for g, w in zip(got, want):
        a, b = np.load(g), np.load(w)
        assert a.dtype == np.float32 and a.shape[0] == (201 if se else 80)
        np.testing.assert_array_equal(a, b)


def test_preprocess_cli(wav_dirs, tmp_path, capsys):
    files = preprocess_cli.main([str(wav_dirs / "clean"), str(tmp_path / "se"), "--workers", "1"])
    assert len(files) == 4 and "wrote 4 spectrogram files" in capsys.readouterr().out
    spec = np.load(files[0])
    want, _, _ = preprocess.make_spectrum(str(wav_dirs / "clean" / "p0.wav"))
    assert spec.shape == (201, 1 + 16037 // 160) and np.isfinite(spec).all()
    np.testing.assert_array_equal(spec, want.astype(np.float32))
    voc = preprocess_cli.main([str(wav_dirs / "clean"), str(tmp_path / "voc"), "--voc",
                               "--workers", "1"])
    assert np.load(voc[0]).shape[0] == 80


@pytest.fixture(scope="module")
def spec_dirs(wav_dirs):
    """SE spectrograms at hop 100 (the dataset's framing) of the noisy wavs."""
    out = wav_dirs / "specs"
    out.mkdir()
    for path in sorted((wav_dirs / "noisy").glob("*.wav")):
        sxx, _, _ = preprocess.make_spectrum(str(path), frame_length=400, shift=100)
        np.save(out / f"{path.name}.spec.npy", sxx.astype(np.float32))
    return str(wav_dirs / "clean"), str(wav_dirs / "noisy"), str(out)


def test_numpy_dataset_records_equal_jax(spec_dirs):
    clean, noisy, specs = spec_dirs
    got, want = NumpyDataset(clean, noisy, [specs]), JaxNumpyDataset(clean, noisy, [specs])
    assert len(got) == len(want) == 4
    for i in range(4):
        a, b = got[i], want[i]
        assert set(a) == set(b) == {"audio", "noisy", "spectrogram"}
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
        assert a["spectrogram"].shape[1] == 201


def test_spec_collator_equals_jax(spec_dirs):
    """An aligned crop (frame f to audio samples f * hop) and the short
    record dropped; an all-short batch is empty."""
    clean, noisy, specs = spec_dirs
    ds = NumpyDataset(clean, noisy, [specs])
    records = [ds[i] for i in range(4)]
    got = SpecCollator(100, 80, np.random.default_rng(5)).collate(records)
    want = JaxSpecCollator(100, 80, np.random.default_rng(5)).collate(records)
    assert isinstance(got, SpecBatch) and got.audio.shape == (3, 8000)
    assert got.spectrogram.shape == (3, 80, 201)
    for field in SpecBatch._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    start = next(s for s in range(len(records[0]["spectrogram"]))
                 if np.array_equal(records[0]["spectrogram"][s], got.spectrogram[0, 0]))
    np.testing.assert_array_equal(got.audio[0], records[0]["audio"][start * 100:start * 100 + 8000])
    empty = SpecCollator(100, 300).collate(records[2:3])
    assert empty.audio.shape == (0, 30000) and empty.spectrogram.shape == (0, 300, 201)


@pytest.mark.parametrize("num_workers", [1, 2])
def test_from_path_batches_equal_jax(spec_dirs, num_workers):
    clean, noisy, specs = spec_dirs
    kw = dict(batch_size=2, crop_frames=60, seed=3, num_workers=num_workers)
    got_loader, want_loader = from_path(clean, noisy, [specs], **kw), jax_from_path(
        clean, noisy, [specs], **kw)
    for epoch in (0, 1):
        got_loader.set_epoch(epoch)
        want_loader.set_epoch(epoch)
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for field in SpecBatch._fields:
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        # entering the epoch at batch 1 gives its batch 1, loading nothing before it
        (tail,) = list(got_loader.iterate(1))
        np.testing.assert_array_equal(tail.audio, got[1].audio)
