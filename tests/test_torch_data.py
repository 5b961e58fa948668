"""The port's host data pipeline (speech_enhancement_tpu_torch/data) against
the JAX package's, on the CPU, after tests/test_data_config.py's cases.

* ``Collator`` and ``DataLoader`` give the JAX ones' batches bit for bit
  (``audio``, ``noisy``, ``pesq_clean``, ``pesq_noisy``): for a seed and
  epoch, at 1 and 3 workers, for each of 2 shards, with random dataset
  crops, and through the silent-crop retry.  Both PESQ engines are built
  from one C++ source with the same flags.
* ``load_wav`` / ``save_wav`` round-trip and resample as the JAX ones do.
* Shards have equal batch counts, and a worker's exception reaches the
  caller.
"""

import numpy as np
import pytest

from speech_enhancement_tpu.data import Collator as JaxCollator
from speech_enhancement_tpu.data import DataLoader as JaxDataLoader
from speech_enhancement_tpu.data import VoicebankDataset as JaxVoicebankDataset
from speech_enhancement_tpu.data import load_wav as jax_load_wav
from speech_enhancement_tpu.data import save_wav as jax_save_wav
from speech_enhancement_tpu_torch.data import (
    Collator,
    DataLoader,
    VoicebankDataset,
    load_wav,
    save_wav,
)


@pytest.fixture(scope="module")
def wav_dirs(tmp_path_factory):
    """Six pairs of 1.5 s tone-plus-noise wavs; pair 2 is silent for its
    first second, so that random crops there can be silent."""
    root = tmp_path_factory.mktemp("vb_port")
    clean_dir, noisy_dir = root / "clean", root / "noisy"
    clean_dir.mkdir()
    noisy_dir.mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(24000) / 16000
    for i in range(6):
        clean = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)).astype(np.float32)
        clean *= 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)
        noisy = clean + 0.05 * rng.standard_normal(len(t)).astype(np.float32)
        if i == 2:
            clean[:16000] = 0.0
            noisy[:16000] = 0.0
        save_wav(clean_dir / f"p{i:03d}.wav", clean)
        save_wav(noisy_dir / f"p{i:03d}.wav", noisy)
    return str(clean_dir), str(noisy_dir)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for field in ("audio", "noisy", "pesq_clean", "pesq_noisy"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None), field
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), field


@pytest.mark.parametrize("num_workers", [1, 3])
@pytest.mark.parametrize("shard_id", [0, 1])
@pytest.mark.parametrize("epoch", [0, 3])
def test_loader_batches_equal_jax(wav_dirs, num_workers, shard_id, epoch):
    clean_dir, noisy_dir = wav_dirs

    def run(ds_cls, col_cls, dl_cls):
        # dataset-level random crop (24000 -> 20000) and collator recrop
        # (-> 16000) both draw from the per-batch generator
        ds = ds_cls(clean_dir, noisy_dir, crop_frames=200, random_crop=True)
        col = col_cls(100, 160, rng=np.random.default_rng(5), precompute_labels=True)
        dl = dl_cls(ds, 2, col, shuffle=True, seed=7, shard_id=shard_id, num_shards=2,
                    num_workers=num_workers, drop_last=False)
        dl.set_epoch(epoch)
        return list(dl)

    _assert_batches_equal(run(VoicebankDataset, Collator, DataLoader),
                          run(JaxVoicebankDataset, JaxCollator, JaxDataLoader))


@pytest.mark.parametrize("silence_check", [True, False])
def test_collator_equals_jax_with_silent_crop_retry(wav_dirs, silence_check):
    """Record 2 is silent for 16000 of its 24000 samples: the 16000-sample
    crops retry until they reach the tone (or keep the last), and a fully
    silent record is dropped."""
    clean_dir, noisy_dir = wav_dirs
    ds, jds = VoicebankDataset(clean_dir, noisy_dir), JaxVoicebankDataset(clean_dir, noisy_dir)
    silent = {"audio": np.zeros(20000, np.float32), "noisy": np.zeros(20000, np.float32)}
    short = {k: v[:5000] for k, v in ds[0].items()}  # tiled up to the crop
    records = [ds[2], silent, ds[1], short]
    jrecords = [jds[2], silent, jds[1], short]
    got = Collator(100, 160, silence_check=silence_check, precompute_labels=True).collate(
        records, np.random.default_rng(11))
    want = JaxCollator(100, 160, silence_check=silence_check, precompute_labels=True).collate(
        jrecords, np.random.default_rng(11))
    _assert_batches_equal([got], [want])
    assert got.audio.shape == ((3, 16000) if silence_check else (4, 16000))


def test_collator_drops_all_silent_and_keeps_the_anchor():
    col = Collator(100, 160, rng=np.random.default_rng(1), precompute_labels=True)
    silent = {"audio": np.zeros(20000, np.float32), "noisy": np.zeros(20000, np.float32)}
    batch = col.collate([silent])
    assert batch.audio.shape == (0, 16000) and batch.pesq_clean is None


def test_dataset_pairs_equal_jax(wav_dirs):
    ds, jds = VoicebankDataset(*wav_dirs), JaxVoicebankDataset(*wav_dirs)
    assert len(ds) == len(jds) == 6
    for i in range(6):
        for key in ("audio", "noisy"):
            assert np.array_equal(ds[i][key], jds[i][key])


@pytest.mark.parametrize("signal_rate, target", [(16000, 16000), (48000, 16000), (8000, 16000),
                                                 (22050, 16000)])
def test_wav_io_equals_jax(tmp_path, signal_rate, target):
    rng = np.random.default_rng(signal_rate)
    x = (0.25 * np.sin(2 * np.pi * 440 * np.arange(signal_rate) / signal_rate)
         + 0.01 * rng.standard_normal(signal_rate)).astype(np.float32)
    save_wav(tmp_path / "port.wav", x, signal_rate)
    jax_save_wav(tmp_path / "jax.wav", x, signal_rate)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    y, sr = load_wav(tmp_path / "port.wav", target)
    want, want_sr = jax_load_wav(tmp_path / "port.wav", target)
    assert sr == want_sr == target and y.dtype == np.float32
    assert np.array_equal(y, want)
    assert abs(len(y) - target) <= 1
    if signal_rate == target:
        np.testing.assert_allclose(y, x, atol=1e-3)  # 16-bit PCM round trip


def test_equal_shard_batch_counts(wav_dirs):
    ds = VoicebankDataset(*wav_dirs)
    for num_shards in (2, 4):  # 6 % 4 != 0: ragged shards are padded by wrapping
        for drop_last in (True, False):
            dls = [DataLoader(ds, 2, Collator(100, 160, silence_check=False), seed=5,
                              shard_id=s, num_shards=num_shards, num_workers=1,
                              drop_last=drop_last) for s in range(num_shards)]
            counts = [len(dl) for dl in dls]
            assert len(set(counts)) == 1 and counts[0] == len(list(dls[0]))
    shards = [DataLoader(ds, 2, None, shard_id=s, num_shards=4)._indices() for s in range(4)]
    assert all(len(ix) == 2 for ix in shards)
    assert set(np.concatenate(shards)) == set(range(6))


def test_worker_errors_reach_the_caller(wav_dirs):
    class BrokenDataset(VoicebankDataset):
        def __getitem__(self, idx, rng=None):
            raise RuntimeError("boom")

    dl = DataLoader(BrokenDataset(*wav_dirs), 2, Collator(100, 160, silence_check=False),
                    num_workers=2)
    with pytest.raises(RuntimeError, match="boom"):
        list(dl)


def test_early_stop_joins_the_workers(wav_dirs):
    import threading

    before = threading.active_count()
    dl = DataLoader(VoicebankDataset(*wav_dirs), 1, Collator(100, 160, silence_check=False),
                    num_workers=3)
    it = iter(dl)
    next(it)
    it.close()  # the consumer stops after one batch of six
    assert threading.active_count() == before
