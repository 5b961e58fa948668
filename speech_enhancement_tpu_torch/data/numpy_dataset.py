"""Precomputed-spectrogram dataset for standalone CDiffuSE (port of
speech_enhancement_tpu/data/numpy_dataset.py).

Reads the ``<wav>.spec.npy`` conditioner features that ``data/preprocess.py``
writes, beside the paired clean and noisy wavs; the collator takes an
aligned random crop of ``crop_frames`` spectrogram frames and ``crop_frames
* hop`` audio samples, zero-filling a short audio tail, and drops records
shorter than the crop.  Batches are numpy; the training loop moves them to
the card.
"""

from __future__ import annotations

from glob import glob
from typing import NamedTuple

import numpy as np

from speech_enhancement_tpu_torch.data.audio_io import load_wav
from speech_enhancement_tpu_torch.data.voicebank import DataLoader


class SpecBatch(NamedTuple):
    audio: np.ndarray        # [B, crop_frames * hop]
    noisy: np.ndarray        # [B, crop_frames * hop]
    spectrogram: np.ndarray  # [B, crop_frames, n_specs]


class NumpyDataset:
    """``{"audio", "noisy", "spectrogram" [T, F]}`` records: every
    ``*.wav.spec.npy`` of ``npy_paths`` (sorted per directory) with the
    same-named wavs of ``wav_path`` (clean) and ``noisy_path``."""

    def __init__(self, wav_path: str, noisy_path: str, npy_paths: list[str],
                 sample_rate: int = 16000):
        self.wav_path = wav_path
        self.noisy_path = noisy_path
        self.sample_rate = sample_rate
        self.specnames: list[str] = []
        for path in npy_paths:
            self.specnames += sorted(glob(f"{path}/*.wav.spec.npy", recursive=True))

    def __len__(self) -> int:
        return len(self.specnames)

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None) -> dict:
        """The ``idx``-th record; ``rng`` (the loader's per-batch generator)
        is not needed: the crop is the collator's."""
        spec_file = self.specnames[idx]
        spec_dir = "/".join(spec_file.split("/")[:-1])
        audio_file = spec_file.replace(spec_dir, self.wav_path).replace(".spec.npy", "")
        noisy_file = spec_file.replace(spec_dir, self.noisy_path).replace(".spec.npy", "")
        signal, _ = load_wav(audio_file, self.sample_rate)
        noisy, _ = load_wav(noisy_file, self.sample_rate)
        return {"audio": signal, "noisy": noisy, "spectrogram": np.load(spec_file).T}


class SpecCollator:
    """Aligned spectrogram / audio random crop."""

    def __init__(self, hop_samples: int = 100, crop_frames: int = 160,
                 rng: np.random.Generator | None = None):
        self.hop = hop_samples
        self.crop_frames = crop_frames
        self.rng = rng or np.random.default_rng()

    def collate(self, minibatch: list[dict], rng: np.random.Generator | None = None) -> SpecBatch:
        """``rng`` overrides the collator's own generator for this call (the
        loader passes a per-batch one)."""
        rng = rng if rng is not None else self.rng
        audios, noisys, specs = [], [], []
        for record in minibatch:
            spec = record["spectrogram"]  # [T, F]
            if len(spec) < self.crop_frames:
                continue
            start = int(rng.integers(0, len(spec) - self.crop_frames + 1))
            end = start + self.crop_frames
            specs.append(spec[start:end])
            a0, a1 = start * self.hop, end * self.hop
            for key, out in (("audio", audios), ("noisy", noisys)):
                seg = record[key][a0:a1]
                out.append(np.pad(seg, (0, (a1 - a0) - len(seg)), mode="constant"))
        if not audios:
            n_specs = minibatch[0]["spectrogram"].shape[1] if minibatch else 0
            empty = np.zeros((0, self.crop_frames * self.hop), np.float32)
            return SpecBatch(empty, empty, np.zeros((0, self.crop_frames, n_specs), np.float32))
        return SpecBatch(np.stack(audios).astype(np.float32),
                         np.stack(noisys).astype(np.float32),
                         np.stack(specs).astype(np.float32))


def from_path(clean_dir: str, noisy_dir: str, data_dirs: list[str], *, batch_size: int = 16,
              hop_samples: int = 100, crop_frames: int = 160, shuffle: bool = True,
              seed: int = 0, shard_id: int = 0, num_shards: int = 1,
              num_workers: int = 4) -> DataLoader:
    """The threaded :class:`DataLoader` over a :class:`NumpyDataset` and a
    :class:`SpecCollator` seeded from ``seed``."""
    dataset = NumpyDataset(clean_dir, noisy_dir, data_dirs)
    collator = SpecCollator(hop_samples, crop_frames, np.random.default_rng(seed))
    return DataLoader(dataset, batch_size, collator, shuffle=shuffle, seed=seed,
                      shard_id=shard_id, num_shards=num_shards, num_workers=num_workers)
