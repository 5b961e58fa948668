"""VoiceBank-DEMAND dataset, crop/tile collator and thread-prefetched
loader (port of speech_enhancement_tpu/data/voicebank.py).

* Filename pairing and 16 kHz loading as in the reference.
* The collator crops (or tiles) each record to a fixed length, with up to
  ten retries of a crop that PESQ finds silent, and precomputes the
  normalized PESQ labels of clean against clean and of noisy against
  clean that the discriminator needs every step, so that a training step
  computes only the estimate's label.  PESQ(x, x) is one constant for any
  non-silent x, pinned by one engine call per sample rate.
* The loader yields numpy :class:`Batch`es from worker threads over this
  process's shard of the file list; each epoch's shuffle is seeded by
  (seed, epoch), each batch's crops by (seed, epoch, shard, batch), so the
  stream is the same at any worker count.  The training loop moves a batch
  to the card.

PESQ comes from the port's own engine (``metrics/pesq.py``).

Under a profiler session (``utils.profiling``) a worker's batch is a span
``se.data.batch`` (its id the batch's index; the wait to put it on a full
queue is outside it) holding ``se.data.read`` (its records loaded), and
the consumer's wait for the next batch is ``se.data.wait``.
"""

from __future__ import annotations

import queue
import threading
from glob import glob
from typing import Iterator, NamedTuple

import numpy as np

from speech_enhancement_tpu_torch.data.audio_io import load_wav
from speech_enhancement_tpu_torch.metrics.pesq import batch_pesq_raw, pesq_loss
from speech_enhancement_tpu_torch.utils.profiling import span


class VoicebankDataset:
    """Pairs noisy and clean wavs by directory substitution."""

    def __init__(self, clean_path: str, noisy_path: str, samples_per_frame: int = 100,
                 crop_frames: int = 160, random_crop: bool = False,
                 sample_rate: int = 16000):
        self.clean_path = clean_path
        self.noisy_path = noisy_path
        self.samples_per_frame = samples_per_frame
        self.crop_frames = crop_frames
        self.random_crop = random_crop
        self.sample_rate = sample_rate
        self.data_paths = sorted(glob(f"{noisy_path}/*.wav", recursive=True))

    def __len__(self) -> int:
        return len(self.data_paths)

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None) -> dict:
        """``{"audio": clean, "noisy": noisy}``.  ``rng`` makes the random
        crop deterministic (the loader passes a per-batch generator); bare
        ``ds[idx]`` draws from the global one."""
        noisy_file = self.data_paths[idx]
        clean_file = noisy_file.replace(self.noisy_path, self.clean_path)
        clean, _ = load_wav(clean_file, self.sample_rate)
        noisy, _ = load_wav(noisy_file, self.sample_rate)
        if self.random_crop:
            length = self.crop_frames * self.samples_per_frame
            hi = max(1, len(clean) - length)
            start = int(rng.integers(0, hi)) if rng is not None else np.random.randint(0, hi)
            clean = clean[start:start + length]
            noisy = noisy[start:start + length]
        return {"audio": clean, "noisy": noisy}


class Batch(NamedTuple):
    """One fixed-shape host batch.  ``pesq_clean`` / ``pesq_noisy`` are the
    precomputed normalized PESQ labels ((pesq - 1) / 3.5) of the
    discriminator's clean and noisy terms, or None."""

    audio: np.ndarray
    noisy: np.ndarray
    pesq_clean: np.ndarray | None
    pesq_noisy: np.ndarray | None


class Collator:
    """Crops or tiles records to a fixed length, retrying silent crops."""

    # PESQ(x, x), pinned by one engine call per sample rate (wideband and
    # narrowband anchors differ); shared by every collator and worker
    # thread; every writer stores the same constant for a rate
    _pesq_self_anchor: dict[int, float] = {}

    def __init__(self, samples_per_frame: int = 100, crop_frames: int = 160,
                 crop_len: int = 1, rng: np.random.Generator | None = None,
                 silence_check: bool = True, precompute_labels: bool = False,
                 sample_rate: int = 16000):
        self.crop_len = samples_per_frame * crop_frames * crop_len
        self.rng = rng or np.random.default_rng()
        self.silence_check = silence_check
        self.precompute_labels = precompute_labels
        self.sample_rate = sample_rate

    def _recrop(self, record: dict, rng: np.random.Generator | None = None):
        rng = rng if rng is not None else self.rng
        clean, noisy = record["audio"], record["noisy"]
        length = len(clean)
        if length < self.crop_len:
            units, rem = divmod(self.crop_len, length)
            clean = np.concatenate([clean] * units + [clean[:rem]])
            noisy = np.concatenate([noisy] * units + [noisy[:rem]])
        else:
            start = int(rng.integers(0, length - self.crop_len + 1))
            clean = clean[start:start + self.crop_len]
            noisy = noisy[start:start + self.crop_len]
        return clean, noisy

    def collate(self, minibatch: list[dict], rng: np.random.Generator | None = None) -> Batch:
        """``rng`` overrides the collator's own generator for this call (the
        loader passes a per-batch one, so that worker threads share none)."""
        cleans, noisys = [], []
        for record in minibatch:
            for _ in range(10):  # ten chances to avoid a silent crop
                c, n = self._recrop(record, rng)
                if not self.silence_check or pesq_loss(c, n, self.sample_rate) != -1:
                    cleans.append(c)
                    noisys.append(n)
                    break
        if not cleans:
            empty = np.zeros((0, self.crop_len), np.float32)
            return Batch(empty, empty.copy(), None, None)
        audio = np.stack(cleans).astype(np.float32)
        noisy = np.stack(noisys).astype(np.float32)
        pesq_clean = pesq_noisy = None
        if self.precompute_labels:
            if self.silence_check:
                # the retries above left only non-silent crops, whose
                # PESQ(x, x) is the engine's constant self-anchor;
                # exclude_noise: a frozen draw of the label-noise knob
                # would bias every clean label of the run alike
                anchor = Collator._pesq_self_anchor.get(self.sample_rate)
                if anchor is None:
                    anchor = float(batch_pesq_raw(audio[:1], audio[:1], self.sample_rate,
                                                  exclude_noise=True)[0])
                    Collator._pesq_self_anchor[self.sample_rate] = anchor
                pesq_clean = np.full(len(cleans), (anchor - 1.0) / 3.5, np.float32)
            else:
                pesq_clean = ((batch_pesq_raw(audio, audio, self.sample_rate) - 1.0)
                              / 3.5).astype(np.float32)
            pesq_noisy = ((batch_pesq_raw(audio, noisy, self.sample_rate) - 1.0)
                          / 3.5).astype(np.float32)
        return Batch(audio, noisy, pesq_clean, pesq_noisy)


class DataLoader:
    """Sharded, thread-prefetched batch iterator.

    This process sees shard ``shard_id`` of ``num_shards`` of the file list
    (shuffled per epoch when ``shuffle``; padded by wrapping to a multiple of
    the shard count, so that every shard has as many batches), loads and
    collates it on ``num_workers`` threads, and yields the batches in order.
    A worker's exception is raised in the caller.
    """

    def __init__(self, dataset: VoicebankDataset, batch_size: int, collator: Collator,
                 shuffle: bool = True, seed: int = 0, shard_id: int = 0, num_shards: int = 1,
                 num_workers: int = 4, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collator = collator
        self.shuffle = shuffle
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        if self.num_shards > 1 and len(idx) % self.num_shards:
            total = -(-len(idx) // self.num_shards) * self.num_shards
            idx = np.concatenate([idx, idx[:total - len(idx)]])
        return idx[self.shard_id::self.num_shards]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_rng(self, batch_index: int) -> np.random.Generator:
        """The generator of one batch, keyed by (seed, epoch, shard, batch)."""
        return np.random.default_rng(
            np.random.SeedSequence((self.seed, self.epoch, self.shard_id, batch_index)))

    def __iter__(self) -> Iterator[Batch]:
        return self.iterate()

    def iterate(self, start: int = 0) -> Iterator[Batch]:
        """The epoch's batches from batch ``start`` on: the same batches as a
        whole epoch's from there (each is keyed by its index), without
        loading the ones before it."""
        idx = self._indices()
        n_batches = len(self)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(n_batches)]
        out_q: queue.Queue = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()

        def worker(batch_ids: list[int]):
            for b in batch_ids:
                if stop.is_set():
                    return
                try:
                    with span("se.data.batch", b):
                        rng = self._batch_rng(b)
                        with span("se.data.read"):
                            records = [self.dataset.__getitem__(int(i), rng)
                                       for i in batches[b]]
                        item = self.collator.collate(records, rng)
                except Exception as exc:  # raised in the caller
                    item = exc
                while not stop.is_set():  # a consumer that stopped takes nothing
                    try:
                        out_q.put((b, item), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, Exception):
                    return

        # round-robin assignment: worker w takes batches start + w, start + w + n, ...
        threads = [threading.Thread(target=worker,
                                    args=(list(range(start + w, n_batches, self.num_workers)),),
                                    daemon=True)
                   for w in range(min(self.num_workers, max(n_batches - start, 1)))]
        for t in threads:
            t.start()
        try:
            received: dict[int, Batch] = {}
            for next_emit in range(start, n_batches):
                with span("se.data.wait", next_emit):
                    while next_emit not in received:
                        b, batch = out_q.get()
                        if isinstance(batch, Exception):
                            raise batch
                        received[b] = batch
                yield received.pop(next_emit)
        finally:
            stop.set()
            for t in threads:
                t.join()
