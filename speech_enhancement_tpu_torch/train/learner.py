"""Step-granular diffusion learner, the standalone CDiffuSE trainer (port of
speech_enhancement_tpu/train/learner.py).

An endless loop over dataset passes up to ``max_steps``: one
:func:`~speech_enhancement_tpu_torch.train.diffusion.diffuse_step` a batch,
a ``RuntimeError`` on a non-finite loss, a checkpoint at the end of every
pass with a ``weights`` copy of the latest, summaries every
``summary_every`` steps, and a partial pretrain load that leaves the
conditioner and input projections fresh.

Resuming continues the run it restores: the pass and the batch within it
come from ``divmod(step, len(loader))``, the loader's epoch is set on every
pass (its crops and shuffle are keyed by it), and each step's seed is a
function of ``(seed, step)`` alone.  The JAX learner's ``max_grad_norm``
was never read there and is not carried here.
"""

from __future__ import annotations

import itertools
import json
import math
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from speech_enhancement_tpu_torch.data.audio_io import save_wav
from speech_enhancement_tpu_torch.data.preprocess import make_spectrum
from speech_enhancement_tpu_torch.train.diffusion import diffuse_step
from speech_enhancement_tpu_torch.train.state import ModuleState
from speech_enhancement_tpu_torch.utils.checkpoint import (
    STATE,
    load_checkpoint,
    save_checkpoint,
)


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step`` of a run seeded ``seed``: a function of the
    two only."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1)[0])


def _batches_from(dataset, start: int):
    """The pass's batches from batch ``start`` on: the loader's own
    ``iterate(start)`` where it has one (nothing before ``start`` is
    loaded), else the whole pass with the first ``start`` dropped."""
    if hasattr(dataset, "iterate"):
        return dataset.iterate(start)
    return itertools.islice(iter(dataset), start, None)


class DiffuSELearner:
    """Trains ``state`` (a DiffuSE and its optimizer) on the batches of
    ``dataset`` (with ``audio`` and ``noisy`` numpy ``[B, L]``), writing
    under ``model_dir``: ``checkpoint_{step:04d}/`` and the ``weights/``
    copy (``state.pt``, ``variables.pt``), ``summary.jsonl`` and
    ``summaries/``.  The batches go to the device of the model's
    parameters."""

    def __init__(self, model_dir: str, state: ModuleState, dataset, noise_schedule, criterion, *,
                 n_fft: int = 400, hop: int = 100, summary_every: int = 50, logger=None):
        self.model_dir = Path(model_dir)
        self.model_dir.mkdir(parents=True, exist_ok=True)
        self.state = state
        self.dataset = dataset
        self.noise_schedule = noise_schedule
        self.criterion = criterion
        self.n_fft = n_fft
        self.hop = hop
        self.summary_every = summary_every
        self.logger = logger
        self.step = int(state.step)
        self.device = next(state.model.parameters()).device

    def save_to_checkpoint(self, filename: str = "weights") -> None:
        """``checkpoint_{step:04d}/``, then a full copy as ``<filename>/``."""
        target = save_checkpoint(self.state.state_dict(), str(self.model_dir), self.step,
                                 variables=self.state.variables())
        alias = self.model_dir / filename
        if alias.exists():
            shutil.rmtree(alias)
        shutil.copytree(target, alias)

    def restore_from_checkpoint(self, filename: str = "weights") -> bool:
        """Model, optimizer and step from ``<filename>/``; False when there
        is none."""
        path = self.model_dir / filename
        if not (path / STATE).exists():
            return False
        self.state.load_state_dict(load_checkpoint(str(path)))
        self.step = int(self.state.step)
        return True

    def train(self, max_steps: int | None = None, rng_seed: int = 0) -> ModuleState:
        """Train until ``max_steps`` (forever when None); a checkpoint at the
        end of every pass.  Returns the state."""
        passes, skip = 0, 0
        n_batches = len(self.dataset) if hasattr(self.dataset, "__len__") else 0
        if n_batches:
            passes, skip = divmod(self.step, n_batches)
        while True:
            if hasattr(self.dataset, "set_epoch"):
                self.dataset.set_epoch(passes)
            for batch in _batches_from(self.dataset, skip):
                if max_steps is not None and self.step >= max_steps:
                    return self.state
                if batch.audio.shape[0] == 0:
                    continue
                t0 = time.perf_counter()
                clean, noisy = (torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
                                for x in (batch.audio, batch.noisy))
                loss, grad_norm = diffuse_step(
                    self.state, clean, noisy, self.noise_schedule,
                    step_seed(rng_seed, self.step), criterion=self.criterion, n_fft=self.n_fft,
                    hop=self.hop, return_grad_norm=True)
                loss = float(loss)
                if not math.isfinite(loss):
                    raise RuntimeError(f"Detected NaN loss at step {self.step}.")
                if self.step % self.summary_every == 0:
                    self._write_summary(loss, time.perf_counter() - t0, float(grad_norm), batch)
                self.step += 1
            skip = 0
            self.save_to_checkpoint()
            passes += 1

    def _write_summary(self, loss: float, step_time: float, grad_norm: float = 0.0,
                       batch=None) -> None:
        """A ``summary.jsonl`` line (step, loss, grad_norm, step_time) and,
        for a non-empty batch, its first clean crop as
        ``summaries/step_{step:06d}_audio.wav`` with its spectrogram as
        ``_spectrogram.npy`` (the batch's own for a ``SpecBatch``, else
        ``make_spectrum`` of the audio)."""
        rec = {"step": self.step, "loss": loss, "grad_norm": grad_norm, "step_time": step_time}
        with open(self.model_dir / "summary.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        if batch is not None and len(batch.audio):
            sdir = self.model_dir / "summaries"
            sdir.mkdir(exist_ok=True)
            audio = np.asarray(batch.audio[0], np.float32)
            save_wav(sdir / f"step_{self.step:06d}_audio.wav", audio)
            spec = getattr(batch, "spectrogram", None)
            if spec is None:
                spec, _, _ = make_spectrum(y=audio, frame_length=self.n_fft, shift=self.hop)
            else:
                spec = np.asarray(spec[0])
            np.save(sdir / f"step_{self.step:06d}_spectrogram.npy", spec)
        if self.logger:
            self.logger.info(f"step {self.step}: loss {loss:.5f} grad_norm {grad_norm:.3f}")


def load_pretrain_params(state: ModuleState, pretrain_state: ModuleState) -> ModuleState:
    """Load ``pretrain_state``'s model into ``state.model``, key by key: a
    key naming a ``conditioner_projection`` or the ``input_projection``
    stays freshly initialized, every other key takes the pretrained value
    where the shapes match.  Returns ``state``."""
    source = pretrain_state.model.state_dict()
    merged = {}
    for key, fresh in state.model.state_dict().items():
        old = source.get(key)
        keep_fresh = "conditioner_projection" in key or "input_projection" in key
        merged[key] = fresh if keep_fresh or old is None or old.shape != fresh.shape else old
    state.model.load_state_dict(merged)
    return state
