"""Batched enhancement serving (port of speech_enhancement_tpu/enhance.py).

Utterances are wrap-padded into length buckets (multiples of ``quantum``
samples), batched, and each batch runs RMS normalize -> compressed STFT ->
TSCNet -> uncompressed iSTFT -> denormalize on one device.  With
``fused_stft=True`` the featurization goes through the K4/K5 kernels
(``ops/fused_stft.py``); ``TSCNet(fused_attention=True)`` sends the time
conformers through K1.
"""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from speech_enhancement_tpu_torch.ops.fused_stft import fused_istft, fused_stft
from speech_enhancement_tpu_torch.ops.stft import (
    compressed_stft,
    normalize_batch,
    uncompressed_istft,
)
from speech_enhancement_tpu_torch.utils.device import resolve_device


def round_to_bucket(length: int, quantum: int = 8000, hop: int = 100) -> int:
    """Next bucket length: a multiple of ``quantum`` (itself a hop multiple)."""
    if quantum % hop:
        raise ValueError(f"quantum {quantum} is not a multiple of hop {hop}")
    return max(quantum, ((length + quantum - 1) // quantum) * quantum)


def wrap_pad(x: np.ndarray, target: int) -> np.ndarray:
    """Pad a 1-D signal to ``target`` by wrapping from its start, or cut it."""
    if len(x) >= target:
        return x[:target]
    return np.pad(x, (0, target - len(x)), mode="wrap")


class Enhancer:
    """Batched enhancer for a ``TSCNet``-style generator on one device.

    ``compute_dtype=torch.bfloat16`` runs the model on a bf16 copy of its
    floating parameters and buffers (the model passed in is left as it
    is); the featurization, the magnitude and phase, and the output stay
    fp32.  ``device`` is ``cuda`` when None (``'cpu'`` runs on the CPU)
    and raises when CUDA is asked for and absent.
    """

    def __init__(self, model: torch.nn.Module, n_fft: int = 400, hop: int = 100,
                 quantum: int = 8000, compute_dtype: torch.dtype | None = None,
                 fused_stft: bool = False, device=None):
        self.device = resolve_device(device)
        if compute_dtype is not None:
            model = copy.deepcopy(model).to(dtype=compute_dtype)
        self.model = model.to(self.device).eval()
        self.n_fft = n_fft
        self.hop = hop
        # a hop that does not divide the quantum gets the nearest smaller
        # hop multiple, as the JAX Enhancer derives it
        if quantum % hop:
            quantum = max(hop, quantum - quantum % hop)
        self.quantum = quantum
        self.compute_dtype = compute_dtype
        self.fused_stft = fused_stft

    @torch.inference_mode()
    def _step(self, noisy: torch.Tensor) -> torch.Tensor:
        stft_fn, istft_fn = ((fused_stft, fused_istft) if self.fused_stft
                             else (compressed_stft, uncompressed_istft))
        _, noisy_n, c = normalize_batch(noisy, noisy)
        spec = stft_fn(noisy_n, self.n_fft, self.hop, comp_type="pow")
        if self.compute_dtype is not None:
            spec_in = (spec.real.to(self.compute_dtype), spec.imag.to(self.compute_dtype))
        else:
            spec_in = spec
        est_real, est_imag = self.model(spec_in)
        est = istft_fn(torch.complex(est_real.float(), est_imag.float()), self.n_fft,
                       self.hop, comp_type="pow", length=noisy.shape[-1])
        return est / c

    def _launch(self, batch: np.ndarray):
        """Enqueue one batch; returns what :meth:`_collect` waits on.  On
        CUDA the result is copied into pinned host memory behind an event,
        so the copy is queued before the next batch's work."""
        x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32))
        est = self._step(x.to(self.device))
        if self.device.type != "cuda":
            return est, None
        host = torch.empty(est.shape, dtype=est.dtype, pin_memory=True)
        host.copy_(est, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _collect(pending) -> np.ndarray:
        est, done = pending
        if done is not None:
            done.synchronize()
        return est.numpy()

    def enhance_batch(self, noisy: np.ndarray) -> np.ndarray:
        """Enhance a fixed-length ``[B, L]`` batch (L a hop multiple)."""
        return self._collect(self._launch(np.asarray(noisy)))

    def enhance(self, utterances: Sequence[np.ndarray],
                batch_size: int = 32) -> list[np.ndarray]:
        """Enhance variable-length utterances in length buckets.  Returns
        the enhanced signals cut to their input lengths, in input order."""
        order = sorted(range(len(utterances)), key=lambda i: len(utterances[i]))
        out: list[np.ndarray | None] = [None] * len(utterances)

        def drain(pending, chunk):
            est = self._collect(pending)
            for row, j in enumerate(chunk):
                out[j] = est[row, : len(utterances[j])]

        # one-deep overlap: batch i + 1 is padded and launched before the
        # host waits for batch i
        prev = None
        for start in range(0, len(order), batch_size):
            chunk = order[start: start + batch_size]
            bucket = round_to_bucket(max(len(utterances[j]) for j in chunk),
                                     self.quantum, self.hop)
            batch = np.stack([wrap_pad(np.asarray(utterances[j], np.float32), bucket)
                              for j in chunk])
            pending = self._launch(batch)
            if prev is not None:
                drain(*prev)
            prev = (pending, chunk)
        if prev is not None:
            drain(*prev)
        return out  # type: ignore[return-value]


def predict_one(model: torch.nn.Module, noisy_signal: np.ndarray, n_fft: int = 400,
                hop: int = 100, device=None) -> np.ndarray:
    """Single-utterance predict with the reference semantics: wrap-pad only
    to the next hop multiple, enhance, cut back to the input length.
    ``device`` as for :class:`Enhancer`."""
    length = len(noisy_signal)
    padded = ((length + hop - 1) // hop) * hop
    x = wrap_pad(np.asarray(noisy_signal, np.float32), padded)[None]
    return Enhancer(model, n_fft, hop, quantum=hop, device=device).enhance_batch(x)[0, :length]
