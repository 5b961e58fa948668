"""Batched enhancement serving (port of speech_enhancement_tpu/enhance.py).

Utterances are wrap-padded into length buckets (multiples of ``quantum``
samples), batched, and each batch runs RMS normalize -> compressed STFT ->
TSCNet -> uncompressed iSTFT -> denormalize on one device.  With
``fused_stft=True`` the featurization goes through the K4/K5 kernels
(``ops/fused_stft.py``); ``TSCNet(fused_attention=True)`` sends the time
conformers through K1, ``TSCNet(quantized_convs=True)`` its encoder and
decoders' 15 convs through int8 (``ops/int8.py``).  ``devices=[...]``
splits each batch over a replica of the model on each device, as the JAX
Enhancer's ``mesh`` does.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
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
from speech_enhancement_tpu_torch.utils.profiling import count, span


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


# the JAX Enhancer's matmul_precision values and torch's fp32 precision for
# CUDA matmuls and cuDNN convolutions nearest to each: torch has no
# single-pass bf16 mode for fp32 products on CUDA, so "bfloat16" takes TF32
MATMUL_PRECISIONS = {"bfloat16": "tf32", "tensorfloat32": "tf32", "float32": "ieee",
                     "highest": "ieee", None: "ieee"}


@contextlib.contextmanager
def fp32_precision(mode: str):
    """torch's fp32 precision of CUDA matmuls and cuDNN convolutions set to
    ``mode`` (``"tf32"`` or ``"ieee"``) inside, the previous settings
    restored on exit, also when the body raises.  Only the
    ``fp32_precision`` flags are read and written: torch refuses to read
    its precision once the legacy ``allow_tf32`` flags and these have both
    been set.  The flags are process-wide, so two threads that enhance at
    once with different modes race on them."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    before = (matmul.fp32_precision, conv.fp32_precision)
    matmul.fp32_precision = conv.fp32_precision = mode
    try:
        yield
    finally:
        matmul.fp32_precision, conv.fp32_precision = before


class Enhancer:
    """Batched enhancer for a ``TSCNet``-style generator on one device.

    ``compute_dtype=torch.bfloat16`` runs the model on a bf16 copy of its
    floating parameters and buffers (the model passed in is left as it
    is); the featurization, the magnitude and phase, and the output stay
    fp32.  ``device`` is ``cuda`` when None (``'cpu'`` runs on the CPU)
    and raises when CUDA is asked for and absent.

    ``matmul_precision`` takes the JAX Enhancer's values and maps each to
    torch's fp32 precision for the CUDA matmuls and cuDNN convolutions of
    a batch (:data:`MATMUL_PRECISIONS`, applied by :func:`fp32_precision`
    around each batch): ``"bfloat16"`` (the default, as in the JAX
    package) and ``"tensorfloat32"`` run them in TF32, which keeps 10
    mantissa bits of each operand where the TPU's single-pass bf16 keeps
    7; ``"float32"``, ``"highest"`` and None run them in full fp32.  CPU
    matmuls ignore the setting, and so do the hand-written kernels (K1's
    3xTF32 and bf16 instances, K4, K5), whose arithmetic is their own at
    every setting.  Any other value raises ``ValueError``.

    ``devices`` (a list, in place of ``device``) serves on several devices,
    the counterpart of the JAX Enhancer's ``mesh``: one replica of the
    model on each (the first is the model passed in, moved there), and
    each batch padded by repeating its last row until the device count
    divides it, split into contiguous row slices, each launched on its
    device before any is collected, and joined in order.  A device may
    appear twice (two replicas on one card).  With an int8 model
    (``TSCNet(quantized_convs=True)``) the dynamic activation scales are
    each slice's own, as under the JAX Enhancer's ``shard_map``: the
    output can differ from one device's by int8 rounding.

    Under a profiler session (``utils.profiling``) each :meth:`enhance`
    call is a span ``se.enhance`` (its id the call's number), and each of
    its batches spans ``se.enhance.bucket`` (its rows picked, wrap-padded
    and stacked), ``se.enhance.h2d`` and ``se.enhance.dispatch`` (the
    model's work and the output's copy enqueued) on each device, and
    ``se.enhance.collect`` (the wait, the copy out, the cut back); the
    counters ``enhance.batch_samples`` and ``enhance.pad_samples`` count
    the samples of each batch and those that wrap-pad added.
    """

    def __init__(self, model: torch.nn.Module, n_fft: int = 400, hop: int = 100,
                 quantum: int = 8000, compute_dtype: torch.dtype | None = None,
                 matmul_precision: str | None = "bfloat16", fused_stft: bool = False,
                 device=None, devices=None):
        if matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision {matmul_precision!r} is not one of "
                             f"{list(MATMUL_PRECISIONS)}")
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        self.devices = [resolve_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        if compute_dtype is not None:
            model = copy.deepcopy(model).to(dtype=compute_dtype)
        self.model = model.to(self.device).eval()
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in self.devices[1:]]
        self.n_fft = n_fft
        self.hop = hop
        # a hop that does not divide the quantum gets the nearest smaller
        # hop multiple, as the JAX Enhancer derives it
        if quantum % hop:
            quantum = max(hop, quantum - quantum % hop)
        self.quantum = quantum
        self.compute_dtype = compute_dtype
        self.matmul_precision = matmul_precision
        self.fused_stft = fused_stft
        self._calls = itertools.count()

    @torch.inference_mode()
    def _step(self, noisy: torch.Tensor, *replica: torch.nn.Module) -> torch.Tensor:
        with fp32_precision(MATMUL_PRECISIONS[self.matmul_precision]):
            return self._enhance(noisy, *replica)

    def _enhance(self, noisy: torch.Tensor, model: torch.nn.Module | None = None
                 ) -> torch.Tensor:
        model = model or self.model
        stft_fn, istft_fn = ((fused_stft, fused_istft) if self.fused_stft
                             else (compressed_stft, uncompressed_istft))
        _, noisy_n, c = normalize_batch(noisy, noisy)
        spec = stft_fn(noisy_n, self.n_fft, self.hop, comp_type="pow")
        if self.compute_dtype is not None:
            spec_in = (spec.real.to(self.compute_dtype), spec.imag.to(self.compute_dtype))
        else:
            spec_in = spec
        est_real, est_imag = model(spec_in)
        est = istft_fn(torch.complex(est_real.float(), est_imag.float()), self.n_fft,
                       self.hop, comp_type="pow", length=noisy.shape[-1])
        return est / c

    def _launch_on(self, i: int, rows: np.ndarray):
        """Enqueue ``rows`` on replica ``i``.  On CUDA the result is copied
        into pinned host memory behind an event, so the copy is queued
        before the next batch's work."""
        device = self.devices[i]
        replica = (self.replicas[i],) if i else ()
        with span("se.enhance.h2d"):
            x = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32)).to(device)
        with span("se.enhance.dispatch"):
            if device.type != "cuda":
                return self._step(x, *replica), None
            with torch.cuda.device(device):
                est = self._step(x, *replica)
                host = torch.empty(est.shape, dtype=est.dtype, pin_memory=True)
                host.copy_(est, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            return host, done

    def _pad_to_devices(self, batch: np.ndarray) -> np.ndarray:
        """Repeat the last row until the device count divides the rows."""
        short = -batch.shape[0] % len(self.devices)
        if short:
            batch = np.concatenate([batch, np.repeat(batch[-1:], short, axis=0)])
        return batch

    def _launch(self, batch: np.ndarray):
        """Enqueue one batch, a contiguous row slice on each device; returns
        what :meth:`_collect` waits on."""
        padded = self._pad_to_devices(batch)
        per = padded.shape[0] // len(self.devices)
        return batch.shape[0], [self._launch_on(i, padded[i * per:(i + 1) * per])
                                for i in range(len(self.devices))]

    @staticmethod
    def _collect(pending) -> np.ndarray:
        rows, parts = pending
        out = []
        for est, done in parts:
            if done is not None:
                done.synchronize()
            out.append(est.numpy())
        return np.concatenate(out)[:rows]

    def enhance_batch(self, noisy: np.ndarray) -> np.ndarray:
        """Enhance a fixed-length ``[B, L]`` batch (L a hop multiple)."""
        return self._collect(self._launch(np.asarray(noisy)))

    def enhance(self, utterances: Sequence[np.ndarray],
                batch_size: int = 32) -> list[np.ndarray]:
        """Enhance variable-length utterances in length buckets.  Returns
        the enhanced signals cut to their input lengths, in input order."""
        with span("se.enhance", next(self._calls)):
            order = sorted(range(len(utterances)), key=lambda i: len(utterances[i]))
            out: list[np.ndarray | None] = [None] * len(utterances)

            def drain(pending, chunk):
                with span("se.enhance.collect"):
                    est = self._collect(pending)
                    for row, j in enumerate(chunk):
                        out[j] = est[row, : len(utterances[j])]

            # one-deep overlap: batch i + 1 is padded and launched before the
            # host waits for batch i
            prev = None
            for start in range(0, len(order), batch_size):
                with span("se.enhance.bucket"):
                    chunk = order[start: start + batch_size]
                    lengths = [len(utterances[j]) for j in chunk]
                    bucket = round_to_bucket(max(lengths), self.quantum, self.hop)
                    batch = np.stack([wrap_pad(np.asarray(utterances[j], np.float32), bucket)
                                      for j in chunk])
                count("enhance.batch_samples", batch.size)
                count("enhance.pad_samples", batch.size - sum(lengths))
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
    ``device`` as for :class:`Enhancer`, whose default ``matmul_precision``
    it takes, as the JAX ``predict_one`` does."""
    length = len(noisy_signal)
    padded = ((length + hop - 1) // hop) * hop
    x = wrap_pad(np.asarray(noisy_signal, np.float32), padded)[None]
    return Enhancer(model, n_fft, hop, quantum=hop, device=device).enhance_batch(x)[0, :length]
