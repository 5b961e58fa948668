"""ctypes binding to the native C++ PESQ engine (``csrc/pesq.cc``).

The port's own copy of ``speech_enhancement_tpu/metrics/pesq.py``, with
the same surface:

* ``pesq(fs, ref, deg, 'wb')``: drop-in for the `pesq` package call;
* ``pesq_loss(clean, noisy)``: the score, or -1 on silent or failed input;
* ``batch_pesq_raw(clean, noisy)``: raw MOS per row of two ``[B, L]``
  batches from the engine's thread pool, with the label-perturbation knobs
  of the bias-sensitivity study (``SE_TPU_PESQ_LABEL_BIAS`` and
  ``SE_TPU_PESQ_LABEL_NOISE``);
* ``batch_pesq(clean_list, noisy_list)``: normalized labels
  ``(pesq - 1) / 3.5``.

The engine is built with g++ into ``_build/`` at first use, under a name
that hashes its source (``ops/_native.py``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from speech_enhancement_tpu_torch.ops import _native

__all__ = ["batch_pesq", "batch_pesq_raw", "build", "pesq", "pesq_loss"]

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64, _I = ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    # ref, n_ref, deg, n_deg, fs -> MOS, or minus an error code
    "pesq_mos": ([_F32P, _I64, _F32P, _I64, _I], ctypes.c_double),
    # clean, noisy, batch, length, fs, n_threads, out
    "pesq_batch": ([_F32P, _F32P, _I64, _I64, _I, _I, _F64P], None),
}


def build() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/pesq.cc``."""
    return _native.load_host("pesq", _SIGNATURES)


def _as_float32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


def pesq(fs: int, ref, deg, mode: str = "wb") -> float:
    """MOS-LQO of (ref, deg); raises on silent or invalid input as the
    `pesq` package does."""
    if mode != "wb":
        raise ValueError("only wideband ('wb') mode is implemented")
    ref = _as_float32(ref)
    deg = _as_float32(deg)
    score = build().pesq_mos(ref.ctypes.data_as(_F32P), ref.size,
                             deg.ctypes.data_as(_F32P), deg.size, int(fs))
    if score < 0:
        raise RuntimeError(f"pesq failed with error code {int(-score)}")
    return float(score)


def pesq_loss(clean, noisy, sr: int = 16000) -> float:
    """PESQ, or -1 on failure (silence)."""
    try:
        return pesq(sr, clean, noisy, "wb")
    except Exception:
        return -1.0


# shared by every caller; numpy Generators are not thread-safe, so draws
# take the lock
_LABEL_RNG = np.random.default_rng(0)
_LABEL_RNG_LOCK = threading.Lock()


def _label_perturbation() -> tuple[float, float]:
    """The label-perturbation knobs of the PESQ-engine bias study: every
    score that becomes a discriminator label passes through
    :func:`batch_pesq_raw`, so these perturb training labels only.  Off
    (0, 0) unless the environment variables are set."""
    bias = float(os.environ.get("SE_TPU_PESQ_LABEL_BIAS", "0") or 0.0)
    noise = float(os.environ.get("SE_TPU_PESQ_LABEL_NOISE", "0") or 0.0)
    return bias, noise


def batch_pesq_raw(clean: np.ndarray, noisy: np.ndarray, fs: int = 16000,
                   n_threads: int = 0, exclude_noise: bool = False) -> np.ndarray:
    """Raw MOS per pair over equal-length ``[B, L]`` batches (C++ thread
    pool).  Failed rows come back as -1.

    ``exclude_noise`` is for scores cached as constants (a PESQ(x, x)
    self-anchor): the bias knob still applies, the zero-mean noise knob
    does not, since one frozen draw would shift every label alike."""
    clean = _as_float32(clean)
    noisy = _as_float32(noisy)
    if clean.shape != noisy.shape or clean.ndim != 2:
        raise ValueError(f"expected two [B, L] batches of one shape, got "
                         f"{clean.shape} and {noisy.shape}")
    b, length = clean.shape
    out = np.empty(b, np.float64)
    build().pesq_batch(clean.ctypes.data_as(_F32P), noisy.ctypes.data_as(_F32P),
                       b, length, int(fs), int(n_threads), out.ctypes.data_as(_F64P))
    scores = np.where(out < 0, -1.0, out)
    bias, noise = _label_perturbation()
    if exclude_noise:
        noise = 0.0
    if bias or noise:
        pert = scores + bias
        if noise:
            with _LABEL_RNG_LOCK:
                draw = _LABEL_RNG.standard_normal(scores.shape)
            pert = pert + noise * draw
        # clip to the MOS scale [1, 5] only, so that a bias survives at the
        # ceiling; the -1 failure sentinel stays as it is
        scores = np.where(scores < 0, scores, np.clip(pert, 1.0, 5.0))
    return scores


def batch_pesq(clean, noisy, fs: int = 16000) -> np.ndarray:
    """Normalized labels ``(pesq - 1) / 3.5``; a failed row's -1 flows
    through the normalization, as in the reference."""
    clean = np.stack([_as_float32(c) for c in clean])
    noisy = np.stack([_as_float32(n) for n in noisy])
    scores = batch_pesq_raw(clean, noisy, fs)
    return ((scores - 1.0) / 3.5).astype(np.float32)
