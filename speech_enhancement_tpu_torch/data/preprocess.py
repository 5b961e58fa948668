"""Offline spectrogram preprocessing for standalone CDiffuSE (the port's
numpy/scipy copy of speech_enhancement_tpu/data/preprocess.py).

Two modes:
* SE mode (:func:`make_spectrum`): the peak-normalized log1p magnitude of a
  centered, reflect-padded STFT under a symmetric Hamming window, saved as
  ``<wav>.spec.npy`` ``[F, T]``: the CDiffuSE conditioner features;
* vocoder mode (:func:`mel_transform`): a window-normalized HTK mel
  spectrogram, log-compressed and squashed to [0, 1].

:func:`preprocess_dir` sweeps a directory over a process pool.  Host-only:
no torch, no card.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from glob import glob

import numpy as np
from scipy import signal as sp_signal

from speech_enhancement_tpu_torch.data.audio_io import load_wav


def make_spectrum(filename: str | None = None, y: np.ndarray | None = None,
                  feature_type: str = "logmag", mode: str | None = None,
                  frame_length: int = 400, shift: int = 160, _max=None, _min=None):
    """Log1p-magnitude STFT of the peak-normalized signal (``filename`` or
    ``y``).  Returns ``(features [F, T], phase, length)``; ``feature_type``
    ``'lps'`` gives log10 power, anything else the magnitude; ``mode``
    ``'mean_std'`` or ``'minmax'`` normalizes the features."""
    if y is None:
        y, _ = load_wav(filename, 16000)
    # a silent input stays silent: the unguarded y / max|y| would be NaN
    peak = np.max(np.abs(y)) if len(y) else 0.0
    if peak > 0:
        y = y / peak
    # the symmetric Hamming window (what librosa makes of scipy's hamming
    # callable), not the periodic one of the STFT ops
    window = sp_signal.get_window("hamming", frame_length, fftbins=False)
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(yp) - frame_length) // shift
    idx = np.arange(n_frames)[:, None] * shift + np.arange(frame_length)[None, :]
    spec = np.fft.rfft(yp[idx] * window, axis=1).T  # [F, T]
    phase = np.exp(1j * np.angle(spec))
    mag = np.abs(spec)
    if feature_type == "logmag":
        sxx = np.log1p(mag)
    elif feature_type == "lps":
        sxx = np.log10(mag ** 2)
    else:
        sxx = mag
    if mode == "mean_std":
        sxx = (sxx - sxx.mean(axis=1, keepdims=True)) / (sxx.std(axis=1, keepdims=True) + 1e-12)
    elif mode == "minmax":
        sxx = 2 * (sxx - _min) / (_max - _min) - 1
    return sxx, phase, len(y)


def _mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """HTK-scale triangular mel filterbank ``[n_mels, n_fft // 2 + 1]``, no
    area normalization."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    freqs = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lo, ctr, hi = freqs[i:i + 3]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-12)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-12)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def mel_transform(y: np.ndarray, sr: int = 16000, n_fft: int = 400, hop: int = 100,
                  n_mels: int = 80) -> np.ndarray:
    """Vocoder-mode mel features in [0, 1] ``[n_mels, T]``: a periodic Hann
    of ``4 * hop`` samples framed from the ``n_fft // 2`` reflect padding,
    the magnitude over the window's norm (torchaudio's ``normalized=True``),
    the mel filterbank from 20 Hz, then ``clip((20 log10(S) - 20 + 100) /
    100, 0, 1)``."""
    y = np.clip(y, -1.0, 1.0)
    win_length = hop * 4
    window = sp_signal.get_window("hann", win_length)
    pad = n_fft // 2
    yp = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(yp) - win_length) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(win_length)[None, :]
    spec = np.abs(np.fft.rfft(yp[idx] * window, n_fft, axis=1)).T
    spec = spec / np.sqrt((window ** 2).sum())
    mel = _mel_filterbank(sr, n_fft, n_mels, 20.0, sr / 2.0) @ spec
    mel = 20 * np.log10(np.clip(mel, 1e-5, None)) - 20
    return np.clip((mel + 100) / 100, 0.0, 1.0)


def spec_transform(filename: str, indir: str, outdir: str, se: bool = True) -> str:
    """Write ``filename``'s features (SE or mel) as float32 to
    ``<outdir>/<relative path>.spec.npy``; returns that path."""
    if se:
        sxx, _, _ = make_spectrum(filename)
    else:
        sxx = mel_transform(load_wav(filename, 16000)[0])
    out = f"{filename.replace(indir, outdir)}.spec.npy"
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.save(out, sxx.astype(np.float32))
    return out


def preprocess_dir(indir: str, outdir: str, se: bool = True, max_workers: int = 10) -> list[str]:
    """:func:`spec_transform` of every ``.wav`` under ``indir`` (sorted,
    recursive) on ``max_workers`` processes; returns the written paths."""
    files = sorted(glob(f"{indir}/**/*.wav", recursive=True))
    os.makedirs(outdir, exist_ok=True)
    with ProcessPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(spec_transform, files, [indir] * len(files), [outdir] * len(files),
                           [se] * len(files)))
