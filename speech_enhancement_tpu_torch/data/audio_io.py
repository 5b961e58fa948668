"""Host-side wav IO and resampling (the port's copy of
speech_enhancement_tpu/data/audio_io.py).

``librosa.load(path, sr=16000)``'s contract on scipy: read any PCM or
float wav, average to mono, resample to the target rate with a polyphase
filter, return float32 in [-1, 1].
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sp_signal
from scipy.io import wavfile


def load_wav(path, sr: int | None = 16000) -> tuple[np.ndarray, int]:
    """librosa.load-compatible: returns (float32 mono signal, sample_rate)."""
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    if sr is not None and sr != file_sr:
        g = np.gcd(int(sr), int(file_sr))
        x = sp_signal.resample_poly(x, sr // g, file_sr // g).astype(np.float32)
        file_sr = sr
    return x, file_sr


def save_wav(path, signal: np.ndarray, sr: int = 16000) -> None:
    """torchaudio.save-compatible 16-bit PCM writer (inference_gan.py:125)."""
    x = np.asarray(signal, np.float32)
    if x.ndim == 2:
        x = x[0]
    pcm = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    wavfile.write(path, sr, pcm)
