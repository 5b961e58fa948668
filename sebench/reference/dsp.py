"""Plain featurization: RMS normalization, the power-compressed STFT
(Hamming window, centre reflect padding, real DFT as matmuls) and its
inverse (window-sum-square normalized overlap-add), as
``torch.stft``/``torch.istft`` define them, time-major ``[B, T, F]``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hamming(n_fft: int, device) -> torch.Tensor:
    k = np.arange(n_fft)
    return torch.as_tensor((0.54 - 0.46 * np.cos(2.0 * np.pi * k / n_fft)).astype(np.float32),
                           device=device)


def _dft(n_fft: int, device, dtype):
    n = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * f / n_fft
    return (torch.as_tensor(np.cos(ang), dtype=dtype, device=device),
            torch.as_tensor(-np.sin(ang), dtype=dtype, device=device))


def _idft(n_fft: int, device, dtype):
    nfreq = n_fft // 2 + 1
    f = np.arange(nfreq)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * f * n / n_fft
    w = np.full((nfreq, 1), 2.0)
    w[0, 0] = w[-1, 0] = 1.0
    return (torch.as_tensor(w * np.cos(ang) / n_fft, dtype=dtype, device=device),
            torch.as_tensor(-w * np.sin(ang) / n_fft, dtype=dtype, device=device))


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    b, t, n_fft = frames.shape
    length = n_fft + hop * (t - 1)
    return F.fold(frames.transpose(1, 2), output_size=(1, length), kernel_size=(1, n_fft),
                  stride=(1, hop)).reshape(b, length)


def stft(x: torch.Tensor, n_fft: int, hop: int):
    """(re, im) of ``[B, L]`` -> each ``[B, T, F]``, T = L // hop + 1."""
    pad = n_fft // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop) * hamming(n_fft, x.device)
    cos_m, msin_m = _dft(n_fft, x.device, x.dtype)
    return frames @ cos_m, frames @ msin_m


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int, length: int):
    window = hamming(n_fft, re.device)
    c_inv, s_inv = _idft(n_fft, re.device, re.dtype)
    sig = _overlap_add((re @ c_inv + im @ s_inv) * window, hop)
    env = _overlap_add((window * window).expand(1, re.shape[1], n_fft), hop)
    sig = sig / torch.where(env > 1e-11, env, torch.ones_like(env))
    pad = n_fft // 2
    return sig[:, pad:sig.shape[1] - pad][:, :length]


def _rescale(re, im, exponent: float):
    """(re, im) with the magnitude raised to ``exponent``; zero bins stay 0."""
    mag = torch.sqrt(re * re + im * im)
    nz = mag > 0.0
    safe = torch.where(nz, mag, torch.ones_like(mag))
    gain = torch.where(nz, safe ** exponent / safe, torch.zeros_like(mag))
    return re * gain, im * gain


def compressed_stft(x, n_fft: int, hop: int, power: float):
    return _rescale(*stft(x, n_fft, hop), power)


def uncompressed_istft(re, im, n_fft: int, hop: int, power: float, length: int):
    return istft(*_rescale(re, im, 1.0 / power), n_fft, hop, length)


def rms_gain(noisy: torch.Tensor) -> torch.Tensor:
    """Per-row gain sqrt(L / sum(noisy^2)); 1 for a silent row."""
    energy = torch.sum(noisy ** 2, dim=-1, keepdim=True)
    nz = energy > 0.0
    one = torch.ones_like(energy)
    return torch.where(nz, torch.sqrt(noisy.shape[-1] / torch.where(nz, energy, one)), one)
