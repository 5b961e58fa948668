"""STFT / iSTFT featurization as real-DFT matmuls (port of ops/stft.py).

Semantics match ``torch.stft(x, n_fft, hop, window=hamming, onesided=True,
center=True, pad_mode='reflect')`` and the matching ``torch.istft``
(window-sum-square normalized overlap-add with threshold 1e-11, center
trim), in the JAX package's time-major ``[B, T, F]`` layout.  These are the
plain default featurization; ``ops/fused_stft.py`` holds the CUDA kernels
that ``Enhancer(fused_stft=True)`` uses instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "hamming_window",
    "frame_signal",
    "overlap_add",
    "stft",
    "istft",
    "power_compress",
    "power_uncompress",
    "compressed_stft",
    "uncompressed_istft",
    "normalize_batch",
    "batch_stft",
    "disassemble_spectrogram",
]


def hamming_window_np(n_fft: int) -> np.ndarray:
    """Periodic Hamming window, computed in float64 and stored float32."""
    k = np.arange(n_fft)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * k / n_fft)).astype(np.float32)


def hamming_window(n_fft: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hamming window, identical to ``torch.hamming_window(n_fft)``."""
    return torch.as_tensor(hamming_window_np(n_fft), dtype=dtype, device=device)


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int):
    """Forward real-DFT basis [n_fft, F] pair (cos, -sin) as float64 numpy."""
    n = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * f / n_fft
    return np.cos(ang), -np.sin(ang)


@functools.lru_cache(maxsize=8)
def idft_matrices(n_fft: int):
    """Inverse real-DFT basis [F, n_fft] pair such that
    frame = re @ C + im @ S (DC and Nyquist weighted 1, the rest 2)."""
    nfreq = n_fft // 2 + 1
    f = np.arange(nfreq)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * f * n / n_fft
    w = np.full((nfreq, 1), 2.0)
    w[0, 0] = 1.0
    w[-1, 0] = 1.0
    return w * np.cos(ang) / n_fft, -w * np.sin(ang) / n_fft


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Slice ``[B, L]`` (already padded) into overlapping ``[B, T, n_fft]``
    frames (a strided view)."""
    return x.unfold(-1, n_fft, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add ``[B, T, n_fft]`` frames at stride ``hop`` -> ``[B, L]``
    with ``L = n_fft + hop * (T - 1)``."""
    b, n_frames, n_fft = frames.shape
    length = n_fft + hop * (n_frames - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, length),
                 kernel_size=(1, n_fft), stride=(1, hop))
    return out.reshape(b, length)


def stft(x: torch.Tensor, n_fft: int = 400, hop: int = 100,
         window: torch.Tensor | None = None, center: bool = True) -> torch.Tensor:
    """Complex STFT of ``[B, L]`` -> ``[B, T, F]`` (time-major, freq-last)."""
    if x.ndim == 1:
        x = x[None]
    if window is None:
        window = hamming_window(n_fft, x.dtype, x.device)
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = frame_signal(x, n_fft, hop) * window
    cos_m, msin_m = dft_matrices(n_fft)
    re = frames @ torch.as_tensor(cos_m, dtype=x.dtype, device=x.device)
    im = frames @ torch.as_tensor(msin_m, dtype=x.dtype, device=x.device)
    return torch.complex(re, im)


def istft(spec: torch.Tensor, n_fft: int = 400, hop: int = 100,
          window: torch.Tensor | None = None, length: int | None = None,
          center: bool = True) -> torch.Tensor:
    """Inverse STFT of ``[B, T, F]`` -> ``[B, L]`` matching torch.istft:
    window-sum-square normalized overlap-add; ``center`` trims n_fft//2
    from each edge (default output length ``hop * (T - 1)``)."""
    re, im = spec.real, spec.imag
    n_frames = re.shape[1]
    if window is None:
        window = hamming_window(n_fft, re.dtype, re.device)
    c_inv, s_inv = idft_matrices(n_fft)
    frames = (re @ torch.as_tensor(c_inv, dtype=re.dtype, device=re.device)
              + im @ torch.as_tensor(s_inv, dtype=re.dtype, device=re.device))
    sig = overlap_add(frames * window, hop)
    wsq = (window * window).expand(1, n_frames, n_fft)
    env = overlap_add(wsq, hop)
    sig = sig / torch.where(env > 1e-11, env, torch.ones_like(env))
    if center:
        pad = n_fft // 2
        sig = sig[:, pad: sig.shape[1] - pad]
    if length is not None:
        sig = sig[:, :length]
    return sig


def _mag_rescale(spec: torch.Tensor, f) -> torch.Tensor:
    """``f(|spec|) / |spec|`` with 0 at zero bins."""
    mag = spec.abs()
    nz = mag > 0.0
    safe = torch.where(nz, mag, torch.ones_like(mag))
    if f == "log1p":
        new = torch.log1p(safe)
    elif f == "expm1":
        new = torch.expm1(safe)
    else:
        new = safe ** f
    return torch.where(nz, new / safe, torch.zeros_like(mag))


def power_compress(spec: torch.Tensor, comp_type: str | None = "pow") -> torch.Tensor:
    """Magnitude compression: ``pow`` mag^0.3, ``log`` log1p(mag),
    anything else the identity."""
    if comp_type not in ("pow", "log"):
        return spec
    return spec * _mag_rescale(spec, 0.3 if comp_type == "pow" else "log1p")


def power_uncompress(spec: torch.Tensor, comp_type: str | None = "pow") -> torch.Tensor:
    """Inverse of :func:`power_compress`."""
    if comp_type not in ("pow", "log"):
        return spec
    return spec * _mag_rescale(spec, 1.0 / 0.3 if comp_type == "pow" else "expm1")


def compressed_stft(signal: torch.Tensor, n_fft: int = 400, hop: int = 100,
                    window: torch.Tensor | None = None,
                    comp_type: str = "pow") -> torch.Tensor:
    """STFT followed by magnitude compression; ``comp_type='norm'``
    applies torch's normalized=True scaling (1/sqrt(N))."""
    spec = stft(signal, n_fft, hop, window)
    if comp_type == "norm":
        spec = spec / float(np.sqrt(n_fft))
    return power_compress(spec, comp_type)


def uncompressed_istft(spec: torch.Tensor, n_fft: int = 400, hop: int = 100,
                       window: torch.Tensor | None = None,
                       comp_type: str = "pow",
                       length: int | None = None) -> torch.Tensor:
    """Magnitude uncompression followed by iSTFT."""
    spec = power_uncompress(spec, comp_type)
    if comp_type == "norm":
        spec = spec * float(np.sqrt(n_fft))
    return istft(spec, n_fft, hop, window, length=length)


def normalize_batch(clean: torch.Tensor, noisy: torch.Tensor):
    """Per-utterance RMS gain c = sqrt(L / sum(noisy^2)) applied to both
    signals.  Returns (clean*c, noisy*c, c).  A digitally silent row gets
    c = 1, so serving batches with all-zero files stay finite."""
    energy = torch.sum(noisy ** 2.0, dim=-1, keepdim=True)
    nz = energy > 0.0
    one = torch.ones_like(energy)
    c = torch.where(nz, torch.sqrt(noisy.shape[-1] / torch.where(nz, energy, one)),
                    one)
    return clean * c, noisy * c, c


def batch_stft(clean: torch.Tensor, noisy: torch.Tensor, n_fft: int = 400,
               hop: int = 100):
    """The training featurization bundle (``ops/stft.py:258-267``):
    RMS-normalize both signals by the noisy gain, power-compress the STFT
    of both.  Returns ``(clean, noisy, clean_spec, noisy_spec,
    one_labels)``.  Plain and differentiable, as the JAX training path."""
    clean, noisy, _ = normalize_batch(clean, noisy)
    noisy_spec = compressed_stft(noisy, n_fft, hop, comp_type="pow")
    clean_spec = compressed_stft(clean, n_fft, hop, comp_type="pow")
    one_labels = torch.ones(clean.shape[0], dtype=clean.dtype, device=clean.device)
    return clean, noisy, clean_spec, noisy_spec, one_labels


def disassemble_spectrogram(spec: torch.Tensor):
    """(mag, real, imag) of a complex spectrogram (``ops/stft.py:288-290``)."""
    return spec.abs(), spec.real, spec.imag
