"""Fused STFT -> compress (K4) and uncompress -> iSTFT (K5) for CUDA.

Replace ``speech_enhancement_tpu/ops/pallas_stft.py`` (``pallas_stft`` /
``_stft_kernel`` and ``pallas_istft`` / ``_istft_kernel``).  The kernels
live in ``csrc/stft.cu``, whose header says what bounds them on an H100
and how they are laid out.  ``Enhancer(fused_stft=True)`` routes the
serving featurization through them.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch version (``stft_reference`` / ``istft_reference``) only for a
CPU tensor.  The plain versions follow the Pallas semantics, which gate
the compress on ``|X|^2 > 1e-24`` where ``ops/stft.py`` gates on
``|X| > 0``.
"""

from __future__ import annotations

import ctypes

import torch

from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.ops.stft import istft, stft

__all__ = ["build", "fused_stft", "fused_istft", "stft_reference", "istft_reference"]

# kernel launches of each wrapper since import (or since a caller reset it)
stft_launches = 0
istft_launches = 0

_COMP_TYPES = ("pow", "none")
_MAX_R = 8  # csrc/stft.cu kMaxR
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, out, batch, L, T, n_fft, hop, compress, stream
    "se_stft": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # spec, out, batch, T, n_fft, hop, out_len, compress, stream
    "se_istft": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def build() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/stft.cu``."""
    return _native.load("stft", _SIGNATURES)


def _gated_rescale(spec: torch.Tensor, exponent: float) -> torch.Tensor:
    """``spec * (|spec|^2)^exponent`` where ``|spec|^2 > 1e-24``, else 0."""
    mag2 = spec.real * spec.real + spec.imag * spec.imag
    live = mag2 > 1e-24
    scale = torch.where(live, torch.where(live, mag2, 1.0) ** exponent, 0.0)
    return spec * scale


def stft_reference(x: torch.Tensor, n_fft: int = 400, hop: int = 100,
                   comp_type: str = "pow") -> torch.Tensor:
    """Plain version of :func:`fused_stft`: reflect-padded windowed real
    DFT, then ``|X|^0.3`` compression for ``comp_type='pow'``."""
    spec = stft(x, n_fft, hop)
    if comp_type == "pow":
        spec = _gated_rescale(spec, -0.35)
    return spec


def istft_reference(spec: torch.Tensor, n_fft: int = 400, hop: int = 100,
                    comp_type: str = "pow",
                    length: int | None = None) -> torch.Tensor:
    """Plain version of :func:`fused_istft`: ``|X|^(1/0.3)`` uncompression
    for ``comp_type='pow'``, then the window-sum-square normalized iSTFT
    with center trim, cut to ``length``."""
    if comp_type == "pow":
        spec = _gated_rescale(spec, (1.0 / 0.3 - 1.0) / 2.0)
    return istft(spec, n_fft, hop, length=length)


def _check_geometry(n_fft: int, hop: int, comp_type: str) -> None:
    if comp_type not in _COMP_TYPES:
        raise ValueError(f"comp_type must be one of {_COMP_TYPES}, got {comp_type!r}")
    if n_fft % 2 or hop <= 0 or n_fft % hop or n_fft // hop > _MAX_R:
        raise ValueError(
            f"the STFT kernels take an even n_fft that is a multiple of hop "
            f"with n_fft/hop <= {_MAX_R}; got n_fft={n_fft}, hop={hop}")


def _check_kernel_input(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")


def fused_stft(x: torch.Tensor, n_fft: int = 400, hop: int = 100,
               comp_type: str = "pow") -> torch.Tensor:
    """Fused (optionally power-compressed) STFT: float32 ``[B, L]`` ->
    complex64 ``[B, T, n_fft // 2 + 1]`` with ``T = 1 + L // hop``."""
    global stft_launches
    _check_geometry(n_fft, hop, comp_type)
    if x.ndim == 1:
        x = x[None]
    if x.device.type == "cpu":
        return stft_reference(x, n_fft, hop, comp_type)
    _check_kernel_input(x, torch.float32, 2, "fused_stft")
    batch, length = x.shape
    if length <= n_fft // 2:
        raise ValueError(f"reflect padding needs L > {n_fft // 2}, got L={length}")
    n_frames = 1 + length // hop
    out = torch.empty((batch, n_frames, n_fft // 2 + 1), dtype=torch.complex64,
                      device=x.device)
    if batch == 0:
        return out
    lib = build()
    status = lib.se_stft(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        batch, length, n_frames, n_fft, hop, int(comp_type == "pow"),
        _native.current_stream(x.device))
    _native.check(status, "se_stft")
    stft_launches += 1
    return out


def fused_istft(spec: torch.Tensor, n_fft: int = 400, hop: int = 100,
                comp_type: str = "pow", length: int | None = None) -> torch.Tensor:
    """Fused (optionally power-uncompressed) iSTFT: complex64 ``[B, T, F]``
    -> float32 ``[B, min(length, hop * (T - 1))]``."""
    global istft_launches
    _check_geometry(n_fft, hop, comp_type)
    if spec.device.type == "cpu":
        return istft_reference(spec, n_fft, hop, comp_type, length)
    _check_kernel_input(spec, torch.complex64, 3, "fused_istft")
    batch, n_frames, nfreq = spec.shape
    if nfreq != n_fft // 2 + 1:
        raise ValueError(f"expected {n_fft // 2 + 1} bins, got {nfreq}")
    out_len = hop * (n_frames - 1)
    if length is not None:
        out_len = min(out_len, length)
    out = torch.empty((batch, out_len), dtype=torch.float32, device=spec.device)
    if out_len == 0 or batch == 0:
        return out
    lib = build()
    status = lib.se_istft(
        ctypes.c_void_p(spec.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        batch, n_frames, n_fft, hop, out_len, int(comp_type == "pow"),
        _native.current_stream(spec.device))
    _native.check(status, "se_istft")
    istft_launches += 1
    return out
