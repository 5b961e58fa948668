"""Fused STFT -> compress (K4) and uncompress -> iSTFT (K5) for CUDA.

Replace ``speech_enhancement_tpu/ops/pallas_stft.py`` (``pallas_stft`` /
``_stft_kernel`` and ``pallas_istft`` / ``_istft_kernel``).  The kernels
live in ``csrc/stft.cu``, whose header says what bounds them on an H100
and how they are laid out.  Both are 3xTF32 tensor-core GEMMs folded by the
DFT's symmetry about n_fft / 2: K4 of each frame's even and odd parts
against :func:`stft_basis`, K5 of the uncompressed spectrum against
:func:`istft_basis` (C - S and C + S give the frame's two halves), its
overlap-add, envelope and trim in the same kernel.  The wrapper builds
each basis once per (n_fft, device) in the order the kernel reads it
(:func:`basis_fragment_order`).  ``Enhancer(fused_stft=True)`` routes the
serving featurization through them.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch version (``stft_reference`` / ``istft_reference``) only for a
CPU tensor.  The plain versions follow the Pallas semantics, which gate
the compress on ``|X|^2 > 1e-24`` where ``ops/stft.py`` gates on
``|X| > 0``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.ops.stft import istft, stft

__all__ = ["basis_fragment_order", "build", "fused_stft", "fused_istft", "istft_basis",
           "istft_occupancy", "istft_reference", "stft_basis", "stft_reference", "supports"]

_COMP_TYPES = ("pow", "none")
_MAX_R = 8  # csrc/stft.cu kMaxR
_TILE_BINS = 104  # csrc/stft.cu kBins: bins per K4 block, n per K5 chunk
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, basis, out, batch, L, T, n_fft, hop, k_pad, n_tiles, compress, stream
    "se_stft": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # spec, basis, out, batch, T, n_fft, hop, out_len, k_pad, n_chunks, compress, stream
    "se_istft": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # n_fft, hop, k_pad, *m_tiles, *smem_bytes, *blocks
    "se_istft_occupancy": [_I, _I, _I] + [ctypes.POINTER(ctypes.c_int)] * 3,
}


def build() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/stft.cu``."""
    return _native.load("stft", _SIGNATURES)


def stft_basis(n_fft: int) -> torch.Tensor:
    """K4's folded window-DFT basis, fp32 ``[2, k_pad, f_pad]``: part 0 is
    ``c_k w[k] cos(2 pi k f / n_fft)``, part 1 is ``-c_k w[k] sin(...)``
    for ``k <= n_fft / 2`` (w the periodic Hamming window, ``c_k = 1/2`` at
    ``k = 0`` and ``n_fft / 2``, else 1), built in float64 and rounded
    once; rows padded with zeros to ``k_pad``, a multiple of 8, and bins to
    ``f_pad``, whole tiles of 104.  Applied to the even part ``x[k] + x[N
    - k]`` and the odd part ``x[k] - x[N - k]`` of a frame (the partner of
    ``k = 0`` is itself), it gives the real and imaginary DFT of the
    windowed frame."""
    nfreq = n_fft // 2 + 1
    k_pad = -(-nfreq // 8) * 8
    f_pad = -(-nfreq // _TILE_BINS) * _TILE_BINS
    k = np.arange(nfreq)[:, None]
    ang = 2.0 * np.pi * k * np.arange(nfreq)[None, :] / n_fft
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * k / n_fft)
    window[[0, -1]] *= 0.5
    basis = np.zeros((2, k_pad, f_pad))
    basis[0, :nfreq, :nfreq] = window * np.cos(ang)
    basis[1, :nfreq, :nfreq] = -window * np.sin(ang)
    return torch.from_numpy(basis.astype(np.float32))


def istft_basis(n_fft: int) -> torch.Tensor:
    """K5's folded inverse window-DFT basis, fp32 ``[2, k_pad, n_pad]``:
    part 0 is ``w_f win[n] / n_fft * cos(2 pi f n / n_fft)``, part 1 the
    same with sin, for bins ``f`` (rows) and ``n <= n_fft / 2`` (columns)
    (``w_f`` = 1 at DC and Nyquist, else 2; win the periodic Hamming
    window), built in float64 and rounded once; rows padded with zeros to
    ``k_pad``, a multiple of 8, and columns to ``n_pad``, whole chunks of
    104.  With ``C = R @ part 0`` and ``S = I @ part 1`` for a frame's
    spectrum ``R + iI``, the windowed inverse real DFT of the frame is
    ``C[n] - S[n]`` at ``n`` and ``C[n] + S[n]`` at ``n_fft - n``."""
    nfreq = n_fft // 2 + 1
    k_pad = -(-nfreq // 8) * 8
    n_pad = -(-nfreq // _TILE_BINS) * _TILE_BINS
    f = np.arange(nfreq)[:, None]
    n = np.arange(nfreq)[None, :]
    ang = 2.0 * np.pi * f * n / n_fft
    weight = np.where((f == 0) | (f == nfreq - 1), 1.0, 2.0)
    scale = weight * (0.54 - 0.46 * np.cos(2.0 * np.pi * n / n_fft)) / n_fft
    basis = np.zeros((2, k_pad, n_pad))
    basis[0, :nfreq, :nfreq] = scale * np.cos(ang)
    basis[1, :nfreq, :nfreq] = scale * np.sin(ang)
    return torch.from_numpy(basis.astype(np.float32))


def basis_fragment_order(basis: torch.Tensor) -> torch.Tensor:
    """``basis`` ``[2, k_pad, f_pad]`` (:func:`stft_basis` or
    :func:`istft_basis`) in the order the B fragments of K4 and K5 read
    it: ``[tiles, k_pad / 8, 2, 104, 4, 2]``, where ``[tile, s, part, c, t,
    e]`` is row ``8 s + 4 e + t`` of column ``104 tile + c`` of ``part``."""
    _, k_pad, f_pad = basis.shape
    tiles = basis.view(2, k_pad // 8, 2, 4, f_pad // _TILE_BINS, _TILE_BINS)
    return tiles.permute(4, 1, 0, 5, 3, 2).contiguous()


_device_bases: dict[tuple, torch.Tensor] = {}


def _kernel_basis(make, n_fft: int, device: torch.device) -> torch.Tensor:
    """``make(n_fft)`` (:func:`stft_basis` or :func:`istft_basis`) in
    fragment order on ``device``, built once."""
    key = (make, n_fft, device)
    if key not in _device_bases:
        _device_bases[key] = basis_fragment_order(make(n_fft)).to(device)
    return _device_bases[key]


def istft_occupancy(n_fft: int = 400, hop: int = 100) -> tuple[int, int, int]:
    """K5's block at this geometry, as the entry point sizes it and the
    CUDA runtime places it: (frames per block, shared memory in bytes,
    resident blocks per SM)."""
    k_pad = istft_basis(n_fft).shape[1]
    m_tiles, smem, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _native.check(build().se_istft_occupancy(n_fft, hop, k_pad, ctypes.byref(m_tiles),
                                             ctypes.byref(smem), ctypes.byref(blocks)),
                  "se_istft_occupancy")
    return 16 * m_tiles.value, smem.value, blocks.value


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


def supports(n_fft: int, hop: int, comp_type: str) -> bool:
    """Whether K4 and K5 take this geometry and compression: ``comp_type``
    ``'pow'`` or ``'none'``, an even ``n_fft`` that is a multiple of
    ``hop``, and ``n_fft / hop <= 8``."""
    return (comp_type in _COMP_TYPES and n_fft % 2 == 0 and hop > 0 and n_fft % hop == 0
            and n_fft // hop <= _MAX_R)


def _check_geometry(n_fft: int, hop: int, comp_type: str) -> None:
    if comp_type not in _COMP_TYPES:
        raise ValueError(f"comp_type must be one of {_COMP_TYPES}, got {comp_type!r}")
    if not supports(n_fft, hop, comp_type):
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
    basis = _kernel_basis(stft_basis, n_fft, x.device)
    n_tiles, k_steps = basis.shape[:2]
    status = lib.se_stft(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(basis.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), batch, length, n_frames, n_fft, hop,
        8 * k_steps, n_tiles, int(comp_type == "pow"), _native.current_stream(x.device))
    _native.check(status, "se_stft")
    _native.launches["stft_compress"] += 1
    return out


def fused_istft(spec: torch.Tensor, n_fft: int = 400, hop: int = 100,
                comp_type: str = "pow", length: int | None = None) -> torch.Tensor:
    """Fused (optionally power-uncompressed) iSTFT: complex64 ``[B, T, F]``
    -> float32 ``[B, min(length, hop * (T - 1))]``."""
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
    basis = _kernel_basis(istft_basis, n_fft, spec.device)
    n_chunks, k_steps = basis.shape[:2]
    status = lib.se_istft(
        ctypes.c_void_p(spec.data_ptr()), ctypes.c_void_p(basis.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), batch, n_frames, n_fft, hop, out_len,
        8 * k_steps, n_chunks, int(comp_type == "pow"), _native.current_stream(spec.device))
    _native.check(status, "se_istft")
    _native.launches["uncompress_istft"] += 1
    return out
