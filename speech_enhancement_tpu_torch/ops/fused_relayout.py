"""Axis swap ``[B, F, T, C] -> [B, T, F, C]`` for CUDA (K6).

Replaces ``speech_enhancement_tpu/ops/pallas_relayout.py`` (``_swap_kernel``
via ``_swap_call``, behind ``swap_seq_axes``).  The kernel lives in
``csrc/relayout.cu``, whose header says what bounds it.  ``TSCB(
fused_relayout=True)`` routes the fold between its time and freq
conformers through :func:`swap_seq_axes`, whose backward is the same swap
the other way.

The wrapper launches the kernel for a CUDA tensor and takes the plain
PyTorch version, :func:`swap_seq_axes_reference`, only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from speech_enhancement_tpu_torch.ops import _native

__all__ = ["build", "swap_seq_axes", "swap_seq_axes_reference"]

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, y, batch, a1, a2, row_bytes, elem_bytes, stream
    "se_swap_axes": [_P, _P, _I, _I, _I, _I, _I, _P],
}


_swap_fn = None  # se_swap_axes, resolved once at the first launch


def build() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/relayout.cu``."""
    global _swap_fn
    lib = _native.load("relayout", _SIGNATURES)
    _swap_fn = lib.se_swap_axes
    return lib


def swap_seq_axes_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the swap: ``x.transpose(1, 2).contiguous()``."""
    return x.transpose(1, 2).contiguous()


def _check(x: torch.Tensor) -> None:
    """Refuse what the kernel cannot take, before any launch."""
    if x.ndim != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"expected a 4-D tensor of {_DTYPES}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.numel() >= 2 ** 31 or x.shape[0] > 65535:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's 32-bit "
                         f"indexing or its grid (batch <= 65535)")


def _swap(x: torch.Tensor) -> torch.Tensor:
    device = x.device
    if device.type == "cpu":
        return swap_seq_axes_reference(x)
    if device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {device}")
    _check(x)
    x = x.contiguous()
    b, a1, a2, c = x.shape
    y = x.new_empty((b, a2, a1, c))
    if y.numel() == 0:
        return y
    if _swap_fn is None:
        build()
    elem = x.element_size()
    status = _swap_fn(x.data_ptr(), y.data_ptr(), b, a1, a2, c * elem, elem,
                      _native.current_stream(device))
    if status:
        _native.check(status, "se_swap_axes")
    _native.launches["swap_seq_axes"] += 1
    return y


class _SwapSeqAxes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _swap(x)

    @staticmethod
    def backward(ctx, g):
        return _swap(g)


def swap_seq_axes(x: torch.Tensor) -> torch.Tensor:
    """``[B, F, T, C] -> [B, T, F, C]``, contiguous (both directions are
    this same swap).  Differentiable: the gradient is swapped back; a
    tensor that needs no gradient skips the autograd node."""
    if x.requires_grad and torch.is_grad_enabled():
        return _SwapSeqAxes.apply(x)
    return _swap(x)
