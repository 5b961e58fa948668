"""Residual add and LayerNorm over the channel axis, for CUDA.

    r = x + scale * y              (y optional)
    n = LayerNorm(r) [+ skip]

The kernel lives in ``csrc/add_layer_norm.cu``, whose header says what
bounds it; it replaces no TPU kernel (XLA fuses these on the TPU), but
aten's LayerNorm and the elementwise adds around it.
``ConformerBlock``'s forward without autograd calls :func:`add_layer_norm`
for each of its five LayerNorms, with the residual add before it and the
TSCB's outer residual (``skip``) after the last one.

The wrapper launches the kernel for CUDA tensors and takes the plain
PyTorch version, :func:`add_layer_norm_reference`, only for CPU tensors:
that version is the conformer's eager op sequence, so on the CPU the route
gives the eager numbers bit for bit.  ``y`` may be row-major or, as the
conv module's output seen through its transpose, channels-major: the
kernel reads either layout from its strides (:func:`y_layout`).

Under a profiler session each launch counts ``norm.launches`` and
``norm.bytes`` (``utils.profiling.count``): the least bytes of the call,
each input read once and each output written once, weights left out.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.utils.profiling import count

__all__ = ["add_layer_norm", "add_layer_norm_reference", "build", "y_layout"]

_DTYPES = (torch.float32, torch.bfloat16)
# y's layouts, as the C entry point numbers them
NO_Y, ROWS, COLS = 0, 1, 2
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # x, y, skip, w, b, r, n, rows, channels, seq, mode, elem_bytes, s, eps, stream
    "se_add_layer_norm": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _F, _P],
}

_fn = None  # se_add_layer_norm, resolved once at the first launch


def build() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/add_layer_norm.cu``."""
    global _fn
    lib = _native.load("add_layer_norm", _SIGNATURES)
    _fn = lib.se_add_layer_norm
    return lib


def add_layer_norm_reference(x: torch.Tensor, y: torch.Tensor | None, scale: float,
                             norm: nn.LayerNorm, skip: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(r, n)`` by the eager ops, ``y * scale + x`` (``y +
    x`` at scale 1; ``x`` itself without y), ``norm(r)``, then ``+ skip``."""
    if y is None:
        r = x
    elif scale == 1:
        r = y + x
    else:
        r = y * scale + x
    n = F.layer_norm(r, norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return r, n if skip is None else n + skip


def y_layout(y: torch.Tensor) -> int:
    """How the kernel reads ``y``: :data:`ROWS` for a contiguous tensor,
    :data:`COLS` for a ``[B, N, C]`` view of a contiguous ``[B, C, N]``
    (the conv module's output through its transpose), else -1 (the wrapper
    then copies it to rows)."""
    if y.is_contiguous():
        return ROWS
    if y.ndim == 3 and y.transpose(1, 2).is_contiguous():
        return COLS
    return -1


def _check(x, y, skip, norm) -> tuple[torch.Tensor, torch.Tensor]:
    """Refuse operands that disagree, on any device, before any launch;
    returns the norm's weight and bias."""
    w, b = norm.weight, norm.bias
    c = x.shape[-1] if x.ndim else 0
    if w is None or b is None or norm.normalized_shape != (c,):
        raise ValueError(f"the norm must be an affine LayerNorm over the last axis of x "
                         f"({c} channels), got {norm}")
    dtype, device = x.dtype, x.device
    for name, t in (("y", y), ("skip", skip), ("weight", w), ("bias", b)):
        if t is not None and (t.dtype != dtype or t.device != device):
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x {dtype} on {device}")
    for name, t in (("y", y), ("skip", skip)):
        if t is not None and t.shape != x.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, x {tuple(x.shape)}")
    return w, b


def add_layer_norm(x: torch.Tensor, y: torch.Tensor | None, scale: float,
                   norm: nn.LayerNorm, skip: torch.Tensor | None = None,
                   keep_sum: bool = True) -> tuple[torch.Tensor | None, torch.Tensor]:
    """``(r, n)``: ``r = x + scale * y`` (``x`` itself when ``y`` is None)
    and ``n = norm(r)``, plus ``skip`` when given.  ``keep_sum=False``
    returns None for r, which the kernel then does not write.  One launch
    on PyTorch's current stream for CUDA tensors (fp32 or bf16, statistics
    in fp32); the plain version for CPU tensors.  Without gradients: the
    conformer takes it only where autograd is off."""
    w, b = _check(x, y, skip, norm)
    device = x.device
    if device.type == "cpu":
        r, n = add_layer_norm_reference(x, y, scale, norm, skip)
        return (r if keep_sum else None), n
    if device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes {_DTYPES}, got {x.dtype}")
    x = x.contiguous()
    mode = NO_Y
    if y is not None:
        mode = y_layout(y)
        if mode < 0:
            y, mode = y.contiguous(), ROWS
    if skip is not None:
        skip = skip.contiguous()
    n = torch.empty_like(x)
    r = torch.empty_like(x) if keep_sum and y is not None else None
    numel = x.numel()
    if numel:
        if _fn is None:
            build()
        channels = x.shape[-1]
        status = _fn(x.data_ptr(), None if y is None else y.data_ptr(),
                     None if skip is None else skip.data_ptr(), w.data_ptr(), b.data_ptr(),
                     None if r is None else r.data_ptr(), n.data_ptr(), numel // channels,
                     channels, y.shape[1] if mode == COLS else 0, mode, x.element_size(),
                     scale, norm.eps, _native.current_stream(device))
        if status:
            _native.check(status, "se_add_layer_norm")
        _native.launches["add_layer_norm"] += 1
        count("norm.launches", 1)
        count("norm.bytes", numel * x.element_size()
              * (2 + (y is not None) + (skip is not None) + (r is not None)))
    return (x if y is None and keep_sum else r), n
