"""The middle of the conformers' conv module, for CUDA: GLU -> zero pad ->
depthwise conv -> eval BatchNorm -> Swish as one kernel.

    g   = GLU(u, dim=1)                    u: [B, 2C, N]
    out = Swish(norm(conv(pad(g, (k // 2, k // 2)))))   [B, C, N]

The kernel lives in ``csrc/conv_module.cu``, whose header says what bounds
it; it replaces no TPU kernel (XLA fuses this chain on the TPU), but the
six to eight eager kernels of the chain.  ``ConvModule.after_norm`` asks
:func:`eager_reason` whether the kernel takes its operands and then calls
:func:`glu_conv_swish`; where it does not (autograd on, BatchNorm in
training mode, a CPU tensor, another dtype, an even or longer kernel, a
grid beyond the kernel's indexing) the module runs its eager layers.

The wrapper launches the kernel for CUDA tensors and takes the plain
PyTorch version, :func:`glu_conv_swish_reference`, only for CPU tensors:
that version is the module's eager op sequence, so on the CPU the wrapper
gives the eager numbers bit for bit.  ``u`` may be channels-major or, as
cuDNN leaves a pointwise conv over a channels-last input, a ``[B, N, 2C]``
contiguous tensor seen as ``[B, 2C, N]``: the kernel reads either layout
from its strides (:func:`u_layout`).

Under a profiler session each launch counts ``convmod.launches`` and
``convmod.bytes`` (``utils.profiling.count``): the least bytes of the call,
u read once and the output written once, weights left out.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.utils.profiling import count

__all__ = ["build", "eager_reason", "glu_conv_swish", "glu_conv_swish_reference", "u_layout"]

_DTYPES = (torch.float32, torch.bfloat16)
MAX_TAPS = 31
TILE, GROUP = 128, 32  # output frames and channels a block, as the kernel has them
MAX_BLOCKS = MAX_SEQ_ELEMS = 2**31 - 1  # the grid's blocks; u's elements a sequence
# u's layouts, as the C entry point numbers them
COLS, ROWS = 0, 1
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # u, w, wb, gamma, beta, mean, var, out, batch, channels, seq, taps, rows,
    # elem_bytes, eps, stream
    "se_glu_conv_swish": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _P],
}

_fn = None  # se_glu_conv_swish, resolved once at the first launch


def build() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/conv_module.cu``."""
    global _fn
    lib = _native.load("conv_module", _SIGNATURES)
    _fn = lib.se_glu_conv_swish
    return lib


def glu_conv_swish_reference(u: torch.Tensor, conv: nn.Conv1d, norm: nn.BatchNorm1d
                             ) -> torch.Tensor:
    """Plain version: the conv module's eager ops, ``F.glu``, ``F.pad`` by
    ``k // 2`` on each side, ``conv``, ``norm`` (the module, in whatever
    mode it is in) and ``x * sigmoid(x)``."""
    pad = conv.kernel_size[0] // 2
    x = norm(conv(F.pad(F.glu(u, dim=1), (pad, pad))))
    return x * torch.sigmoid(x)


def u_layout(u: torch.Tensor) -> int:
    """How the kernel reads ``u``: :data:`COLS` for a contiguous tensor,
    :data:`ROWS` for a ``[B, 2C, N]`` view of a contiguous ``[B, N, 2C]``
    (a pointwise conv's channels-last output), else -1 (the wrapper then
    copies it to channels-major)."""
    if u.is_contiguous():
        return COLS
    if u.ndim == 3 and u.transpose(1, 2).is_contiguous():
        return ROWS
    return -1


def _fits(u: torch.Tensor) -> bool:
    """Whether the kernel indexes ``u``: its blocks fit in the grid, and a
    sequence's offsets in 32 bits."""
    b, c2, n = u.shape
    return b * -(-c2 // 2 // GROUP) * -(-n // TILE) <= MAX_BLOCKS and c2 * n <= MAX_SEQ_ELEMS


def eager_reason(u: torch.Tensor, conv: nn.Conv1d, padding: tuple[int, int],
                 norm: nn.BatchNorm1d) -> str | None:
    """Why the conv module's middle runs its eager layers on these operands,
    or None where :func:`glu_conv_swish` takes them on the card: autograd
    off, ``norm`` in eval mode, fp32 or bf16, a kernel of odd size padded
    ``(k // 2, k // 2)``, operands the wrapper takes (:func:`_check`), a
    CUDA tensor and a grid the kernel can index."""
    k = conv.kernel_size[0]
    if torch.is_grad_enabled():
        return "autograd is on"
    if norm.training:
        return "BatchNorm is in training mode"
    if u.dtype not in _DTYPES:
        return f"dtype {u.dtype} (the kernel takes fp32 or bf16)"
    if k % 2 == 0 or tuple(padding) != (k // 2, k // 2):
        return f"kernel size {k} padded {tuple(padding)} (the kernel takes odd sizes, centred)"
    try:
        _check(u, conv, norm)
    except ValueError as exc:
        return str(exc)
    if u.device.type != "cuda":
        return f"a {u.device.type} tensor"
    if not u.numel() or not _fits(u):
        return f"shape {tuple(u.shape)} outside the kernel's indexing"
    return None


def _check(u: torch.Tensor, conv: nn.Conv1d, norm: nn.BatchNorm1d) -> None:
    """Refuse operands the kernel cannot take, on any device, before any
    launch."""
    k, c = conv.kernel_size[0], conv.out_channels
    if u.ndim != 3 or u.shape[1] != 2 * c:
        raise ValueError(f"u must be [B, {2 * c}, N] for {c} channels, got {tuple(u.shape)}")
    if (conv.groups != c or conv.in_channels != c or conv.stride != (1,)
            or conv.dilation != (1,) or conv.padding != (0,)):
        raise ValueError(f"conv must be depthwise over {c} channels, unpadded, stride and "
                         f"dilation 1, got {conv}")
    if k % 2 == 0 or k > MAX_TAPS:
        raise ValueError(f"the kernel takes odd sizes up to {MAX_TAPS}, got {k}")
    if conv.bias is None:
        raise ValueError("conv must have a bias")
    if (norm.num_features != c or norm.running_mean is None or norm.running_var is None
            or norm.weight is None):
        raise ValueError(f"norm must be an affine BatchNorm over {c} channels with running "
                         f"statistics, got {norm}")
    dtype, device = u.dtype, u.device
    for name, t in (("conv weight", conv.weight), ("conv bias", conv.bias),
                    ("norm weight", norm.weight), ("norm bias", norm.bias),
                    ("running mean", norm.running_mean), ("running var", norm.running_var)):
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, u {dtype} on {device}")


def count_launch(u: torch.Tensor) -> None:
    """Count one launch on ``u``: in ``_native.launches``, and under a profiler
    session ``convmod.launches`` and ``convmod.bytes`` (u read once, its
    half written once)."""
    _native.launches["glu_conv_swish"] += 1
    count("convmod.launches", 1)
    count("convmod.bytes", u.numel() * u.element_size() * 3 // 2)


def glu_conv_swish(u: torch.Tensor, conv: nn.Conv1d, norm: nn.BatchNorm1d) -> torch.Tensor:
    """``Swish(norm(conv(pad(GLU(u)))))``, ``[B, C, N]`` channels-major, with
    the padding ``k // 2`` on each side and ``norm`` by its running
    statistics.  One launch on PyTorch's current stream for CUDA tensors
    (fp32 or bf16, arithmetic in fp32); the plain version for CPU tensors.
    Without gradients: the conv module takes it only where
    :func:`eager_reason` finds none."""
    _check(u, conv, norm)
    device = u.device
    if device.type == "cpu":
        return glu_conv_swish_reference(u, conv, norm)
    if device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {device}")
    if u.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes {_DTYPES}, got {u.dtype}")
    if not _fits(u):
        raise ValueError(f"shape {tuple(u.shape)} is outside the kernel's indexing")
    layout = u_layout(u)
    if layout < 0:
        u, layout = u.contiguous(), COLS
    b, c2, n = u.shape
    c = c2 // 2
    out = torch.empty((b, c, n), dtype=u.dtype, device=device)
    if out.numel():
        if _fn is None:
            build()
        weight = conv.weight.contiguous()  # [C, 1, k]
        status = _fn(u.data_ptr(), weight.data_ptr(), conv.bias.data_ptr(),
                     norm.weight.data_ptr(), norm.bias.data_ptr(), norm.running_mean.data_ptr(),
                     norm.running_var.data_ptr(), out.data_ptr(), b, c, n, conv.kernel_size[0],
                     layout, u.element_size(), norm.eps, _native.current_stream(device))
        if status:
            _native.check(status, "se_glu_conv_swish")
        count_launch(u)
    return out
