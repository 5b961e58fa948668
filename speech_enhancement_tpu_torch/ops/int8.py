"""int8 convolutions for the TSCNet's serving path (port of
speech_enhancement_tpu/ops/int8.py).

The same scheme as the JAX package: a dynamic symmetric scale for the
whole activation tensor, static symmetric per-output-channel weight
scales (``max(amax, 1e-12) / 127``, rounding half to even, clipped to
+-127), and the VALID conv as ``kh * kw`` shifted-slice products, each a
``[B * H_out * W_out, Cin] x [Cin, Cout]`` int8 GEMM accumulated in int32,
then ``acc * (sx * sw) + bias`` in fp32 and a cast to the input's dtype.

The JAX function is XLA ``dot_general``s, not a Pallas kernel, so on a
CUDA tensor each tap's GEMM is ``torch._int_mm`` (cuBLASLt's int8 tensor
cores); a shape it refuses (rows <= 16, Cin or Cout not a multiple of 8)
raises.  On a CPU tensor the plain version runs: the int8 values
multiplied as fp32, which is exact here (a tap sums at most 256 products
of at most 127^2, under 2^24).  ``_native.launches["int8_conv2d"]``
counts the tap GEMMs that took the card's route.

:class:`QuantConv2d` is an ``nn.Conv2d`` with the same ``weight`` /
``bias`` (so a float model's ``state_dict`` loads unchanged) whose forward
zero-pads by its own ``padding`` and runs :func:`int8_conv2d`.  Serving
only: nothing here has a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_tpu_torch.ops import _native


def quantize_symmetric(x: torch.Tensor, dim=None, eps: float = 1e-12):
    """Symmetric linear quantization to int8: ``(q int8, scale fp32)`` with
    ``x ~= q * scale``.  ``dim=None``: one scale for the whole tensor;
    ``dim=(1, 2, 3)`` on a ``[Cout, Cin, kh, kw]`` weight: one per output
    channel (kept as ``[Cout, 1, 1, 1]``)."""
    xf = x.float()
    amax = xf.abs().amax() if dim is None else xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp_min(amax, eps) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _tap_matmul(a: torch.Tensor, b: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8`` -> int32: cuBLASLt on the card,
    the exact fp32 product on the CPU (and with ``plain``)."""
    if a.is_cuda and not plain:
        m, k = a.shape
        n = b.shape[1]
        if m <= 16 or k % 8 or n % 8:
            raise ValueError(f"torch._int_mm takes [M, K] x [K, N] with M > 16 and K, N "
                             f"multiples of 8; got M={m} K={k} N={n}")
        _native.launches["int8_conv2d"] += 1
        return torch._int_mm(a, b)
    return (a.float() @ b.float()).to(torch.int32)


def int8_accumulate(xq: torch.Tensor, wq: torch.Tensor, stride=(1, 1),
                    dilation=(1, 1), plain: bool = False) -> torch.Tensor:
    """The int32 accumulator ``[B, H_out, W_out, Cout]`` of the VALID conv of
    int8 ``xq [B, Cin, H, W]`` with int8 ``wq [Cout, Cin, kh, kw]``: one
    GEMM per tap (``plain``: the fp32 products on any device, the version
    the card's route is held against)."""
    cout, cin, kh, kw = wq.shape
    b, _, h, w = xq.shape
    sh, sw = stride
    dh, dw = dilation
    h_out = (h - (kh - 1) * dh - 1) // sh + 1
    w_out = (w - (kw - 1) * dw - 1) // sw + 1
    x_nhwc = xq.permute(0, 2, 3, 1)
    acc = None
    for i in range(kh):
        for j in range(kw):
            sl = x_nhwc[:, i * dh: i * dh + (h_out - 1) * sh + 1: sh,
                        j * dw: j * dw + (w_out - 1) * sw + 1: sw, :]
            # the tap's weight column-major, as cuBLASLt takes it
            part = _tap_matmul(sl.reshape(-1, cin), wq[:, :, i, j].contiguous().t(), plain)
            acc = part if acc is None else acc + part
    return acc.view(b, h_out, w_out, cout)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
                stride=(1, 1), dilation=(1, 1), out_dtype: torch.dtype | None = None,
                plain: bool = False) -> torch.Tensor:
    """VALID-padding NCHW conv of ``x [B, Cin, H, W]`` with ``weight [Cout,
    Cin, kh, kw]`` on int8 operands with int32 accumulation, rescaled in
    fp32 to ``out_dtype`` (default: ``x``'s dtype).  ``plain``: the taps'
    fp32 products also on a CUDA tensor."""
    xq, sx = quantize_symmetric(x)
    wq, sw = quantize_symmetric(weight, dim=(1, 2, 3))
    acc = int8_accumulate(xq, wq, tuple(stride), tuple(dilation), plain)
    y = acc.float() * (sx * sw.view(-1))
    if bias is not None:
        y = y + bias.float()
    return y.permute(0, 3, 1, 2).to(out_dtype or x.dtype)


class QuantConv2d(nn.Conv2d):
    """``nn.Conv2d`` (zero padding) whose forward runs :func:`int8_conv2d`:
    the same parameters and ``state_dict`` keys, its static ``padding``
    applied before the VALID int8 conv."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = self.padding
        if ph or pw:
            x = F.pad(x, (pw, pw, ph, ph))
        return int8_conv2d(x, self.weight, self.bias, stride=self.stride,
                           dilation=self.dilation)
