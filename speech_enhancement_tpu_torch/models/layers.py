"""Shared building blocks (port of speech_enhancement_tpu/models/layers.py).

NCHW / NCL like the reference torch modules; parameter names follow the
reference ``state_dict`` (``weight``, ``bias``, ``weight_orig``/``weight_u``/
``weight_v`` under spectral norm, ``slope``).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def kaiming_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Kaiming-normal (fan_in, ReLU gain) init in place: std sqrt(2 / fan_in)
    with fan_in = in_features * prod(kernel) (``layers.py:18-34``)."""
    fan_in = weight[0].numel()
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


def bias_001_(bias: torch.Tensor) -> None:
    """Bias fill 0.01 (``layers.py:37-39``)."""
    with torch.no_grad():
        bias.fill_(0.01)


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Kaiming-normal weights and 0.01 biases for every Linear and Conv of
    ``module``, and unit-normal Shaw tables (every Embedding), as the JAX
    initializers draw them."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            kaiming_normal_(m.weight, generator)
            if m.bias is not None:
                bias_001_(m.bias)
        elif isinstance(m, nn.Embedding):
            with torch.no_grad():
                m.weight.normal_(0.0, 1.0, generator=generator)


class PReLU(nn.Module):
    """Per-channel PReLU along ``dim`` (torch ``nn.PReLU`` applies it along
    dim 1; the mask decoder's output PReLU runs along frequency, the last
    axis).  ``num_parameters`` is 1 (shared) or the size of that axis."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25, dim: int = 1):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.full((num_parameters,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.ndim
        shape[self.dim] = -1
        alpha = self.weight.to(x.dtype).view(shape)
        return torch.where(x >= 0, x, alpha * x)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True) over the spatial axes of NCHW input,
    eps 1e-5, no running stats.  Statistics are taken in fp32 even for
    bf16 input; the output returns in the input dtype (``layers.py:62-82``)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True, correction=0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        shape = (1, -1, 1, 1)
        return y * self.weight.to(x.dtype).view(shape) + self.bias.to(x.dtype).view(shape)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swish(x)


class LearnableSigmoid(nn.Module):
    """``beta * sigmoid(slope * x)`` with a learnable per-feature slope
    (``layers.py:85-95``)."""

    def __init__(self, in_features: int = 1, beta: float = 1.0):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.beta * torch.sigmoid(self.slope.to(x.dtype) * x)


_remat = threading.local()


@contextlib.contextmanager
def recomputing():
    """Marks the forward that ``torch.utils.checkpoint`` re-runs during the
    backward: :class:`BatchNorm1d` leaves its running statistics alone
    inside it, so a rematerialized step updates them once, as JAX's remat
    does."""
    previous = getattr(_remat, "active", False)
    _remat.active = True
    try:
        yield
    finally:
        _remat.active = previous


def rematerialized(block: nn.Module, *inputs: torch.Tensor) -> torch.Tensor:
    """``block(*inputs)`` under ``torch.utils.checkpoint`` (non-reentrant).
    The block's parameters go in as explicit inputs, so that the recompute
    in the backward sees the tensors the forward saw (a bf16 copy bound by
    ``torch.func.functional_call`` included, which is unbound by then);
    dropout masks repeat (checkpoint restores the RNG state) and BatchNorm
    statistics are updated by the first forward only."""
    names, params = zip(*block.named_parameters())
    n = len(inputs)

    def run(*args):
        return torch.func.functional_call(block, dict(zip(names, args[n:])), args[:n])

    return checkpoint(run, *inputs, *params, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), recomputing()))


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's train-mode semantics
    (``conformer.py:180-182``): batch statistics in fp32, normalization by
    the biased batch variance, and running statistics updated with that
    same biased variance (torch's own update uses the unbiased one, a
    factor n / (n - 1) on the batch term), fp32 running statistics under
    a bf16 input, and no update inside a recompute (:func:`recomputing`).
    Eval mode is torch's (running statistics)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(xf, dim=(0, 2), correction=0)
        if not getattr(_remat, "active", False):
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
                self.num_batches_tracked.add_(1)
        y = (xf - mean[:, None]) * torch.rsqrt(var + self.eps)[:, None]
        y = y * self.weight.to(y.dtype)[:, None] + self.bias.to(y.dtype)[:, None]
        return y.to(x.dtype)


class SpectralNorm(nn.Module):
    """Spectral normalization with the JAX package's semantics
    (``layers.py:162-194``): ``weight_orig`` is the parameter; ``weight_u``
    (size out) and ``weight_v`` (size in, in torch's ``(in, kh, kw)``
    flattening) are buffers that the forward only reads, so sigma =
    ``u . (W v)`` comes from the stored pair with gradients through W
    alone; :meth:`refresh_` runs one power-iteration step.  (torch's
    ``nn.utils.spectral_norm`` instead steps u on every training forward.)
    """

    def _init_spectral(self, out_features: int, in_features: int,
                       generator: torch.Generator) -> None:
        self.register_buffer("weight_u", torch.randn(out_features, generator=generator))
        self.register_buffer("weight_v", torch.randn(in_features, generator=generator))

    def _flat(self) -> torch.Tensor:
        return self.weight_orig.reshape(self.weight_orig.shape[0], -1)

    def normalized_weight(self) -> torch.Tensor:
        sigma = torch.dot(self.weight_u, self._flat() @ self.weight_v)
        return self.weight_orig / sigma

    @torch.no_grad()
    def refresh_(self) -> None:
        """One power-iteration step on the stored (u, v)."""
        w = self._flat().float()
        v = w.t() @ self.weight_u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = w @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        self.weight_u.copy_(u)
        self.weight_v.copy_(v)


class SpectralNormConv2d(SpectralNorm):
    """Bias-free ``Conv2d`` under :class:`SpectralNorm`
    (``layers.py:130-159``); kaiming-normal init."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.stride, self.padding = stride, padding
        self.weight_orig = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        kaiming_normal_(self.weight_orig, generator)
        self._init_spectral(out_channels, in_channels * kernel_size * kernel_size,
                            generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized_weight().to(x.dtype)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)


class SpectralNormLinear(SpectralNorm):
    """``Linear`` under :class:`SpectralNorm` (``layers.py:102-127``);
    kaiming-normal weight, bias 0.01."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.weight_orig = nn.Parameter(torch.empty(out_features, in_features))
        kaiming_normal_(self.weight_orig, generator)
        self.bias = nn.Parameter(torch.full((out_features,), 0.01))
        self._init_spectral(out_features, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized_weight().to(x.dtype)
        return F.linear(x, w, self.bias.to(x.dtype))
