"""Shared building blocks (port of speech_enhancement_tpu/models/layers.py).

NCHW / NCL like the reference torch modules; parameter names follow the
reference ``state_dict`` (``weight``, ``bias``).
"""

from __future__ import annotations

import math

import torch
from torch import nn


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
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True, correction=0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        shape = (1, -1, 1, 1)
        return y * self.weight.to(x.dtype).view(shape) + self.bias.to(x.dtype).view(shape)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swish(x)
