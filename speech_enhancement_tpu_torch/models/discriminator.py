"""Metric discriminator (port of speech_enhancement_tpu/models/discriminator.py).

Predicts the normalized PESQ of a (clean, other) pair of magnitude
spectrograms: four spectral-norm strided convs with InstanceNorm and
PReLU, a global max-pool, a spectral-norm MLP with dropout, and a
learnable sigmoid.  NCHW inside; the submodules are ``layers.0`` ...
``layers.18``, the reference ``state_dict`` keys that
``convert_torch.export_discriminator`` writes, so ``load_state_dict(
strict=True)`` takes its output.

Spectral norm follows the JAX semantics (``models/layers.py``
``SpectralNorm``): the forward reads the stored power-iteration pair and
never updates it; a training step calls :meth:`Discriminator.refresh_`
once, after its optimizer update.
"""

from __future__ import annotations

import torch
from torch import nn

from speech_enhancement_tpu_torch.models.layers import (
    InstanceNorm,
    LearnableSigmoid,
    PReLU,
    SpectralNorm,
    SpectralNormConv2d,
    SpectralNormLinear,
)
from speech_enhancement_tpu_torch.utils.device import resolve_device


class Discriminator(nn.Module):
    """``forward(x, y)`` with ``x, y`` magnitude spectrograms ``[B, T, F]``
    returns ``[B, 1]``.  Weights are drawn from ``generator`` (seed 0 when
    None) on the CPU and then moved to ``device`` (``cuda`` when None;
    pass ``'cpu'`` for the CPU)."""

    def __init__(self, ndf: int = 16, dropout: float = 0.3, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        widths = [2, ndf, ndf * 2, ndf * 4, ndf * 8]
        layers: list[nn.Module] = []
        for cin, cout in zip(widths[:-1], widths[1:]):
            layers += [SpectralNormConv2d(cin, cout, 4, 2, 1, generator=generator),
                       InstanceNorm(cout), PReLU(cout)]
        layers += [
            nn.AdaptiveMaxPool2d(1),
            nn.Flatten(),
            SpectralNormLinear(ndf * 8, ndf * 4, generator=generator),
            nn.Dropout(dropout),
            PReLU(ndf * 4),
            SpectralNormLinear(ndf * 4, 1, generator=generator),
            LearnableSigmoid(1),
        ]
        self.layers = nn.Sequential(*layers)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.layers(torch.stack([x, y], dim=1))

    @torch.no_grad()
    def refresh_(self) -> None:
        """One power-iteration step of every spectral-norm layer."""
        for m in self.modules():
            if isinstance(m, SpectralNorm):
                m.refresh_()
