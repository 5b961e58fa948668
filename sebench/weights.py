"""Weights from the seed, made on the device: the plain reference model is
built there, and every leaf that the published initialization draws at
random (Kaiming-normal weights of the linears and convolutions, the
unit-normal Shaw tables and spectral-norm vectors) is cut from one normal
draw of a ``torch.Generator`` on the device, then scaled.  The constants
(biases 0.01, norms 1 and 0, PReLU slopes) are the modules' own.  The
returned state dict is handed to the program and to the reference alike."""

from __future__ import annotations

import math

import torch
from torch import nn

from sebench.reference.models import SpectralNorm


def seeded_state(model: nn.Module, seed: int, device: torch.device) -> dict:
    """``model``'s state dict (on ``device``) with its random leaves drawn
    from ``seed``."""
    model = model.to(device)
    drawn: list[tuple[torch.Tensor, float]] = []
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            drawn.append((m.weight, math.sqrt(2.0 / m.weight[0].numel())))
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.fill_(0.01)
        elif isinstance(m, nn.Embedding):
            drawn.append((m.weight, 1.0))
        elif isinstance(m, SpectralNorm):
            drawn += [(m.weight_orig, math.sqrt(2.0 / m.weight_orig[0].numel())),
                      (m.weight_u, 1.0), (m.weight_v, 1.0)]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(t.numel() for t, _ in drawn)
    noise = torch.randn(total, generator=gen, device=device)
    offset = 0
    with torch.no_grad():
        for t, std in drawn:
            t.copy_(noise[offset:offset + t.numel()].view_as(t) * std)
            offset += t.numel()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
