"""Loss criteria (port of speech_enhancement_tpu/train/criterion.py): L1
(mae) or MSE.  The GAN entry point of the reference uses MSE whatever the
criterion flag says (``cli/main_gan.py:208-210``)."""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def build_criterion(name: str):
    name = name.lower()
    if name in ("mae", "l1"):
        return l1_loss
    if name in ("mse", "l2"):
        return l2_loss
    raise ValueError(f"invalid criterion {name!r}")
