"""Explicit device selection: asking for CUDA where there is none raises."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (the CPU when None).  Raises when a
    CUDA device is asked for and this process sees none."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev
