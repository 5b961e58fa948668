"""Device selection: the card by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``; None means ``cuda``.  Raises when a
    CUDA device is asked for (or defaulted to) and this process sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = " (pass device='cpu' to run on the CPU)" if device is None else ""
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False{hint}")
    return dev
