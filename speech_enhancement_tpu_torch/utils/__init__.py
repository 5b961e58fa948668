"""Checkpoints, logging and meters, the preemption guard, checkpoint
conversion (``convert.py``) and device selection (``device.py``)."""

from speech_enhancement_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    load_variables,
    save_checkpoint,
    sweep_checkpoints,
)
from speech_enhancement_tpu_torch.utils.logging import (
    AverageMeter,
    ProgressMeter,
    create_logger,
)
from speech_enhancement_tpu_torch.utils.preemption import PreemptionGuard

__all__ = [
    "AverageMeter",
    "PreemptionGuard",
    "ProgressMeter",
    "create_logger",
    "latest_checkpoint",
    "load_checkpoint",
    "load_variables",
    "save_checkpoint",
    "sweep_checkpoints",
]
