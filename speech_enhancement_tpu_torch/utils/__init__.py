"""Checkpoints, logging and meters, the preemption guard, profiling
hooks, checkpoint conversion (``convert.py``) and device selection
(``device.py``)."""

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
from speech_enhancement_tpu_torch.utils.profiling import (
    count,
    device_memory_stats,
    span,
    trace,
)

__all__ = [
    "AverageMeter",
    "PreemptionGuard",
    "ProgressMeter",
    "count",
    "create_logger",
    "device_memory_stats",
    "latest_checkpoint",
    "load_checkpoint",
    "load_variables",
    "save_checkpoint",
    "span",
    "sweep_checkpoints",
    "trace",
]
