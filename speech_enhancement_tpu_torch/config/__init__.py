"""The configuration tree and its overlays (``baseline.yaml``, ``scp.yaml``,
``server.yaml``), read without PyYAML."""

from speech_enhancement_tpu_torch.config.config import (
    Config,
    DataConfig,
    ModelConfig,
    OptimizerConfig,
    OverlayError,
    SchedulerConfig,
    TrainConfig,
    get_config,
    load_config,
    parse_overlay,
    parse_value,
    read_overlay,
)

__all__ = [
    "Config",
    "DataConfig",
    "ModelConfig",
    "OptimizerConfig",
    "OverlayError",
    "SchedulerConfig",
    "TrainConfig",
    "get_config",
    "load_config",
    "parse_overlay",
    "parse_value",
    "read_overlay",
]
