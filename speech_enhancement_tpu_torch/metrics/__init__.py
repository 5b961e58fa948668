"""Metrics of the port: the native PESQ engine (``pesq.py``) and the
composite evaluation metrics (``composite.py``)."""

from speech_enhancement_tpu_torch.metrics.composite import (
    compute_metrics,
    llr,
    snr,
    stoi,
    wss,
)

__all__ = ["compute_metrics", "llr", "snr", "stoi", "wss"]
