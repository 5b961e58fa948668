"""The port's profiling hooks (speech_enhancement_tpu_torch/utils/
profiling.py) on the CPU: ``trace`` profiles the enclosed work, yields the
profiler (its ``key_averages`` list the ops run) and writes a trace file
under its directory; ``device_memory_stats`` is ``[]`` without a card.
The card's memory statistics run in ``chip_smoke.py``; the spans and
counters are tested in ``test_torch_tracing.py``."""

import json

import pytest
import torch

from speech_enhancement_tpu_torch.utils import device_memory_stats, trace

torch.set_num_threads(1)


def test_trace_profiles_and_writes_a_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path)) as prof:
        (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names or "aten::matmul" in names
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["traceEvents"]


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert device_memory_stats() == []
