"""The port's profiling hooks (speech_enhancement_tpu_torch/utils/
profiling.py) on the CPU: ``StepTimer`` times steps over its rolling
window whatever the outputs hold (nested CPU tensors, None, non-tensors);
``trace`` profiles the enclosed work, yields the profiler (its
``key_averages`` list the ops run) and writes a trace file under its
directory; ``device_memory_stats`` is ``[]`` without a card.  The CUDA
fence and the card's memory statistics run in ``chip_smoke.py``."""

import json
import time

import pytest
import torch

from speech_enhancement_tpu_torch.utils import StepTimer, device_memory_stats, trace

torch.set_num_threads(1)


@pytest.mark.parametrize("outputs", [None, torch.ones(3), (torch.ones(2), [torch.zeros(1)]),
                                     {"loss": torch.tensor(1.0), "step": 3}, "not a tensor"])
def test_step_timer_times_steps(outputs):
    timer = StepTimer(window=3)
    for _ in range(5):
        time.sleep(0.002)
        dt = timer.tick(outputs)
        assert dt >= 0.002
    assert len(timer.times) == 3
    assert timer.avg == pytest.approx(sum(timer.times) / 3)


def test_step_timer_average_of_no_steps_is_zero():
    assert StepTimer().avg == 0.0


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
