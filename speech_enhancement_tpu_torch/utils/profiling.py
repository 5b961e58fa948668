"""Profiling hooks (port of speech_enhancement_tpu/utils/profiling.py).

* :func:`trace`: ``torch.profiler`` over the enclosed steps (CPU and, where
  a card is visible, CUDA activity), written under ``log_dir`` as a trace
  that TensorBoard's profiler plugin or Perfetto opens;
* :class:`StepTimer`: wall-clock step times over a rolling window, each
  fenced on the card's work that the step's outputs depend on;
* :func:`device_memory_stats`: ``torch.cuda.memory_stats`` of every visible
  card (``allocated_bytes.all.peak`` among them).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work; yields the ``torch.profiler.profile``
    (``key_averages()`` splits the device time by kernel) and writes its
    trace to ``log_dir`` on exit."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _tensors(outputs):
    if isinstance(outputs, torch.Tensor):
        yield outputs
    elif isinstance(outputs, dict):
        for value in outputs.values():
            yield from _tensors(value)
    elif isinstance(outputs, (list, tuple)):
        for value in outputs:
            yield from _tensors(value)


class StepTimer:
    """Rolling per-step timer; call ``tick(outputs)`` once per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last = time.perf_counter()

    def tick(self, outputs=None) -> float:
        """Seconds since the last tick.  The card's work is fenced first: an
        event recorded on the current stream of each card that holds a
        tensor of ``outputs`` (nested lists, tuples and dicts), and waited
        for.  CPU tensors need no fence."""
        for device in {t.device for t in _tensors(outputs) if t.is_cuda}:
            with torch.cuda.device(device):
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def avg(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def device_memory_stats() -> list[dict]:
    """One dict per visible CUDA device: ``torch.cuda.memory_stats`` (bytes
    and counts; ``allocated_bytes.all.peak`` is the peak allocated) and
    ``"device"``.  ``[]`` where no card is visible."""
    if not torch.cuda.is_available():
        return []
    return [{"device": str(torch.device("cuda", i)), **torch.cuda.memory_stats(i)}
            for i in range(torch.cuda.device_count())]
