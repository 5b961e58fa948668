"""The reader of ``convmod_roofline.batch``: None without a trace, without
the program's counters, or when the trace's launches of the kernel differ
from the counted ones; else the counted bytes over the card's bandwidth
over the kernel's device time, here from counters the program stored under
a (CPU) profiler session and a synthetic trace summary."""

import time
from types import SimpleNamespace

import pytest
import torch

from sebench import harness
from sebench.reference import flops
from sebench.trace import TraceSummary
from speech_enhancement_tpu_torch.utils import profiling

READER = harness.load_module("metrics", "convmod_roofline.batch")
PEAKS = flops.PEAKS["H100"]
COLS = ("void (anonymous namespace)::glu_conv_swish_kernel<float, false>(float const*, "
        "float const*)")
ROWS = "void (anonymous namespace)::glu_conv_swish_kernel<float, true>(float const*)"
DEPTHWISE = ("void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel_generic"
             "<float, int>")
NORM = "void (anonymous namespace)::add_layer_norm_c64_kernel<float, 2>(float const*)"


def _summary(kernels: dict) -> TraceSummary:
    """``kernels``: name -> (device seconds, launches)."""
    return TraceSummary(window_s=1.0, busy_s=1.0,
                        kernel_launches=sum(n for _, n in kernels.values()),
                        device_ops=[], idle_gaps=[],
                        kernel_s={k: s for k, (s, _) in kernels.items()},
                        kernel_count={k: n for k, (_, n) in kernels.items()})


def _bench(counts: list[tuple[str, float]], kernels: dict | None):
    """A bench whose window holds ``counts``, stored by the program while a
    profiler session recorded."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.clear()
        # the window maps onto the store's clock a few us apart at each
        # read: 10 ms of margin on either side
        start = time.perf_counter()
        time.sleep(0.01)
        for name, n in counts:
            profiling.count(name, n)
        time.sleep(0.01)
        end = time.perf_counter()
    return SimpleNamespace(summary=None if kernels is None else _summary(kernels),
                           peaks=PEAKS, window_t=(start, end))


COUNTS = [("convmod.launches", 1), ("convmod.bytes", 6.36e9), ("norm.launches", 1),
          ("norm.bytes", 4.0e9), ("convmod.launches", 1), ("convmod.bytes", 1.5e8),
          ("convmod.launches", 1), ("convmod.bytes", 3.2e9)]


def test_share_is_counted_bytes_over_bandwidth_over_kernel_time():
    bench = _bench(COUNTS, {COLS: (4.0e-3, 2), ROWS: (1.5e-3, 1), NORM: (2.0e-3, 1),
                            DEPTHWISE: (9.0, 40)})
    want = 100.0 * (9.71e9 / PEAKS["bytes"]) / 5.5e-3
    assert READER.read(bench) == pytest.approx(want, rel=1e-12)


def test_none_without_a_trace_or_a_peak_table():
    assert READER.read(_bench(COUNTS, None)) is None
    bench = _bench(COUNTS, {COLS: (4.0e-3, 3)})
    bench.peaks = None
    assert READER.read(bench) is None


def test_none_when_the_launches_disagree():
    """The counter shows the route did not engage where it was counted, or
    engaged where it was not."""
    assert READER.read(_bench(COUNTS, {COLS: (4.0e-3, 2)})) is None
    assert READER.read(_bench(COUNTS, {COLS: (4.0e-3, 4)})) is None


def test_none_where_the_program_counts_nothing():
    """A commit before the kernel: aten's depthwise conv in the trace, no
    counters of the conv module in the store (the add-and-norm's are)."""
    counts = [c for c in COUNTS if c[0].startswith("norm.")]
    assert READER.read(_bench(counts, {DEPTHWISE: (9.0, 40), NORM: (2.0e-3, 1)})) is None
