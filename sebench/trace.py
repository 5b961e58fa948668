"""Reduction of a ``torch.profiler`` trace of the measured window: device
busy time, the device operations that took most time, and the idle gaps
named by what the host was doing.

Device operations are the events the profiler records on the CUDA device
(kernels, copies, sets); a kernel launch is one such event that is neither
a copy nor a set.  The window is the benchmark's own ``sebench.window``
span; the host's activity in a gap is the innermost CPU event of the
window's thread that spans the gap's middle.
"""

from __future__ import annotations

import dataclasses
import gc
from collections import defaultdict

WINDOW_SPAN = "sebench.window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_launches: int
    device_ops: list  # [name, seconds], most time first
    idle_gaps: list  # [host activity, seconds], most time first
    kernel_s: dict  # device seconds by name inside the window
    kernel_count: dict  # launches by name inside the window


def _is_device_track(event) -> bool:
    return "CUDA" in str(event.device_type())


def _is_device(event) -> bool:
    """An operation on the device: not the device-side copy of a host
    annotation (``record_function`` spans appear on the device's track
    too)."""
    if not _is_device_track(event):
        return False
    annotation = getattr(event, "is_user_annotation", lambda: False)()
    return not (annotation or event.name().startswith("sebench."))


def _is_launch(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def innermost(spans: list[tuple[int, int, str]], points: list[int]) -> list[str | None]:
    """For each of the sorted ``points``, the name of the innermost of the
    nested ``spans`` (start, end, name) of one thread that holds it, or
    None: one sweep over both."""
    spans = sorted(spans, key=lambda h: (h[0], -h[1]))
    out: list[str | None] = []
    stack: list[tuple[int, int, str]] = []
    i = 0
    for point in points:
        while i < len(spans) and spans[i][0] <= point:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < point:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def summarize(events, top: int = 10) -> TraceSummary | None:
    """See :func:`_summarize`; the cyclic garbage collector is off meanwhile
    (it would rescan the millions of tuples built here, again and again)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        return _summarize(events, top)
    finally:
        if enabled:
            gc.enable()


def _summarize(events, top: int) -> TraceSummary | None:
    """The summary of the events of ``prof.profiler.kineto_results.events()``,
    or None when the window's span or any device operation is missing.
    A gap is named by the innermost event of the window's thread that
    holds its middle; where that is the window's span itself (Python
    between operations, or a wait such as the autograd engine's), by the
    innermost event of any other thread there, marked as such."""
    window = [e for e in events if e.name() == WINDOW_SPAN and not _is_device_track(e)]
    if not window:
        return None
    w = max(window, key=lambda e: e.duration_ns())
    w0, w1, main = w.start_ns(), w.end_ns(), w.start_thread_id()
    device = []
    host: dict = defaultdict(list)
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1:
            continue
        if _is_device(e):
            device.append((max(s, w0), min(t, w1), e.name()))
        elif not _is_device_track(e):
            host[e.start_thread_id()].append((s, t, e.name()))
    if not device:
        return None
    kernel_s: dict = defaultdict(float)
    kernel_count: dict = defaultdict(int)
    for s, t, name in device:
        kernel_s[name] += (t - s) * 1e-9
        if _is_launch(name):
            kernel_count[name] += 1
    busy = merge([(s, t) for s, t, _ in device])
    busy_ns = sum(t - s for s, t in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    mids = [(s + t) // 2 for s, t in gaps]
    names = {tid: innermost(spans, mids) for tid, spans in host.items()}
    lengths = {tid: {n: t - s for s, t, n in spans} for tid, spans in host.items()}
    main_names = names.get(main) or [None] * len(gaps)
    others_tids = [tid for tid in names if tid != main]
    by_host: dict = defaultdict(float)
    for k, (s, t) in enumerate(gaps):
        name = main_names[k]
        if name is None or name == WINDOW_SPAN:
            others = [(lengths[tid][names[tid][k]], names[tid][k]) for tid in others_tids
                      if names[tid][k] is not None]
            if others:
                name = f"other thread: {min(others)[1]}"
            elif name is None:
                name = "host (no profiled op)"
        by_host[name] += (t - s) * 1e-9
    ranked = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
        kernel_launches=sum(kernel_count.values()),
        device_ops=[[n, s] for n, s in ranked[:top]],
        idle_gaps=[[n, s] for n, s in sorted(by_host.items(), key=lambda kv: -kv[1])[:top]],
        kernel_s=dict(kernel_s), kernel_count=dict(kernel_count))
