"""Readers of the program's own spans and counters (the port's
``utils.profiling`` store, filled while the traced window's profiler
records), clipped to the window.  Each returns None where the program
keeps no such store (a commit before it) or stored no record of the name
inside the window, never 0."""

from __future__ import annotations

import time


def _store():
    try:
        from speech_enhancement_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "counts") else None


def window_ns(bench) -> tuple[int, int] | None:
    """``bench.window_t`` (``time.perf_counter`` seconds) on the store's
    clock (Unix-epoch ns)."""
    if bench.window_t is None:
        return None
    offset = time.time_ns() - time.perf_counter_ns()
    return int(bench.window_t[0] * 1e9) + offset, int(bench.window_t[1] * 1e9) + offset


def span_seconds(bench, name: str) -> float | None:
    """Seconds of the spans ``name`` inside the window, summed over every
    thread."""
    store, window = _store(), window_ns(bench)
    if store is None or window is None:
        return None
    lo, hi = window
    got = [s for s in store.spans(lo, hi) if s.name == name]
    if not got:
        return None
    return 1e-9 * sum(min(s.end, hi) - max(s.start, lo) for s in got)


def count_total(bench, name: str) -> float | None:
    """The counter ``name`` summed over the window."""
    store, window = _store(), window_ns(bench)
    if store is None or window is None:
        return None
    got = [c.n for c in store.counts(*window) if c.name == name]
    return float(sum(got)) if got else None


def span_share_pct(bench, name: str, lanes: int = 1) -> float | None:
    """The spans ``name`` over the window's seconds times ``lanes`` (the
    threads that can hold them at once), in %."""
    seconds = span_seconds(bench, name)
    if seconds is None or bench.window_s <= 0:
        return None
    return 100.0 * seconds / (bench.window_s * lanes)


def pad_share_pct(bench) -> float | None:
    """The Enhancer's wrap-pad samples over the samples it sent to the
    device, in the window, in %."""
    sent = count_total(bench, "enhance.batch_samples")
    pad = count_total(bench, "enhance.pad_samples")
    if not sent or pad is None:
        return None
    return 100.0 * pad / sent
