"""Profiling hooks (port of speech_enhancement_tpu/utils/profiling.py).

* :func:`trace`: ``torch.profiler`` over the enclosed steps (CPU and, where
  a card is visible, CUDA activity), written under ``log_dir`` as a trace
  that TensorBoard's profiler plugin or Perfetto opens, with the program's
  spans of the threads the profiler does not record and its counters
  beside it;
* :func:`span` and :func:`count`: the program's spans and counters at its
  layer boundaries, kept in memory while a profiler session records and
  read back with :func:`spans` and :func:`counts`.  The store grows for as
  long as sessions record: :func:`trace` empties it as its session starts,
  and the owner of any other session calls :func:`clear`;
* :func:`device_memory_stats`: ``torch.cuda.memory_stats`` of every visible
  card (``allocated_bytes.all.peak`` among them).

Tracing is on exactly while a ``torch.profiler`` session records, in any
thread: :func:`trace`, or any other session.  Off, :func:`span` returns one
shared object whose ``with`` does nothing, and :func:`count` returns at
once.  On, a span opens ``torch.profiler.record_function(name)`` (so that
it is in the profiler's trace where the profiler records its thread: the
session's own thread and the autograd engine's) and stores a
:class:`Span`; a counter stores a :class:`Count`.  Times are Unix-epoch
nanoseconds (``time.time_ns``), the clock of the profiler's events.
The switch is ``torch.autograd.profiler._is_profiler_enabled``, looked up
once here; a torch without it falls back to the calling thread's own flag,
which misses plain threads (loader workers, label threads).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import threading
import time
from typing import Any, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function


class Span(NamedTuple):
    """One closed span: ``start`` and ``end`` in Unix-epoch ns, ``thread``
    the native thread id, ``parent`` the ``seq`` of the span that enclosed
    it on the same thread (None at the top), ``id`` the request, step or
    batch it belongs to, which links spans across threads."""

    name: str
    start: int
    end: int
    thread: int
    parent: int | None
    id: Any
    seq: int


class Count(NamedTuple):
    """``n`` more of ``name`` at ``t`` (Unix-epoch ns)."""

    name: str
    t: int
    n: float


_spans: list[Span] = []
_counts: list[Count] = []
_thread_names: dict[int, str] = {}
_local = threading.local()
_seq = itertools.count()


if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def tracing() -> bool:
        """Whether a profiler session records, in this process (the flag
        every thread sees; ``torch.autograd._profiler_enabled`` is per
        thread)."""
        return _autograd_profiler._is_profiler_enabled
else:
    tracing = torch.autograd._profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "id", "seq", "parent", "start", "thread", "function")

    def __init__(self, name: str, id: Any):
        self.name, self.id = name, id

    def __enter__(self):
        # the thread's open spans and native id (a system call, so once a thread)
        state = getattr(_local, "state", None)
        if state is None:
            state = _local.state = ([], threading.get_native_id())
        stack, self.thread = state
        if self.thread not in _thread_names:
            _thread_names[self.thread] = threading.current_thread().name
        self.parent = stack[-1] if stack else None
        self.seq = next(_seq)
        stack.append(self.seq)
        # the stored span encloses the profiler's event of the same name
        self.start = time.time_ns()
        self.function = record_function(self.name)
        self.function.__enter__()
        return self

    def __exit__(self, *exc):
        self.function.__exit__(*exc)
        end = time.time_ns()
        _local.state[0].pop()
        _spans.append(Span(self.name, self.start, end, self.thread, self.parent, self.id,
                           self.seq))
        return False


def span(name: str, id: Any = None):
    """A context manager that records the enclosed work as span ``name``
    while tracing is on (see the module's docstring), and does nothing
    otherwise."""
    if not tracing():
        return _OFF
    return _On(name, id)


def count(name: str, n: float) -> None:
    """Record ``n`` more of ``name`` while tracing is on."""
    if tracing():
        _counts.append(Count(name, time.time_ns(), n))


def _between(start: int, end: int, lo: int | None, hi: int | None) -> bool:
    return (lo is None or end > lo) and (hi is None or start < hi)


def spans(start_ns: int | None = None, end_ns: int | None = None) -> list[Span]:
    """The stored spans that overlap ``[start_ns, end_ns)`` (either end
    open when None), in the order they closed."""
    return [s for s in list(_spans) if _between(s.start, s.end, start_ns, end_ns)]


def counts(start_ns: int | None = None, end_ns: int | None = None) -> list[Count]:
    """The stored counts taken in ``[start_ns, end_ns)``."""
    return [c for c in list(_counts) if _between(c.t, c.t + 1, start_ns, end_ns)]


def clear() -> None:
    """Empty the store (and its names of threads)."""
    _spans.clear()
    _counts.clear()
    _thread_names.clear()


def _add_program_records(path: str, start_ns: int, end_ns: int) -> None:
    """Append to the Chrome trace at ``path`` the stored records of
    ``[start_ns, end_ns)`` that the profiler does not hold, on the trace's
    clock: the spans of threads with no event of their own in it (a data
    loader's workers, label threads), each under its thread's id and name,
    and each counter as a counter track of its running total."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    seen = {e.get("tid") for e in events if e.get("ph") == "X"}
    added = [s for s in spans(start_ns, end_ns) if s.thread not in seen]
    for tid in sorted({s.thread for s in added}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": _thread_names.get(tid, str(tid))}})
    for s in added:
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": (s.start - base) / 1e3,
                       "dur": (s.end - s.start) / 1e3,
                       "args": {"id": repr(s.id), "seq": s.seq, "parent": s.parent}})
    totals: dict[str, float] = {}
    for c in sorted(counts(start_ns, end_ns), key=lambda c: c.t):
        totals[c.name] = totals.get(c.name, 0) + c.n
        events.append({"ph": "C", "cat": "program_counter", "name": c.name, "pid": pid,
                       "ts": (c.t - base) / 1e3, "args": {"total": totals[c.name]}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work; yields the ``torch.profiler.profile``
    (``key_averages()`` splits the device time by kernel) and writes its
    trace to ``log_dir`` on exit, as ``<host>_<pid>.<ns>.pt.trace.json``,
    with the stored spans of threads the profiler does not record and the
    stored counters.  The store is emptied as the session starts."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear()
    start = time.time_ns()

    def write(prof):
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                     f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        _add_program_records(path, start, time.time_ns())

    with profile(activities=activities, on_trace_ready=write) as prof:
        yield prof


def device_memory_stats() -> list[dict]:
    """One dict per visible CUDA device: ``torch.cuda.memory_stats`` (bytes
    and counts; ``allocated_bytes.all.peak`` is the peak allocated) and
    ``"device"``.  ``[]`` where no card is visible."""
    if not torch.cuda.is_available():
        return []
    return [{"device": str(torch.device("cuda", i)), **torch.cuda.memory_stats(i)}
            for i in range(torch.cuda.device_count())]
