"""The harness: finds a cell's files by name, runs its traffic driver,
reads the per-layer metrics, checks the process for JAX, and prints the
result line.

A cell is ``workloads/<name>.json`` (its configuration's name, its
traffic driver's name, the driver's parameters, the chips and why);
its configuration is ``configs/<config>.json``; its driver is
``traffic/<driver>.py``, a module with ``run(bench)``; each per-layer
metric that ``BENCHMARK.json`` declares is ``metrics/<metric>.py``, a
module with ``read(bench)`` that returns a number or None.  Adding any of
these is adding a file.

A driver builds the program and its traffic from ``bench.seed``, warms up
and calls :meth:`Bench.setup_done`, opens and closes the window
(:meth:`Bench.open_window`, :meth:`Bench.close_window`), sets its
end-to-end metrics in ``bench.e2e`` and what the readers need in
``bench.counters``, frees the program's state, and then runs its
correctness check against the plain reference, adding each number
compared with :meth:`Bench.check`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType

import numpy as np
import torch

from sebench import trace as trace_mod
from sebench.reference import flops

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "speech_enhancement_tpu")
GIB = float(1 << 30)


class NoCard(Exception):
    """The cell's chips are not there."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"sebench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def declared(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


class Bench:
    """One run of one cell: its inputs, its clock and what it measured."""

    def __init__(self, *, workload: dict, config: dict, seed: int, seconds: float,
                 trace: bool, device: torch.device, t0: float):
        self.workload, self.config = workload, config
        self.params = workload.get("params", {})
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0 = device, t0
        self.cuda = device.type == "cuda"
        self.kind = torch.cuda.get_device_name(device) if self.cuda else "cpu"
        self.peaks = flops.peaks(self.kind) if self.cuda else None
        self.e2e: dict[str, float] = {}
        self.counters: dict = {}
        self.checks: list[tuple[str, float, float]] = []
        self.attempted = self.failed = 0
        self.setup_s: float | None = None
        self.window_t: tuple[float, float] | None = None
        self.summary: trace_mod.TraceSummary | None = None
        self.setup_peak = self.window_peak = 0
        self._profiler = None
        self._span = None
        self.window_open = False

    def seed_of(self, *keys: int | str) -> int:
        """A 63-bit seed from the run's seed and ``keys``."""
        def word(k: int | str) -> int:  # a non-negative int for each key
            if isinstance(k, str):
                return int.from_bytes(k.encode(), "little")
            return 2 * k if k >= 0 else -2 * k - 1

        words = [word(self.seed)] + [word(k) for k in keys]
        return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))

    def rng(self, *keys: int | str) -> np.random.Generator:
        return np.random.default_rng(self.seed_of(*keys))

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        """Set-up and warm-up are over: read the set-up time and peak, reset
        the peak, and start the profiler for a traced run."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t0
        if self.cuda:
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()

    def open_window(self) -> float:
        self.sync()
        self._span = torch.profiler.record_function(trace_mod.WINDOW_SPAN)
        self._span.__enter__()
        start = time.perf_counter()
        self.window_t = (start, start)
        self.window_open = True
        return start

    def close_window(self) -> float:
        """Close the window once its work has ended (the device synchronized
        first); returns its seconds."""
        self.sync()
        end = time.perf_counter()
        self.window_t = (self.window_t[0], end)
        self.window_open = False
        self._span.__exit__(None, None, None)
        if self.cuda:
            self.window_peak = torch.cuda.max_memory_allocated(self.device)
        if self._profiler is not None:
            self._profiler.stop()
            self.summary = trace_mod.summarize(self._profiler.profiler.kineto_results.events())
            self._profiler = None
        return end - self.window_t[0]

    @property
    def window_s(self) -> float:
        return self.window_t[1] - self.window_t[0]

    def check(self, name: str, value: float, limit: float) -> None:
        """One number compared: correct while ``value <= limit``."""
        self.checks.append((name, float(value), float(limit)))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, t0: float,
             root: Path = ROOT, spec_path: Path = Path("BENCHMARK.json"),
             device: str | None = None, overrides: dict | None = None) -> dict:
    """Run ``cell`` once; returns the result line's object (``checks``
    last).  ``device`` None takes the card and raises :class:`NoCard`
    without enough of them; ``overrides`` (tests) replace the workload's
    ``params`` and the configuration's keys."""
    spec = load_json(spec_path)
    workload = load_json(root / "workloads" / f"{cell}.json")
    config = load_json(root / "configs" / f"{workload['config']}.json")
    for key, value in (overrides or {}).get("params", {}).items():
        workload.setdefault("params", {})[key] = value
    for key, value in (overrides or {}).get("config", {}).items():
        config[key] = value
    chips = int(workload["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoCard(f"cell {cell} needs {chips} CUDA device(s); this process sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda:0"
    bench = Bench(workload=workload, config=config, seed=seed, seconds=seconds, trace=trace,
                  device=torch.device(device), t0=t0)
    load_module("traffic", workload["driver"], root).run(bench)

    if trace:
        metrics = {}
        for m in declared(spec["per_layer"], cell):
            value = load_module("metrics", m["name"], root).read(bench)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(bench.e2e, setup_s=bench.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in declared(spec["end_to_end"], cell)}
    device_info = {"platform": "gpu" if bench.cuda else "cpu", "kind": bench.kind,
                   "count": chips, "memory_peak_bytes": max(bench.setup_peak, bench.window_peak)}
    result = {"correct": bool(bench.checks) and bench.failed == 0 and all(
                  math.isfinite(v) and v <= limit for _, v, limit in bench.checks),
              "attempted": bench.attempted, "failed": bench.failed, "metrics": metrics,
              "device": device_info}
    if trace and bench.summary is not None:
        device_info.update(busy_s=bench.summary.busy_s, window_s=bench.summary.window_s)
        result["breakdown"] = {"device_ops": bench.summary.device_ops,
                               "idle_gaps": bench.summary.idle_gaps}
    if "readings" in bench.counters:
        result["readings"] = bench.counters["readings"]
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in bench.checks}
    return result
