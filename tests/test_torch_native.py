"""The build cache of the port's native code (``ops/_native.py``): a library
loaded from ``_build/`` comes back with its compiler's log, a library
without its log is rebuilt, and a g++ library's name depends on the
target ``-march=native`` resolves to on the host.  The one launch count:
each kernel of ``_native.KERNELS`` is counted by the wrappers of ``ops/``
under its name, and by no other name."""

from __future__ import annotations

import ctypes
import re

import torch

from speech_enhancement_tpu_torch.ops import _native

torch.set_num_threads(1)

SOURCE = 'extern "C" int se_answer(void) { return 42; }\n'
SIGNATURES = {"se_answer": ([], ctypes.c_int)}


def _isolate(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_native, "_libs", {})
    monkeypatch.setattr(_native, "build_logs", {})
    monkeypatch.setattr(_native, "build_seconds", {})


def _load_answer(src):
    # g++ -v writes its configuration to stderr: a log that is never empty
    return _native._load(
        "answer", src, [src], ["-v"],
        lambda out: [_native._gxx(), "-v", "-fPIC", "-shared", "-o", str(out), str(src)],
        SIGNATURES)


def test_cached_library_comes_back_with_its_log(monkeypatch, tmp_path):
    _isolate(monkeypatch, tmp_path)
    src = tmp_path / "answer.cc"
    src.write_text(SOURCE)
    assert _load_answer(src).se_answer() == 42
    log = _native.build_logs["answer"]
    assert "gcc version" in log and _native.build_seconds["answer"] > 0.0
    (so,) = (tmp_path / "_build").glob("answer-*.so")
    assert so.with_suffix(".log").read_text() == log

    _native._libs.clear()  # a new process: the library is in _build/
    _native.build_logs.clear()
    assert _load_answer(src).se_answer() == 42
    assert _native.build_seconds["answer"] == 0.0
    assert _native.build_logs["answer"] == log

    so.with_suffix(".log").unlink()  # a library without its log is rebuilt
    _native._libs.clear()
    assert _load_answer(src).se_answer() == 42
    assert _native.build_seconds["answer"] > 0.0
    assert so.with_suffix(".log").read_text() == _native.build_logs["answer"]


def test_gxx_library_name_depends_on_the_host_target(monkeypatch):
    assert "-march=" in _native._host_target()
    names = []
    monkeypatch.setattr(_native, "_load", lambda name, src, sources, flags, command, sigs:
                        names.append(_native._digest(sources, flags)))
    _native.load_host("pesq", {})
    _native.load_host("pesq", {})
    monkeypatch.setattr(_native, "_gxx_target", ["x86_64\n  -march=  some-other-cpu"])
    _native.load_host("pesq", {})
    assert names[0] == names[1] != names[2]


def test_wrappers_count_every_kernel_under_its_name():
    ops = _native.CSRC.parent / "ops"
    counted = [name for path in sorted(ops.glob("*.py"))
               for name in re.findall(r'_native\.launches\["(\w+)"\] \+= 1', path.read_text())]
    assert sorted(counted) == sorted(_native.KERNELS)
    assert list(_native.launches) == list(_native.KERNELS)


def test_clear_launches_zeroes_every_kernel(monkeypatch):
    monkeypatch.setattr(_native, "launches", dict.fromkeys(_native.KERNELS, 3))
    _native.clear_launches()
    assert _native.launches == dict.fromkeys(_native.KERNELS, 0)
