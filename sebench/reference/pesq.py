"""The reference's PESQ: the frozen copy of the engine's C++ source beside
this file, built with g++ into ``sebench/_build/`` at first use (the file
name hashes the source and the flags, so an unchanged source is loaded,
not rebuilt) and called through ctypes."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "pesq.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_lib: list[ctypes.CDLL] = []


def build() -> ctypes.CDLL:
    if _lib:
        return _lib[0]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the reference PESQ engine is built at first use")
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"ref_pesq-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SRC), "-lpthread"],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.pesq_batch.argtypes = [_F32P, _F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int, _F64P]
    lib.pesq_batch.restype = None
    _lib.append(lib)
    return lib


def pesq_batch(clean: np.ndarray, other: np.ndarray, fs: int = 16000) -> np.ndarray:
    """Wideband MOS-LQO per row of two ``[B, L]`` batches; -1 where the
    engine fails (silence)."""
    clean = np.ascontiguousarray(clean, np.float32)
    other = np.ascontiguousarray(other, np.float32)
    if clean.shape != other.shape or clean.ndim != 2:
        raise ValueError(f"two [B, L] batches of one shape, got {clean.shape}, {other.shape}")
    out = np.empty(clean.shape[0], np.float64)
    build().pesq_batch(clean.ctypes.data_as(_F32P), other.ctypes.data_as(_F32P),
                       clean.shape[0], clean.shape[1], fs, 0, out.ctypes.data_as(_F64P))
    return np.where(out < 0, -1.0, out)
