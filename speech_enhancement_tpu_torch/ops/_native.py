"""Build and load the native code in ``csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

and each host library ``csrc/<name>.cc`` (the PESQ engine) by ``g++``:

    g++ -O3 -march=native -fPIC -std=c++17 -shared -o _build/<name>-<hash>.so \
        csrc/<name>.cc -lpthread

The library's file name carries a hash of the sources (the source file,
and for CUDA every ``csrc/*.cuh``) and of the flags, so an edited source
is rebuilt and an unchanged one is loaded from ``_build/``; for g++ the
hash also takes the target that ``-march=native`` resolves to on this
host, so a ``_build/`` copied from another CPU is rebuilt, not loaded.
The compiler's output is kept beside the library (``<name>-<hash>.log``)
and read back with it into ``build_logs``.  Nothing here
runs at import time: the first call that needs a library builds it.
Different libraries may build at once from several threads (each compiler
is its own process); a missing compiler or a failed build raises; there
is no fallback.  Once loaded, a library is returned without taking a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: registers, shared memory and spills of every kernel, kept in
# build_logs
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()  # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}
# seconds spent compiling, by library name (0.0 when loaded from _build/)
build_seconds: dict[str, float] = {}
# the compiler's output (for nvcc, ptxas's resource report) of each library,
# from this build or read back from _build/
build_logs: dict[str, str] = {}
_gxx_target: list[str] = []  # what -march=native resolves to, once per process

# every kernel whose launches are counted: the hand-written kernels of
# csrc/ (by instance) and the int8 GEMMs of ops/int8.py
KERNELS = ("shaw_attention_fwd_tensor_core", "shaw_attention_fwd_tf32",
           "shaw_attention_fwd_cuda_core", "shaw_attention_bwd_tensor_core",
           "shaw_attention_bwd_tf32", "shaw_attention_bwd_cuda_core", "stft_compress",
           "uncompress_istft", "add_layer_norm", "glu_conv_swish", "swap_seq_axes",
           "int8_conv2d")
# launches on the card in this process since import (or since
# clear_launches()), by kernel name; a wrapper adds one per launch, and the
# plain versions that CPU tensors take add none
launches = dict.fromkeys(KERNELS, 0)


def clear_launches() -> None:
    """Set every kernel's count in :data:`launches` to 0."""
    launches.update(dict.fromkeys(KERNELS, 0))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of speech_enhancement_tpu_torch are built from csrc/ "
        "at first use and need the CUDA toolkit")


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the PESQ engine of "
                           "speech_enhancement_tpu_torch is built from csrc/pesq.cc "
                           "at first use")
    return found


def _host_target() -> str:
    """The machine and the target options ``g++ -march=native`` resolves to
    here (``-Q --help=target``): a library built for another CPU hashes
    differently."""
    if not _gxx_target:
        proc = subprocess.run([_gxx(), "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True, check=True)
        _gxx_target.append(f"{platform.machine()}\n{proc.stdout}")
    return _gxx_target[0]


def _digest(sources: list[Path], flags: list[str]) -> str:
    h = hashlib.sha256()
    h.update(" ".join(flags).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _load(name: str, src: Path, sources: list[Path], flags: list[str], command,
          signatures: dict[str, tuple]) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = BUILD_DIR / f"{name}-{_digest(sources, flags)}.so"
        log = out.with_suffix(".log")
        if out.exists() and log.exists():
            build_seconds[name] = 0.0
            build_logs[name] = log.read_text()
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = command(tmp)
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"build of {src.name} failed (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
            build_logs[name] = proc.stdout + proc.stderr
            tmp_log = log.with_suffix(f".{os.getpid()}.tmplog")
            tmp_log.write_text(build_logs[name])
            os.replace(tmp, out)
            os.replace(tmp_log, log)  # last: a library without its log is rebuilt
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        for fn_name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[name] = lib  # published with its entry points typed
        return lib


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built by nvcc if needed.

    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    returns an ``int`` (a ``cudaError_t``)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    return _load(name, src, [src] + sorted(CSRC.glob("*.cuh")), NVCC_FLAGS,
                 lambda out: [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)],
                 {fn: (argtypes, ctypes.c_int) for fn, argtypes in signatures.items()})


def load_host(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for the host source ``csrc/<name>.cc``, built by
    g++ if needed.  ``signatures`` maps each entry point to its
    ``(argtypes, restype)``."""
    src = CSRC / f"{name}.cc"
    return _load(name, src, [src], GXX_FLAGS + [_host_target()],
                 lambda out: [_gxx(), *GXX_FLAGS, "-o", str(out), str(src), "-lpthread"],
                 signatures)


def current_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on a CUDA
    ``device``, as an int: what ``torch.cuda.current_stream(device).cuda_stream``
    gives, without building a ``torch.cuda.Stream`` on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
