#!/usr/bin/env python3
"""Time hand-edited variants of the port's CUDA sources against the sources
as they are, on one card.

    python3 speech_enhancement_tpu_torch/probes/kernel_variants.py [--rounds 3]

Run it from the root of a checkout on a machine with a CUDA card and nvcc.
Each variant is a copy of ``csrc/`` with text edits, built by ``nvcc`` with
the flags of ``ops/_native.py`` into ``_build/variants/<name>/`` and loaded
in place of the wrappers' own build.  The variants are design choices the
sources' headers state:

* ``as_is``: the sources unedited;
* ``cvt``: ``to_tf32`` in ``csrc/mma.cuh`` rounds by ``cvt.rna.tf32.f32``
  instead of the two integer instructions (the same values for finite x);
* ``k5_48``: K5 blocks of 3 frame tiles (48 frames) instead of the most
  whose shared memory fits (4 at n_fft 400);
* ``k2_b3``: the fp32 K2's pass B built for 3 resident blocks at d = 16
  (at most 168 registers a thread) instead of 2;
* ``k2_hoist``: the fp32 K2 with ``per_tile`` a plain copy, so that the
  compiler may hoist the splits of the operands a warp holds for a whole
  sequence or block out of the tile loop;
* ``k2_b_one_sweep``: the fp32 K2's pass B producing all D output channels
  in one sweep over the queries instead of 16 a sweep (d = 32: one sweep
  in place of two);
* ``k2_a_bn32``, ``k2_a_bn64``: the fp32 K2's pass A taking key tiles of
  32 or 64 at d = 32 (16 as built).

Prints the card's name and power limit, each variant's ptxas registers and
spills, whether each variant's K4, K5, fp32 K1 and fp32 K2 outputs equal
those of ``as_is`` bit for bit (K2's table gradient, summed with atomics,
is left out), and the device ms (``chip_smoke.device_ms``) of K5 at [32,
321, 201], K4 at [32, 32000], the fp32 K1 at B'=3232 n=321 h=4 d=16 and
the fp32 K2 at B'=808 n=161 h=4 d=16 and d=32, in rounds whose order
turns.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TO_TF32_INT = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
TO_TF32_CVT = ('  uint32_t y;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(y) : "f"(x));\n'
               '  return y;\n')
VARIANTS = {
    "as_is": [],
    "cvt": [("mma.cuh", TO_TF32_INT, TO_TF32_CVT)],
    "k5_48": [("stft.cu", "  int m = kMaxTiles;\n", "  int m = 3;\n")],
    "k2_b3": [("shaw_attention_bwd_tf32.cu",
               "__launch_bounds__(kThreads, 2)\n    bwd_key_tf32_kernel(",
               "__launch_bounds__(kThreads, D == 16 ? 3 : 2)\n    bwd_key_tf32_kernel(")],
    "k2_hoist": [("shaw_attention_bwd_tf32.cu", '  asm volatile("" : "+f"(x));\n', "")],
    "k2_b_one_sweep": [("shaw_attention_bwd_tf32.cu", "  constexpr int DT = kCD / 8;\n",
                        "  constexpr int DT = D / 8;\n"),
                       ("shaw_attention_bwd_tf32.cu", "oc += kCD) {", "oc += D) {")],
    "k2_a_bn32": [("shaw_attention_bwd_tf32.cu", "  constexpr int BN = D == 32 ? 16 : kBN;",
                   "  constexpr int BN = D == 32 ? 32 : kBN;")],
    "k2_a_bn64": [("shaw_attention_bwd_tf32.cu", "  constexpr int BN = D == 32 ? 16 : kBN;",
                   "  constexpr int BN = kBN;"),
                  ("shaw_attention_bwd_tf32.cu", "  constexpr int DP = D == 32 ? 56 : kDP;",
                   "  constexpr int DP = kDP;")],
}
# the libraries each variant builds, with the wrapper entry each replaces
LIBRARIES = (("stft", "fs", "build", "_SIGNATURES"),
             ("shaw_attention_tf32", "fa", "build_tf32", "_SIGNATURES_TF32"),
             ("shaw_attention_bwd_tf32", "fa", "build_bwd_tf32", "_SIGNATURES_BWD_TF32"))


def variant_sources(csrc: Path, out: Path, edits) -> Path:
    """A copy of ``csrc``'s CUDA sources with each (file, old, new) edit made
    once; an edit whose text is missing raises."""
    out.mkdir(parents=True, exist_ok=True)
    for src in csrc.iterdir():
        if src.suffix not in (".cu", ".cuh"):
            continue
        text = src.read_text()
        for name, old, new in edits:
            if src.name == name:
                if text.count(old) != 1:
                    raise ValueError(f"{name}: the edit's text is not there once: {old!r}")
                text = text.replace(old, new)
        (out / src.name).write_text(text)
    return out


def short_name(mangled: str) -> str:
    """``bwd_key_tf32_kernel<32>`` from its mangled name (a length-prefixed
    identifier ending in ``kernel``, then ``ILi<D>E`` for a template)."""
    for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
        for start in range(m.start(), m.end()):  # the length may follow other digits
            name = mangled[m.end():m.end() + int(mangled[start:m.end()])]
            if name.endswith("kernel"):
                arg = re.match(r"ILi(\d+)E", mangled[m.end() + len(name):])
                return f"{name}<{arg.group(1)}>" if arg else name
    return mangled


def build(native, ptxas_report, d: Path, name: str, signatures) -> ctypes.CDLL:
    out = d / f"{name}.so"
    cmd = [native._nvcc(), *native.NVCC_FLAGS, "-I", str(d), "-o", str(out), str(d / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {d.name}/{name}.cu failed:\n{proc.stdout}\n{proc.stderr}")
    for kernel, lines in ptxas_report(proc.stdout + proc.stderr).items():
        print(f"    {d.name} {name} {short_name(kernel)}: {'; '.join(lines)}", flush=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def same_bits(kernel: str, got, want) -> bool:
    """Whether two outputs of ``kernel`` are equal bit for bit: K2's dq, dk
    and dv (its table gradient is summed with atomics, in no fixed order)."""
    import torch

    if kernel.startswith("K2"):
        return all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    return torch.equal(got, want)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from speech_enhancement_tpu_torch.ops import _native
    from speech_enhancement_tpu_torch.ops import fused_attention as fa
    from speech_enhancement_tpu_torch.ops import fused_stft as fs

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    modules = {"fs": fs, "fa": fa}
    with ThreadPoolExecutor(max_workers=len(VARIANTS) * len(LIBRARIES)) as pool:
        futures = {}
        for name, edits in VARIANTS.items():
            d = variant_sources(_native.CSRC, _native.BUILD_DIR / "variants" / name, edits)
            for lib, module, _, signatures in LIBRARIES:
                futures[name, lib] = pool.submit(build, _native, cs.ptxas_report, d, lib,
                                                 getattr(modules[module], signatures))
        libs = {key: f.result() for key, f in futures.items()}

    def use(name):
        for lib, module, entry, _ in LIBRARIES:
            setattr(modules[module], entry, lambda lib=libs[name, lib]: lib)

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x = torch.randn(32, 32000, device="cuda", generator=gen)
    spec = fs.stft_reference(x)
    q, k, v, table = cs.attention_operands(3232, 321, torch.float32, gen)
    calls = {"K5": lambda: fs.fused_istft(spec, length=32000), "K4": lambda: fs.fused_stft(x),
             "K1 fp32": lambda: fa.fused_shaw_attention(q, k, v, table)}
    for d in (16, 32):  # the fp32 K2 at the training shape, its forward by K1
        bq, bk, bv, btable = cs.attention_operands(808, 161, torch.float32, gen, d=d)
        bg = torch.randn(bq.shape, device="cuda", generator=gen)
        bout, blse = fa.fused_shaw_attention_fwd(bq, bk, bv, btable, 512, d ** -0.5,
                                                 with_lse=True)
        calls[f"K2 fp32 d={d}"] = (lambda a=(bq, bk, bv, btable, bout, blse, bg):
                                   fa.fused_shaw_attention_bwd(*a))
    outputs = {}
    for name in VARIANTS:
        use(name)
        outputs[name] = {kernel: fn() for kernel, fn in calls.items()}
        torch.cuda.synchronize()
        same = {kernel: same_bits(kernel, out, outputs["as_is"][kernel])
                for kernel, out in outputs[name].items()}
        print(f"    {name}: outputs equal to as_is bit for bit: {same}", flush=True)
    del outputs
    names = list(VARIANTS)
    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            use(name)
            times = {kernel: cs.device_ms(fn) for kernel, fn in calls.items()}
            print(f"    round {rnd} {name}: "
                  + ", ".join(f"{kernel} {ms:.4f} ms" for kernel, ms in times.items())
                  + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
