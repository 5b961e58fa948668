"""What the conformers' conv module hands its middle on the card, and what
the eager middle (GLU -> pad -> depthwise conv -> BatchNorm -> swish)
launches.

* the serving path: ``Enhancer.enhance_batch`` on [2, 32000] with a
  full-width ``TSCNet(64, 201, fused_attention=True)`` of seeded weights,
  fp32 and bf16, with ``fused_conv_module.glu_conv_swish`` and
  ``eager_reason`` spied on: the shape, strides, layout (``u_layout``) and
  dtype of every first-pointwise-conv output they see, and the route
  taken;
* at the serving cells' conformer shapes (the 8 s batch bucket's time and
  frequency conformers, the 6 s batch-1 request's), the eager middle
  profiled one layer at a time after a warm-up: each CUDA kernel's name,
  launches and device time, and the chain's launches in all, against the
  one launch of the kernel route;
* variants of ``csrc/conv_module.cu`` (text edits of a copy, built with
  ``_native``'s flags into ``_build/variants/conv_<name>/`` as
  ``kernel_variants`` builds its own), each held to the plain version and
  timed (``chip_smoke.device_ms``) at the 8 s batch bucket's two
  conformer shapes in fp32 and its time conformer's in bf16, u
  channels-major, in rounds whose order turns.

Run from the repository root on a machine with a card:

    python3 -m speech_enhancement_tpu_torch.probes.conv_module [--part layouts|eager|variants]
"""

from __future__ import annotations

import argparse
import collections
import subprocess

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from speech_enhancement_tpu_torch.enhance import Enhancer
from speech_enhancement_tpu_torch.models import TSCNet
from speech_enhancement_tpu_torch.models.conformer import ConvModule
from speech_enhancement_tpu_torch.ops import fused_conv_module as fcm

# (B', N) of the conformers: 32 x 8 s (1281 frames, 101 bins), 1 x 6 s
SHAPES = {"8 s batch, time": (3232, 1281), "8 s batch, freq": (40992, 101),
          "6 s single, time": (101, 961), "6 s single, freq": (961, 101)}


def cuda_kernels(fn) -> list[tuple[str, int, float]]:
    """(name, launches, device ms) of each CUDA kernel ``fn`` runs."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def serving_layouts() -> None:
    seen = collections.Counter()
    wrapped, reason = fcm.glu_conv_swish, fcm.eager_reason

    def spy_reason(u, conv, padding, norm):
        why = reason(u, conv, padding, norm)
        seen[(tuple(u.shape), u.stride(), fcm.u_layout(u), str(u.dtype), why)] += 1
        return why

    from speech_enhancement_tpu_torch.models import conformer
    conformer.eager_reason = spy_reason
    try:
        model = TSCNet(64, 201, fused_attention=True, device="cuda",
                       generator=torch.Generator().manual_seed(0))
        audio = np.random.default_rng(0).standard_normal((2, 32000)).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            Enhancer(model, compute_dtype=dtype, device="cuda").enhance_batch(audio)
    finally:
        conformer.eager_reason = reason
    torch.cuda.synchronize()
    assert fcm.glu_conv_swish is wrapped
    for (shape, stride, layout, dtype, why), n in sorted(seen.items(), key=str):
        name = {fcm.COLS: "channels-major", fcm.ROWS: "rows"}.get(layout, "other")
        print(f"serving [2, 32000]: u {list(shape)} strides {stride} ({name}) {dtype}: "
              f"{n} calls, route {'kernel' if why is None else 'eager: ' + why}", flush=True)


def eager_kernels() -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    module = ConvModule(64).to("cuda").eval()
    net = module.net
    with torch.no_grad():
        norm = net[5]
        norm.running_mean.normal_(0, 0.5, generator=gen)
        norm.running_var.uniform_(0.5, 2.0, generator=gen)
        for label, (b, n) in SHAPES.items():
            x = torch.randn(b, n, 64, device="cuda", generator=gen)
            u = net[2](net[1](x))
            del x
            layout = {fcm.COLS: "channels-major", fcm.ROWS: "rows"}.get(fcm.u_layout(u), "other")
            pad = net[4].padding
            g = net[3](u)
            p = F.pad(g, pad)
            d = net[4].conv(p)
            z = norm(d)
            s = torch.sigmoid(z)
            stages = {"GLU": lambda: net[3](u), "pad": lambda: F.pad(g, pad),
                      "depthwise conv": lambda: net[4].conv(p), "BatchNorm": lambda: norm(d),
                      "sigmoid": lambda: torch.sigmoid(z), "mul": lambda: z * s}
            print(f"{label} [{b}, 256, {n}] fp32, u {layout} (strides {u.stride()})", flush=True)
            total = 0
            for stage, fn in stages.items():
                fn()
                for name, count, ms in cuda_kernels(fn):
                    total += count
                    print(f"    {stage}: {count} x {ms:.4f} ms  {name}", flush=True)
            chain = lambda: net[6](norm(net[4](net[3](u))))  # noqa: E731
            chain()
            whole = cuda_kernels(chain)
            route = cuda_kernels(lambda: fcm.glu_conv_swish(u, net[4].conv, norm))
            print(f"    eager middle: {total} launches layer by layer, "
                  f"{sum(c for _, c, _ in whole)} as one chain "
                  f"({sum(ms for *_, ms in whole):.4f} ms); kernel route "
                  f"{sum(c for _, c, _ in route)} ({sum(ms for *_, ms in route):.4f} ms)",
                  flush=True)
            del u, g, p, d, z, s
            torch.cuda.empty_cache()


# (file, old, new) edits of csrc/ for each variant
VARIANTS = {
    "as_is": [],
    "b3": [("conv_module.cu", "__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 3)")],
    "run8": [("conv_module.cu", "constexpr int kRun = kRows ? 4 : 8;", "constexpr int kRun = 8;")],
    "run4": [("conv_module.cu", "constexpr int kRun = kRows ? 4 : 8;", "constexpr int kRun = 4;")],
}
# the kernel's instances by their mangled template arguments
INSTANCES = {"IfLb0": "fp32 cols", "IfLb1": "fp32 rows", "I13__nv_bfloat16Lb0": "bf16 cols",
             "I13__nv_bfloat16Lb1": "bf16 rows"}


def build_variant(d):
    """``kernel_variants.build``, printing each instance's registers and spills."""
    import ctypes

    import chip_smoke as cs
    from speech_enhancement_tpu_torch.ops import _native

    out = d / "conv_module.so"
    cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-I", str(d), "-o", str(out),
           str(d / "conv_module.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    for kernel, lines in cs.ptxas_report(proc.stdout + proc.stderr).items():
        which = next((v for k, v in INSTANCES.items() if f"kernel{k}E" in kernel), kernel)
        print(f"    {d.name} {which}: {'; '.join(lines)}", flush=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in fcm._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def variants(card: str, rounds: int = 2) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from speech_enhancement_tpu_torch.ops import _native
    from speech_enhancement_tpu_torch.probes import kernel_variants as kv

    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        futures = {name: pool.submit(build_variant, kv.variant_sources(
                       _native.CSRC, _native.BUILD_DIR / "variants" / f"conv_{name}", edits))
                   for name, edits in VARIANTS.items()}
        libs = {name: f.result() for name, f in futures.items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = {}
    for label, (b, n), dtype in (("time fp32", SHAPES["8 s batch, time"], torch.float32),
                                 ("freq fp32", SHAPES["8 s batch, freq"], torch.float32),
                                 ("time bf16", SHAPES["8 s batch, time"], torch.bfloat16)):
        module = ConvModule(64).to("cuda").eval()
        with torch.no_grad():
            module.net[5].running_var.uniform_(0.5, 2.0, generator=gen)
        module = module.to(dtype)
        u = torch.randn(b, 256, n, device="cuda", generator=gen).to(dtype)
        with torch.no_grad():
            want = fcm.glu_conv_swish_reference(u, module.net[4].conv, module.net[5])
        cases[label] = (u, module.net[4].conv, module.net[5], want)
    torch.cuda.synchronize()

    def use(name):
        fcm._fn = libs[name].se_glu_conv_swish

    for name in VARIANTS:
        use(name)
        errs = {}
        with torch.no_grad():
            for label, (u, conv, norm, want) in cases.items():
                got = fcm.glu_conv_swish(u, conv, norm)
                errs[label] = cs.rel_rms_t(got, want)
                del got
        print(f"    {name}: relative RMS against the plain version "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    names = list(VARIANTS)
    with torch.no_grad():
        for rnd in range(rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                use(name)
                times = {label: cs.device_ms(lambda c=c: fcm.glu_conv_swish(*c[:3]))
                         for label, c in cases.items()}
                print(f"    round {rnd} {name}: "
                      + ", ".join(f"{k} {ms:.4f} ms" for k, ms in times.items())
                      + f" ({card})", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--part", choices=("layouts", "eager", "variants"), action="append")
    parts = parser.parse_args().part or ["layouts", "eager", "variants"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    if "layouts" in parts:
        serving_layouts()
    if "eager" in parts:
        eager_kernels()
    if "variants" in parts:
        variants(card)


if __name__ == "__main__":
    main()
