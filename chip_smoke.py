#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speech_enhancement_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with a CUDA card, nvcc
(PATH, $CUDA_HOME or /usr/local/cuda) and no JAX needed.  Phases, one line
each (timings beside the card's name and power limit):

1. the device, and ``nvidia-smi --query-gpu=name,power.limit``;
2. build the three kernels from ``csrc/`` (seconds);
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the serving path, with the tolerance stated beside it;
4. the serving path itself: ``Enhancer(fused_stft=True)`` on a full-width
   ``TSCNet(64, 201, fused_attention=True)`` (seeded random weights)
   enhances 12 utterances of 1-4 s at batch 8, in bf16 and fp32; the
   outputs must be finite, in order, cut to length, and agree with the
   same weights run through the plain path; every kernel's launch count
   over that run must be > 0;
5. kernel path against plain path for ``enhance_batch`` on [32, 32000]
   (CUDA events, warm-up, median), and each kernel against its plain
   version.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Any failed check exits 1 without that
last line; with no CUDA device it exits 1 at once.

fp32 comparisons run with TF32 off for matmuls and cuDNN convolutions, so
that the plain path is full fp32.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"    {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def within(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float):
    """(max |got - want|, whether |got - want| <= atol + rtol |want| everywhere)."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return float(diff.max()), ok


def time_pair(kernel_fn, plain_fn, warmup: int = 2, reps: int = 10):
    """Median ms of each function, timed with CUDA events in alternating
    order (kernel, plain, plain, kernel, ...) after a warm-up."""
    for _ in range(warmup):
        kernel_fn()
        plain_fn()
    times = {kernel_fn: [], plain_fn: []}
    for rep in range(reps):
        for fn in ((kernel_fn, plain_fn) if rep % 2 == 0 else (plain_fn, kernel_fn)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[fn].append(start.elapsed_time(end))
    return statistics.median(times[kernel_fn]), statistics.median(times[plain_fn])


def attention_operands(b, n, dtype, gen, h=4, d=16, max_pos=512):
    """q, and k, v as the two halves of one projection (strided views), as
    the time conformer passes them; table as initialized."""
    q = torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype)
    kv = torch.randn(b, n, 2 * h * d, device="cuda", generator=gen).to(dtype)
    k, v = (t.view(b, n, h, d) for t in kv.chunk(2, dim=-1))
    table = torch.randn(2 * max_pos + 1, d, device="cuda", generator=gen).to(dtype)
    return q, k, v, table


def chunked(fn, chunk, *args):
    """``fn`` over slices of the batch axis (the plain attention's logits
    do not fit at the 8 s bucket)."""
    b = args[0].shape[0]
    return torch.cat([fn(*(a[i:i + chunk] for a in args[:3]), *args[3:])
                      for i in range(0, b, chunk)])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from speech_enhancement_tpu_torch.enhance import Enhancer
    from speech_enhancement_tpu_torch.models import TSCNet
    from speech_enhancement_tpu_torch.ops import _native
    from speech_enhancement_tpu_torch.ops import fused_attention as fa
    from speech_enhancement_tpu_torch.ops import fused_stft as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1 device] {kind}, {count} visible; nvidia-smi name,power.limit: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for "
          f"matmuls and cuDNN", flush=True)

    # 2. build
    t0 = time.perf_counter()
    fs.build()
    fa.build()
    print(f"[2 build] stft.cu {_native.build_seconds['stft']:.1f} s, shaw_attention.cu "
          f"{_native.build_seconds['shaw_attention']:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s (nvcc sm_90a)", flush=True)

    # 3. kernels against their plain versions, main-path shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"K1": 0.0, "K4": 0.0, "K5": 0.0}
    print("[3 kernels vs plain] tolerance |kernel - plain| <= atol + rtol |plain|", flush=True)
    # K1: fp32 differs in summation order only (rtol 1e-4, atol 1e-5, as
    # tests/test_pallas_attention.py); bf16 may flip a rounding of P or of
    # the output, one bf16 step of order-1 values (rtol 2e-2, atol 2e-2)
    tols = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
    # main-path shapes (2 s and 8 s at batch 32 have B' = 3232; these are
    # slices of them), then short and clipped edge cases (max_pos_emb 8)
    # and the other head dims the kernel is built for
    both = (torch.float32, torch.bfloat16)
    for b, n, max_pos, d, dtypes in ((404, 321, 512, 16, both), (8, 1281, 512, 16, both),
                                     (5, 7, 512, 16, both), (3, 100, 8, 16, both),
                                     (6, 70, 512, 4, both), (6, 70, 512, 8, both),
                                     (6, 70, 512, 32, both)):
        for dtype in dtypes:
            q, k, v, table = attention_operands(b, n, dtype, gen, d=d, max_pos=max_pos)
            got = fa.fused_shaw_attention(q, k, v, table, max_pos)
            want = fa.shaw_attention_reference(q, k, v, table, max_pos)
            torch.cuda.synchronize()
            err, ok = within(got, want, *tols[dtype])
            errs["K1"] = max(errs["K1"], err)
            check(ok and got.dtype == dtype and got.shape == want.shape,
                  f"K1 shaw attention B'={b} n={n} h=4 d={d} max_pos_emb={max_pos} {dtype}: "
                  f"max abs err {err:.3e} (rtol {tols[dtype][0]}, atol {tols[dtype][1]})")
            del q, k, v, table, got, want
    x = torch.randn(32, 32000, device="cuda", generator=gen)  # RMS 1, as normalized audio
    spec = fs.fused_stft(x)
    spec_ref = fs.stft_reference(x)
    torch.cuda.synchronize()
    # K4: fp32 DFT sums in another order; compression amplifies the error
    # of near-empty bins (rtol 1e-4, atol 2e-4, as tests/test_pallas_stft.py)
    err, ok = within(torch.view_as_real(spec), torch.view_as_real(spec_ref), 1e-4, 2e-4)
    errs["K4"] = err
    check(ok and spec.shape == spec_ref.shape == (32, 321, 201),
          f"K4 stft+compress [32, 32000] fp32: max abs err {err:.3e} (rtol 1e-4, atol 2e-4)")
    # K5: fp32 sums of 201 products of order-1 values in another order;
    # 31963 leaves a ragged last block
    for length in (32000, 31963):
        wav = fs.fused_istft(spec_ref, length=length)
        wav_ref = fs.istft_reference(spec_ref, length=length)
        torch.cuda.synchronize()
        err, ok = within(wav, wav_ref, 1e-4, 1e-4)
        errs["K5"] = max(errs["K5"], err)
        check(ok and wav.shape == wav_ref.shape == (32, length),
              f"K5 uncompress+istft [32, 321, 201] length {length} fp32: max abs err "
              f"{err:.3e} (rtol 1e-4, atol 1e-4)")
    del x, spec, spec_ref, wav, wav_ref
    torch.cuda.empty_cache()

    # 4. the main path, through the entry points a user calls
    model = TSCNet(64, 201, fused_attention=True, device="cuda",
                   generator=torch.Generator().manual_seed(SEED))
    plain_model = TSCNet(64, 201, fused_attention=False, device="cuda")
    plain_model.load_state_dict(model.state_dict())
    rng = np.random.default_rng(SEED)
    lengths = [int(n) for n in rng.integers(16000, 64001, size=12)]
    utts = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]
    kernel_bf16 = Enhancer(model, compute_dtype=torch.bfloat16, fused_stft=True, device="cuda")
    kernel_fp32 = Enhancer(model, fused_stft=True, device="cuda")
    plain_bf16 = Enhancer(plain_model, compute_dtype=torch.bfloat16, device="cuda")
    plain_fp32 = Enhancer(plain_model, device="cuda")

    fa.launches = fs.stft_launches = fs.istft_launches = 0
    t0 = time.perf_counter()
    out = {"kernel bf16": kernel_bf16.enhance(utts, batch_size=8),
           "kernel fp32": kernel_fp32.enhance(utts, batch_size=8)}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"K1": fa.launches, "K4": fs.stft_launches, "K5": fs.istft_launches}
    print(f"[4 main path] 12 utterances {min(lengths)}-{max(lengths)} samples, batch 8, "
          f"bf16 + fp32 kernel path in {main_s:.2f} s (first calls included); "
          f"launches {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} launched {n} times by the main path")
    out["plain bf16"] = plain_bf16.enhance(utts, batch_size=8)
    out["plain fp32"] = plain_fp32.enhance(utts, batch_size=8)
    for name, res in out.items():
        check(len(res) == len(utts) and [len(r) for r in res] == lengths
              and all(r.dtype == np.float32 and np.isfinite(r).all() for r in res),
              f"{name}: 12 finite fp32 outputs, in input order, cut to length")
    ref = np.concatenate(out["plain fp32"])
    # fp32: the kernels and the plain ops differ in summation order only;
    # a random-init 8-conformer stack amplifies that, so 1e-3 (CPU parity
    # at width 16 is 1e-4)
    for name, bound in (("kernel fp32", 1e-3), ("kernel bf16", 0.35), ("plain bf16", 0.35)):
        err = rel_rms(np.concatenate(out[name]), ref)
        check(err < bound, f"{name} vs plain fp32: relative RMS {err:.3e} (bound {bound}; "
              f"bf16 bound as tests/test_enhance.py)")
    err = rel_rms(np.concatenate(out["kernel bf16"]), np.concatenate(out["plain bf16"]))
    print(f"    info kernel bf16 vs plain bf16: relative RMS {err:.3e} (the plain "
          f"attention takes its softmax in bf16, the kernel in fp32)", flush=True)
    del out

    # 5. timings
    print(f"[5 timings] CUDA events, median of 10 after warm-up; card {card}", flush=True)
    batch = (0.1 * rng.standard_normal((32, 32000))).astype(np.float32)
    kernel_ms, plain_ms = time_pair(lambda: kernel_bf16.enhance_batch(batch),
                                    lambda: plain_bf16.enhance_batch(batch), reps=10)
    print(f"    enhance_batch [32, 32000] bf16: kernel path {kernel_ms:.3f} ms, plain path "
          f"{plain_ms:.3f} ms ({card})", flush=True)
    kernel_ms32, plain_ms32 = time_pair(lambda: kernel_fp32.enhance_batch(batch),
                                        lambda: plain_fp32.enhance_batch(batch), reps=6)
    print(f"    enhance_batch [32, 32000] fp32: kernel path {kernel_ms32:.3f} ms, plain path "
          f"{plain_ms32:.3f} ms ({card})", flush=True)
    del kernel_bf16, kernel_fp32, plain_bf16, plain_fp32
    torch.cuda.empty_cache()

    ms = {}
    q, k, v, table = attention_operands(3232, 321, torch.bfloat16, gen)
    ms["K1"] = time_pair(lambda: fa.fused_shaw_attention(q, k, v, table),
                         lambda: fa.shaw_attention_reference(q, k, v, table))
    print(f"    K1 B'=3232 n=321 bf16 (2 s at batch 32): kernel {ms['K1'][0]:.3f} ms, plain "
          f"{ms['K1'][1]:.3f} ms ({card})", flush=True)
    del q, k, v, table
    torch.cuda.empty_cache()
    q, k, v, table = attention_operands(3232, 1281, torch.bfloat16, gen)
    long_ms = time_pair(lambda: fa.fused_shaw_attention(q, k, v, table),
                        lambda: chunked(fa.shaw_attention_reference, 202, q, k, v, table),
                        warmup=1, reps=2)
    print(f"    K1 B'=3232 n=1281 bf16 (8 s at batch 32): kernel {long_ms[0]:.3f} ms, plain "
          f"(16 chunks of 202) {long_ms[1]:.3f} ms ({card})", flush=True)
    del q, k, v, table
    torch.cuda.empty_cache()
    x = torch.randn(32, 32000, device="cuda", generator=gen)
    ms["K4"] = time_pair(lambda: fs.fused_stft(x), lambda: fs.stft_reference(x))
    spec = fs.stft_reference(x)
    ms["K5"] = time_pair(lambda: fs.fused_istft(spec, length=32000),
                         lambda: fs.istft_reference(spec, length=32000))
    print(f"    K4 stft [32, 32000]: kernel {ms['K4'][0]:.3f} ms, plain {ms['K4'][1]:.3f} ms; "
          f"K5 istft [32, 321, 201]: kernel {ms['K5'][0]:.3f} ms, plain "
          f"{ms['K5'][1]:.3f} ms ({card})", flush=True)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    pkg = "speech_enhancement_tpu_torch"
    kernels = [
        {"name": "shaw_attention_fwd", "route": "cuda", "source": f"{pkg}/csrc/shaw_attention.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_attention.py:201"},
        {"name": "stft_compress", "route": "cuda", "source": f"{pkg}/csrc/stft.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_stft.py:74"},
        {"name": "uncompress_istft", "route": "cuda", "source": f"{pkg}/csrc/stft.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_stft.py:157"},
    ]
    for rec, key in zip(kernels, ("K1", "K4", "K5")):
        rec.update(launches=launches[key], max_abs_err=errs[key], ms=ms[key][0],
                   plain_ms=ms[key][1])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
