#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speech_enhancement_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with a CUDA card, nvcc
(PATH, $CUDA_HOME or /usr/local/cuda), g++ and no JAX needed.  Phases, one
line each (timings beside the card's name and power limit):

1. the device, and ``nvidia-smi --query-gpu=name,power.limit``;
2. build the six native sources of ``csrc/`` (five CUDA sources and the
   PESQ engine), one compiler each, all started together (seconds);
   ptxas's registers and spills of K1's tensor-core instance, and its
   resident warps per SM;
3. K1 (both instances), K4 and K5 against their plain PyTorch versions on
   the card, at the shapes of the serving path, with the tolerance stated
   beside each; K1's row log-sum-exp against the plain one;
4. the serving path itself: ``Enhancer(fused_stft=True)`` on a full-width
   ``TSCNet(64, 201, fused_attention=True)`` (seeded random weights)
   enhances 12 utterances of 1-4 s at batch 8, in bf16 and fp32; the
   outputs must be finite, in order, cut to length, and agree with the
   same weights run through the plain path; every kernel's launch count
   over that run must be > 0;
5. kernel path against plain path for ``enhance_batch`` on [32, 32000]
   (per call), K1's device time per batch from ``torch.profiler``, and the
   kernel rows of K1, K4 and K5: device time, per-call time, plain time,
   bound and library time;
6. K2 (the Shaw-attention backward, through the autograd route whose
   forward is K1) and K6 (the axis swap, forward and backward) against
   their plain versions at training shapes;
7. the training path itself: ``make_fused_gan_train_step`` (generator
   step, host PESQ labels from the port's native engine, self-correcting
   discriminator step) on a full-width ``TSCNet(64, 201,
   fused_attention=True)`` and ``Discriminator(16)``, arch scp, MSE,
   SGD-Nesterov lr 0.01 (discriminator 0.02), batches of 8 x 1 s
   tone-plus-noise; fp32 and bf16 steps, finite losses, a falling
   generator loss on one repeated batch, K1 and K2 launched; one step of
   the kernel path against the plain path (``fused_attention=False``), and
   one with ``fused_relayout=True`` (K6 launched);
8. training timings (CUDA events, median after warm-up): generator step,
   host labels, discriminator step, whole step, kernel path against plain
   path, fp32 and bf16; the kernel rows of K2 and K6; peak device memory
   of a step with and without rematerialization.

Timing: a kernel's device time is CUDA events around N back-to-back calls
(N >= 20, and enough calls for >= 2 ms), queued behind a spin kernel so
that the host's per-call cost leaves no gap between them, divided by N;
its per-call time is CUDA events around one call, host included (median).
A row says whether its working set fits the 50 MB L2 (then the repeated
calls find their inputs there).  Bounds are the larger of the operations
over the card's peak rate for their type and the bytes (each input read
once, each output written once) over 3.35 TB/s.  ``library_ms`` is one
PyTorch call computing the same function, timed here and used nowhere in
the port.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Any failed check exits 1 without that
last line; with no CUDA device it exits 1 at once.

fp32 comparisons run with TF32 off for matmuls and cuDNN convolutions, so
that the plain path is full fp32.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
SR = 16000
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


# peak rates of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
L2_BYTES = 50e6


def device_ms(fn, min_ms: float = 2.0, min_n: int = 20, max_n: int = 400) -> float:
    """Device ms per call of ``fn``: CUDA events around ``n`` back-to-back
    calls, divided by ``n``.  The calls are queued behind a spin kernel
    (``torch.cuda._sleep``) that outlasts the host's enqueueing, so the
    card runs them without waiting on the host; ``n >= min_n``, grown until
    the calls take >= ``min_ms`` (at most ``max_n`` calls).  A ``fn`` that
    waits on the card itself (an allocation that frees cached blocks)
    outlasts any spin: after three longer spins its time is taken as it
    comes, host gaps included."""
    fn()
    torch.cuda.synchronize()
    n, cycles, spins = min_n, 20_000_000, 0
    while True:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        for _ in range(n):
            fn()
        marks[2].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        marks[2].synchronize()
        spin_ms, total = marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])
        if enqueue_ms > 0.9 * spin_ms and spins < 3:  # the card may have waited
            cycles = int(cycles * 2 * enqueue_ms / max(spin_ms, 1e-3))
            spins += 1
            continue
        if total >= min_ms or n >= max_n:
            return total / n
        n = min(max_n, math.ceil(n * 1.2 * min_ms / max(total, 1e-3)))


def bound(flops: float, nbytes: float, dtype=torch.bfloat16) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def library(fn) -> float | None:
    """Device ms of a PyTorch yardstick call, or None (printed) when PyTorch
    refuses it here; the yardstick is not the port, so its refusal is no
    failure."""
    try:
        return device_ms(fn)
    except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
        print(f"    info library call refused: {str(exc).splitlines()[0][:200]}", flush=True)
        torch.cuda.empty_cache()
        return None


def row(name: str, dev: float, call: float, plain: float, bnd: tuple, nbytes: float,
        lib: float | None, card: str, extra: str = "") -> dict:
    """Print one kernel row; returns its numbers for the kernels line."""
    warm = ("L2-warm" if nbytes < L2_BYTES else "L2-cold") + f" ({nbytes / 1e6:.2f} MB moved)"
    lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
    print(f"    {name}: device {dev:.4f} ms, per call {call:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bnd[0]:.4f} ms ({bnd[1]}; {100 * bnd[0] / dev:.1f}% of bound), "
          f"library {lib_s}; {warm}{extra} ({card})", flush=True)
    return {"ms": dev, "device_ms": dev, "call_ms": call, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
            "l2_warm": nbytes < L2_BYTES}


def attention_bound(b, n, dtype, h=4, d=16):
    """K1: three n x n x d contractions per (sequence, head); q, k, v, out."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * n * h * d * elem
    return bound(6.0 * b * h * n * n * d, nbytes, dtype), nbytes


def sdpa_yardstick(q, k, v, table, max_pos=512):
    """(SDPA alone, bias build + SDPA): ``scaled_dot_product_attention``
    with the Shaw bias ``[B', h, n, n]`` as its mask, built by the plain
    gather and einsum; q, k, v as [B', h, n, d] views."""
    import torch.nn.functional as F

    from speech_enhancement_tpu_torch.ops.fused_attention import relative_index

    d = q.shape[-1]
    idx = relative_index(q.shape[1], max_pos, q.device)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def build_bias():
        return torch.einsum("bhid,ijd->bhij", qt, table[idx]) * d ** -0.5

    bias = build_bias()
    alone = library(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias))
    del bias
    torch.cuda.empty_cache()
    chain = library(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=build_bias()))
    return alone, chain


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


def rel_rms_t(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative RMS of two tensors, computed in float64 on their device."""
    got, want = got.double(), want.double()
    return float(((got - want).pow(2).mean() / want.pow(2).mean()).sqrt())


def make_batches(rng, n: int, batch: int = 8, length: int = SR):
    """Tone-plus-noise batches on the card (voiced energy for PESQ), one
    pitch per step, as scripts/bench_train_step.py makes them."""
    t = np.arange(length) / SR
    out = []
    for i in range(n):
        tone = (0.3 * np.sin(2 * np.pi * (160.0 + 10.0 * (i % 7)) * t)
                * (0.55 + 0.45 * np.sin(2 * np.pi * 3.1 * t)))
        clean = np.stack([tone * (1.0 + 0.01 * j) for j in range(batch)])
        noisy = clean + 0.05 * rng.standard_normal((batch, length))
        out.append(tuple(torch.from_numpy(a.astype(np.float32)).cuda() for a in (clean, noisy)))
    return out


def read_grads(opt, module) -> dict:
    """Wrap ``opt.step`` so that it first copies every gradient it takes."""
    names = [n for n, _ in module.named_parameters()]
    grads: dict = {}
    step = opt.step

    def step_reading_grads():
        grads.update((n, p.grad.clone()) for n, p in zip(names, opt.params))
        step()

    opt.step = step_reading_grads
    return grads


def training_phases(card: str, gen: torch.Generator) -> dict:
    """Phases 6-8: K2 and K6 against their plain versions, the training
    path through ``make_fused_gan_train_step``, and its timings.  Returns
    the launch counts (K1's too), errors and kernel rows of K2 and K6."""
    from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
    from speech_enhancement_tpu_torch.ops import fused_attention as fa
    from speech_enhancement_tpu_torch.ops import fused_relayout as fr
    from speech_enhancement_tpu_torch.train import (
        create_gan_state,
        gan_discriminator_step,
        gan_generator_step,
        l2_loss,
        make_fused_gan_train_step,
    )
    from speech_enhancement_tpu_torch.train.gan import host_pesq_labels

    errs = {"K2": 0.0, "K6": 0.0}
    rows = {}

    # 6. K2 and K6 against their plain versions, at training shapes
    print("[6 training kernels vs plain] K2 fp32: dq, dk, dv within rtol 1e-4 + atol 1e-5 "
          "(summation order), dtable relative RMS < 1e-5 (fp32 atomics); bf16: relative "
          "RMS < 1e-2 for each (roundings of P and dS*scale may flip); K6 exact", flush=True)
    both = (torch.float32, torch.bfloat16)
    names = ("dq", "dk", "dv", "dtable")
    # B' = 808 n = 161: the time conformer of batch 8 x 1 s; n = 1281: the
    # length at which the JAX package took K3; max_pos_emb 8: clipped
    # table rows; then the other head dims K2 is built for
    for b, n, max_pos, d in ((808, 161, 512, 16), (8, 1281, 512, 16), (3, 100, 8, 16),
                             (8, 1281, 8, 16), (6, 70, 512, 4), (6, 70, 512, 8),
                             (6, 70, 512, 32)):
        for dtype in both:
            q, k, v, table = attention_operands(b, n, dtype, gen, d=d, max_pos=max_pos)
            g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, table)]
            out = fa.fused_shaw_attention(*leaves, max_pos)
            got = torch.autograd.grad(out, leaves, g)
            want = fa.shaw_attention_bwd_reference(q, k, v, table, g, max_pos)
            torch.cuda.synchronize()
            report = []
            ok = all(a.dtype == dtype and a.shape == w.shape for a, w in zip(got, want))
            for name, a, w in zip(names, got, want):
                err = float((a.float() - w.float()).abs().max())
                errs["K2"] = max(errs["K2"], err)
                rr = rel_rms_t(a, w)
                if dtype == torch.bfloat16:
                    ok = ok and rr < 1e-2
                elif name == "dtable":
                    ok = ok and rr < 1e-5
                else:
                    ok = ok and within(a, w, 1e-4, 1e-5)[1]
                report.append(f"{name} {err:.2e}/{rr:.1e}")
            check(ok, f"K2 B'={b} n={n} h=4 d={d} max_pos_emb={max_pos} {dtype}: max abs err"
                      f"/relative RMS {', '.join(report)}")
            del q, k, v, table, g, leaves, out, got, want
        torch.cuda.empty_cache()
    for shape in ((8, 101, 161, 64), (32, 101, 321, 64)):  # [B, F, T, C] of 1 s and 2 s
        for dtype in both:
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype).requires_grad_()
            y = fr.swap_seq_axes(x)
            gy = torch.randn(y.shape, device="cuda", generator=gen).to(dtype)
            (gx,) = torch.autograd.grad(y, x, gy)
            y = y.detach()
            want_y, want_gx = x.detach().transpose(1, 2).contiguous(), gy.transpose(1, 2)
            torch.cuda.synchronize()
            err = max(float((y - want_y).abs().max()), float((gx - want_gx).abs().max()))
            errs["K6"] = max(errs["K6"], err)
            check(torch.equal(y, want_y) and torch.equal(gx, want_gx) and y.is_contiguous(),
                  f"K6 swap {list(shape)} {dtype} forward and backward: exact (max abs err {err})")
    del x, y, gy, gx, want_y, want_gx
    torch.cuda.empty_cache()

    # 7. the training path, through the entry point a user calls
    def new_state(fused_attention=True, fused_relayout=False, remat=True):
        gen_model = TSCNet(64, 201, fused_attention=fused_attention,
                           fused_relayout=fused_relayout, remat=remat, device="cuda",
                           generator=torch.Generator().manual_seed(SEED))
        disc = Discriminator(16, device="cuda", generator=torch.Generator().manual_seed(SEED + 1))
        # main_gan's defaults: SGD-Nesterov, momentum 0.9, decay 0.01, disc lr 2x
        return create_gan_state(gen_model, disc, "sgd", 0.01, momentum=0.9, weight_decay=0.01)

    rng = np.random.default_rng(SEED)
    batches = make_batches(rng, 4)
    steps = {dtype: make_fused_gan_train_step(criterion=l2_loss, arch="scp",
                                              compute_dtype=None if dtype == torch.float32
                                              else dtype) for dtype in both}
    states = {dtype: new_state() for dtype in both}
    fa.launches = fa.mma_launches = fa.bwd_launches = fr.launches = 0
    t0 = time.perf_counter()
    history = {dtype: [] for dtype in both}
    for dtype in both:
        clean, noisy = batches[0]
        for i in range(3):  # one repeated batch
            history[dtype].append(steps[dtype](states[dtype], clean, noisy, i))
        clean, noisy = batches[1]
        history[dtype].append(steps[dtype](states[dtype], clean, noisy, 3))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"K1 tensor-core": fa.mma_launches, "K1 CUDA-core": fa.launches,
                "K2": fa.bwd_launches}
    print(f"[7 training path] make_fused_gan_train_step, TSCNet(64, 201, fused_attention=True) "
          f"+ Discriminator(16), scp, batch 8 x 16000, 4 steps each fp32 and bf16 in "
          f"{train_s:.2f} s (first calls included); launches {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} launched {n} times by the training path")
    for dtype in both:
        values = [{k: float(v) for k, v in m.items()} for m in history[dtype]]
        check(all(np.isfinite(x) for m in values for x in m.values()),
              f"{dtype} training: every loss finite")
        gen_losses = [m["loss"] for m in values[:3]]
        check(gen_losses[-1] < gen_losses[0],
              f"{dtype} generator loss on one repeated batch falls: "
              f"{', '.join(f'{x:.5f}' for x in gen_losses)}")
        print(f"    info {dtype} last step: "
              + ", ".join(f"{k} {v:.5f}" for k, v in values[-1].items()), flush=True)
    del states

    # one fp32 step from the same weights, batch and seed: kernel path, and
    # kernel path with the K6 fold, against the plain path
    clean, noisy = batches[2]
    runs = {}
    for label, fused_attention, fused_relayout in (("plain", False, False),
                                                   ("kernel", True, False),
                                                   ("kernel+K6", True, True)):
        state = new_state(fused_attention, fused_relayout)
        grads = read_grads(state.gen_opt, state.gen)
        fr.launches = 0
        metrics = steps[torch.float32](state, clean, noisy, 100)
        torch.cuda.synchronize()
        runs[label] = ({k: float(v) for k, v in metrics.items()}, grads, fr.launches)
        del state
    k6_launches = runs["kernel+K6"][2]
    check(k6_launches > 0 and runs["kernel"][2] == 0,
          f"K6 launched {k6_launches} times by the fused_relayout=True step (0 without)")
    plain_metrics, plain_grads, _ = runs["plain"]
    for label in ("kernel", "kernel+K6"):
        metrics, grads, _ = runs[label]
        gen_keys = ("loss_ri", "loss_mag", "time_loss", "gan_loss", "loss")
        loss_ok = all(abs(metrics[k] - plain_metrics[k]) <= 1e-4 * abs(plain_metrics[k])
                      for k in gen_keys)
        flat = [torch.cat([d[k].reshape(-1) for k in plain_grads]) for d in (grads, plain_grads)]
        grad_err = rel_rms_t(*flat)
        # leaves whose gradient is an exact zero (conv biases in front of a
        # norm) carry rounding only, and are left out of the worst leaf
        largest = max(float(g.double().pow(2).mean().sqrt()) for g in plain_grads.values())
        worst = max(rel_rms_t(grads[k], plain_grads[k]) for k in plain_grads
                    if float(plain_grads[k].double().pow(2).mean().sqrt()) > 1e-6 * largest)
        check(loss_ok and grad_err < 1e-3,
              f"fp32 step, {label} path vs plain path: generator losses within rtol 1e-4, "
              f"gradients relative RMS {grad_err:.2e} (bound 1e-3; worst leaf {worst:.2e}); "
              f"disc_loss {metrics['disc_loss']:.6f} vs {plain_metrics['disc_loss']:.6f} "
              f"(PESQ labels of the two estimates)")
    del runs, plain_grads
    torch.cuda.empty_cache()

    # 8. timings
    print(f"[8 training timings] CUDA events, median of 3 after a warm-up step; card {card}",
          flush=True)

    def phase_times(state, compute_dtype):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        times = []
        for i in range(4):
            clean, noisy = batches[i % len(batches)]
            events[0].record()
            aux = gan_generator_step(state, clean, noisy, i, criterion=l2_loss,
                                     compute_dtype=compute_dtype)
            events[1].record()
            ref = aux.clean_audio
            labels = [host_pesq_labels(ref, other) for other in
                      (aux.est_audio, ref, aux.noisy_audio)]
            events[2].record()
            gan_discriminator_step(state, aux, *labels, i, criterion=l2_loss)
            events[3].record()
            events[3].synchronize()
            if i:  # the first is the warm-up
                times.append([events[j].elapsed_time(events[j + 1]) for j in range(3)]
                             + [events[0].elapsed_time(events[3])])
        return [statistics.median(t[j] for t in times) for j in range(4)]

    for dtype in both:
        compute_dtype = None if dtype == torch.float32 else dtype
        order = (("kernel", True), ("plain", False), ("plain", False), ("kernel", True))
        collected = {"kernel": [], "plain": []}
        for label, fused_attention in order:
            state = new_state(fused_attention)
            collected[label].append(phase_times(state, compute_dtype))
            del state
        for label, runs_ in collected.items():
            med = [statistics.median(r[j] for r in runs_) for j in range(4)]
            print(f"    training step {dtype} {label} path: generator {med[0]:.3f} ms, host "
                  f"labels {med[1]:.3f} ms, discriminator {med[2]:.3f} ms, whole step "
                  f"{med[3]:.3f} ms ({card})", flush=True)
    torch.cuda.empty_cache()

    for b, n in ((808, 161), (3232, 321)):
        q, k, v, table = attention_operands(b, n, torch.bfloat16, gen)
        g = torch.randn(q.shape, device="cuda", generator=gen).to(torch.bfloat16)
        out, lse = fa.fused_shaw_attention_fwd(q, k, v, table, 512, 0.25, with_lse=True)
        kernel = lambda: fa.fused_shaw_attention_bwd(q, k, v, table, out, lse, g)  # noqa: E731
        call, plain = time_pair(kernel, lambda: fa.shaw_attention_bwd_reference(q, k, v, table, g),
                                warmup=1, reps=6)
        # eight n x n x d contractions (s, the bias, dP, dV, dQ and its
        # bias term, dK, dtable); q, k, v, out, g, lse in, dq, dk, dv out
        nbytes = 8 * q.numel() * 2 + lse.numel() * 4 + table.numel() * 2
        bnd = bound(16.0 * b * 4 * n * n * 16, nbytes)
        lib = None
        if b == 808:
            # the yardstick's backward: autograd through the Shaw-bias build
            # and scaled_dot_product_attention (K1's library call)
            import torch.nn.functional as F
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, table)]
            qt, kt, vt = (t.transpose(1, 2) for t in leaves[:3])
            bias = torch.einsum("bhid,ijd->bhij", qt,
                                leaves[3][fa.relative_index(n, 512, q.device)]) * 0.25
            y = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias).transpose(1, 2)
            lib = library(lambda: torch.autograd.grad(y, leaves, g, retain_graph=True))
            del leaves, qt, kt, vt, bias, y
        r = row(f"K2 B'={b} n={n} bf16", device_ms(kernel), call, plain, bnd, nbytes, lib, card,
                "; library: autograd backward of the bias build and SDPA" if b == 808 else "")
        if b == 808:
            rows["K2"] = r
        del q, k, v, table, g, out, lse
        torch.cuda.empty_cache()
    for shape, target in (((8, 101, 161, 64), "no slower than transpose().contiguous()"),
                          ((32, 101, 321, 64), ">= 65% of the bound")):
        x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
        call, plain = time_pair(lambda: fr.swap_seq_axes(x), lambda: fr.swap_seq_axes_reference(x),
                                reps=20)
        host = {}
        for name, fn in (("kernel", lambda: fr.swap_seq_axes(x)),
                         ("torch", lambda: fr.swap_seq_axes_reference(x))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host[name] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        nbytes = 2 * x.numel() * 2
        dev = device_ms(lambda: fr.swap_seq_axes(x))
        lib = library(lambda: x.transpose(1, 2).contiguous())
        r = row(f"K6 {list(shape)} bf16", dev, call, plain, bound(0.0, nbytes), nbytes, lib, card,
                f"; host enqueue per call: wrapper {host['kernel']:.1f} us, "
                f"transpose().contiguous() {host['torch']:.1f} us; aim: {target}")
        r["host_us"] = host["kernel"]
        if shape[0] == 8:
            rows["K6"] = r
            rows["K6"]["serving"] = None
        else:
            rows["K6"]["serving"] = r
        del x
    torch.cuda.empty_cache()

    clean, noisy = batches[0]
    for remat in (True, False):
        state = new_state(remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gan_generator_step(state, clean, noisy, 0, criterion=l2_loss,
                           compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"    peak device memory of a bf16 generator step, remat={remat}: "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
              f"{base / 2**30:.3f} GiB held before it) ({card})", flush=True)
        del state
        torch.cuda.empty_cache()
    return {"launches": {**launches, "K6": k6_launches}, "errs": errs, "rows": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    started = time.perf_counter()
    from speech_enhancement_tpu_torch.enhance import Enhancer
    from speech_enhancement_tpu_torch.metrics import pesq
    from speech_enhancement_tpu_torch.models import TSCNet
    from speech_enhancement_tpu_torch.ops import _native
    from speech_enhancement_tpu_torch.ops import fused_attention as fa
    from speech_enhancement_tpu_torch.ops import fused_relayout as fr
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

    # 2. build: one compiler per source, all at once
    t0 = time.perf_counter()
    builds = (fs.build, fa.build, fa.build_mma, fa.build_bwd, fr.build, pesq.build)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for build in [pool.submit(b) for b in builds]:
            build.result()
    built = ", ".join(f"{name} {sec:.1f} s" for name, sec in _native.build_seconds.items())
    print(f"[2 build] {built}; wall {time.perf_counter() - t0:.1f} s (nvcc sm_90a and g++, "
          f"in parallel)", flush=True)
    report, head_dim = {}, None  # ptxas -v of each d instance
    for line in _native.build_logs.get("shaw_attention_mma", "").splitlines():
        if "Compiling entry function" in line:
            head_dim = line.split("shaw_attention_mma_kernelILi")[1].split("E")[0]
        elif head_dim and ("registers" in line or "spill" in line):
            report.setdefault(head_dim, []).append(line.strip())
    for d, lines in sorted(report.items()):
        print(f"    info ptxas -v, K1 tensor-core instance d={d}: {'; '.join(lines)}", flush=True)
    check(sorted(report) == ["16", "32"]
          and all(" 0 bytes spill stores, 0 bytes spill loads" in line
                  for lines in report.values() for line in lines if "spill" in line),
          "K1 tensor-core instance: ptxas reports no spills at d=16 and d=32")
    for d in (16, 32):
        warps = 4 * fa.mma_occupancy(d)
        check(warps >= 8, f"K1 tensor-core instance d={d}: {warps} resident warps per SM "
                          f"(at least 8)")

    # 3. kernels against their plain versions, main-path shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"K1": 0.0, "K1mma": 0.0, "K4": 0.0, "K5": 0.0}
    print("[3 kernels vs plain] tolerance |kernel - plain| <= atol + rtol |plain|", flush=True)
    # K1: fp32 differs in summation order only (rtol 1e-4, atol 1e-5, as
    # tests/test_pallas_attention.py); bf16 may flip a rounding of P or of
    # the output, one bf16 step of order-1 values (rtol 2e-2, atol 2e-2)
    tols = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
    # main-path shapes (2 s and 8 s at batch 32 have B' = 3232; these are
    # slices of them), then short, full-tile and clipped edge cases
    # (max_pos_emb 8) and the other head dims; bf16 at d 16 and 32 takes
    # the tensor-core instance, the rest the CUDA-core one
    both = (torch.float32, torch.bfloat16)
    for b, n, max_pos, d, dtypes in ((404, 321, 512, 16, both), (8, 1281, 512, 16, both),
                                     (5, 7, 512, 16, both), (3, 100, 8, 16, both),
                                     (2, 64, 512, 16, both), (8, 1281, 8, 16, both),
                                     (6, 321, 512, 32, both), (4, 1281, 512, 32, both),
                                     (5, 7, 512, 32, both), (3, 100, 8, 32, both),
                                     (6, 70, 512, 4, both), (6, 70, 512, 8, both)):
        for dtype in dtypes:
            q, k, v, table = attention_operands(b, n, dtype, gen, d=d, max_pos=max_pos)
            instance = fa.kernel_instance(dtype, d)
            got, lse = fa.fused_shaw_attention_fwd(q, k, v, table, max_pos, d ** -0.5,
                                                   with_lse=True)
            want = fa.shaw_attention_reference(q, k, v, table, max_pos)
            # the row log-sum-exp K2 reads: fp32 sums of the same logits in
            # another order (atol 1e-4 on values of order 10)
            rel = table[fa.relative_index(n, max_pos, q.device)].float()
            logits = (torch.einsum("bihd,bjhd->bhij", q.float(), k.float())
                      + torch.einsum("bihd,ijd->bhij", q.float(), rel)) * d ** -0.5
            lse_err = float((lse - torch.logsumexp(logits, -1)).abs().max())
            torch.cuda.synchronize()
            err, ok = within(got, want, *tols[dtype])
            key = "K1mma" if instance == "tensor_core" else "K1"
            errs[key] = max(errs[key], err)
            check(ok and lse_err < 1e-4 and got.dtype == dtype and got.shape == want.shape,
                  f"K1 ({instance}) B'={b} n={n} h=4 d={d} max_pos_emb={max_pos} {dtype}: "
                  f"max abs err {err:.3e} (rtol {tols[dtype][0]}, atol {tols[dtype][1]}); "
                  f"lse max abs err {lse_err:.2e} (atol 1e-4)")
            del q, k, v, table, got, lse, want, rel, logits
        torch.cuda.empty_cache()
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

    fa.launches = fa.mma_launches = fs.stft_launches = fs.istft_launches = 0
    t0 = time.perf_counter()
    out = {"kernel bf16": kernel_bf16.enhance(utts, batch_size=8),
           "kernel fp32": kernel_fp32.enhance(utts, batch_size=8)}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"K1 tensor-core": fa.mma_launches, "K1 CUDA-core": fa.launches,
                "K4": fs.stft_launches, "K5": fs.istft_launches}
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
    for name, limit in (("kernel fp32", 1e-3), ("kernel bf16", 0.35), ("plain bf16", 0.35)):
        err = rel_rms(np.concatenate(out[name]), ref)
        check(err < limit, f"{name} vs plain fp32: relative RMS {err:.3e} (bound {limit}; "
              f"bf16 bound as tests/test_enhance.py)")
    err = rel_rms(np.concatenate(out["kernel bf16"]), np.concatenate(out["plain bf16"]))
    print(f"    info kernel bf16 vs plain bf16: relative RMS {err:.3e} (the plain "
          f"attention takes its softmax in bf16, the kernel in fp32)", flush=True)
    del out

    # 5. timings
    print(f"[5 timings] per call: CUDA events around one call, median of 10 after "
          f"warm-up; device: see the header; card {card}", flush=True)
    batch = (0.1 * rng.standard_normal((32, 32000))).astype(np.float32)
    kernel_ms, plain_ms = time_pair(lambda: kernel_bf16.enhance_batch(batch),
                                    lambda: plain_bf16.enhance_batch(batch), reps=10)
    print(f"    enhance_batch [32, 32000] bf16: kernel path {kernel_ms:.3f} ms, plain path "
          f"{plain_ms:.3f} ms ({card})", flush=True)
    kernel_ms32, plain_ms32 = time_pair(lambda: kernel_fp32.enhance_batch(batch),
                                        lambda: plain_fp32.enhance_batch(batch), reps=6)
    print(f"    enhance_batch [32, 32000] fp32: kernel path {kernel_ms32:.3f} ms, plain path "
          f"{plain_ms32:.3f} ms ({card})", flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernel_bf16.enhance_batch(batch)
    kernel_us = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    total_ms = sum(us for _, us in kernel_us) / 1e3
    k1_ms = sum(us for key, us in kernel_us if "shaw_attention" in key) / 1e3
    print(f"    torch.profiler, one enhance_batch [32, 32000] bf16, kernel path: "
          f"{total_ms:.3f} ms of device kernel time, K1 {k1_ms:.3f} ms "
          f"({100 * k1_ms / total_ms:.1f}%) ({card})", flush=True)
    busiest = sorted(kernel_us, key=lambda e: -e[1])[:6]
    print("    info busiest kernels: " + "; ".join(f"{us / 1e3:.3f} ms {key[:60]}"
                                               for key, us in busiest), flush=True)
    del kernel_bf16, kernel_fp32, plain_bf16, plain_fp32, prof
    torch.cuda.empty_cache()

    rows = {}
    q, k, v, table = attention_operands(3232, 321, torch.bfloat16, gen)
    call, plain = time_pair(lambda: fa.fused_shaw_attention(q, k, v, table),
                            lambda: fa.shaw_attention_reference(q, k, v, table))
    alone, chain = sdpa_yardstick(q, k, v, table)
    bnd, nbytes = attention_bound(3232, 321, torch.bfloat16)
    rows["K1mma"] = row("K1 tensor-core B'=3232 n=321 bf16 (2 s at batch 32)",
                        device_ms(lambda: fa.fused_shaw_attention(q, k, v, table)), call,
                        plain, bnd, nbytes, alone, card,
                        f"; SDPA with the bias built beforehand "
                        f"{'n/a' if chain is None else f'{chain:.4f} ms'}")
    rows["K1mma"]["library_chain_ms"] = chain
    del q, k, v, table
    torch.cuda.empty_cache()
    q, k, v, table = attention_operands(3232, 1281, torch.bfloat16, gen)
    call, plain = time_pair(lambda: fa.fused_shaw_attention(q, k, v, table),
                            lambda: chunked(fa.shaw_attention_reference, 202, q, k, v, table),
                            warmup=1, reps=2)
    bnd, nbytes = attention_bound(3232, 1281, torch.bfloat16)
    long = row("K1 tensor-core B'=3232 n=1281 bf16 (8 s at batch 32)",
               device_ms(lambda: fa.fused_shaw_attention(q, k, v, table)), call,
               plain, bnd, nbytes, None, card, "; plain in 16 chunks of 202, SDPA's "
               "26 GB bias does not fit")
    rows["K1mma"]["n1281"] = long
    del q, k, v, table
    torch.cuda.empty_cache()
    q, k, v, table = attention_operands(10272, 101, torch.bfloat16, gen)
    eager = device_ms(lambda: torch.softmax(
        (torch.einsum("bihd,bjhd->bhij", q, k) + torch.einsum(
            "bihd,ijd->bhij", q, table[fa.relative_index(101, 512, q.device)])) * 0.25,
        dim=-1) @ v.transpose(1, 2))
    print(f"    info K1 tensor-core at the freq conformer's B'=10272 n=101 bf16 (not routed "
          f"through K1): device {device_ms(lambda: fa.fused_shaw_attention(q, k, v, table)):.4f}"
          f" ms; the eager bf16 attention there {eager:.4f} ms ({card})", flush=True)
    del q, k, v, table
    torch.cuda.empty_cache()
    q, k, v, table = attention_operands(3232, 321, torch.float32, gen)
    call, plain = time_pair(lambda: fa.fused_shaw_attention(q, k, v, table),
                            lambda: fa.shaw_attention_reference(q, k, v, table))
    bnd, nbytes = attention_bound(3232, 321, torch.float32)
    rows["K1"] = row("K1 CUDA-core B'=3232 n=321 fp32",
                     device_ms(lambda: fa.fused_shaw_attention(q, k, v, table)), call, plain,
                     bnd, nbytes, sdpa_yardstick(q, k, v, table)[0], card)
    del q, k, v, table
    torch.cuda.empty_cache()

    x = torch.randn(32, 32000, device="cuda", generator=gen)
    spec = fs.stft_reference(x)
    window = torch.hamming_window(400, device="cuda")
    # K4, K5: what an FFT-based STFT needs, a real FFT of 400 samples per
    # frame (2.5 N log2 N flops) plus the window and a few flops per bin for
    # the compression; the bytes (20.6 MB) bound it, not these 0.12 GFLOP
    fft_flops = 32 * 321 * (2.5 * 400 * math.log2(400) + 400 + 8 * 201)
    stft_bytes = x.numel() * 4 + spec.numel() * 8
    call, plain = time_pair(lambda: fs.fused_stft(x), lambda: fs.stft_reference(x))
    rows["K4"] = row("K4 stft+compress [32, 32000] fp32", device_ms(lambda: fs.fused_stft(x)),
                     call, plain, bound(fft_flops, stft_bytes, torch.float32), stft_bytes,
                     library(lambda: fs._gated_rescale(torch.stft(
                         x, 400, 100, window=window, return_complex=True).transpose(1, 2),
                         -0.35)), card, "; library: torch.stft, then the compression")
    call, plain = time_pair(lambda: fs.fused_istft(spec, length=32000),
                            lambda: fs.istft_reference(spec, length=32000))
    rows["K5"] = row("K5 uncompress+istft [32, 321, 201] fp32",
                     device_ms(lambda: fs.fused_istft(spec, length=32000)), call, plain,
                     bound(fft_flops, stft_bytes, torch.float32), stft_bytes,
                     library(lambda: torch.istft(
                         fs._gated_rescale(spec, (1.0 / 0.3 - 1.0) / 2.0).transpose(1, 2),
                         400, 100, window=window, length=32000)), card,
                     "; library: the uncompression, then torch.istft")
    del x, spec
    torch.cuda.empty_cache()

    # 6-8. the training path
    train = training_phases(card, gen)
    print(f"[done] {time.perf_counter() - started:.1f} s, build included", flush=True)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    pkg = "speech_enhancement_tpu_torch"
    tl = train["launches"]
    kernels = [
        {"name": "shaw_attention_fwd_tensor_core", "route": "cuda",
         "source": f"{pkg}/csrc/shaw_attention_mma.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_attention.py:201",
         "launches": launches["K1 tensor-core"] + tl["K1 tensor-core"],
         "max_abs_err": errs["K1mma"], **rows["K1mma"]},
        {"name": "shaw_attention_fwd_cuda_core", "route": "cuda",
         "source": f"{pkg}/csrc/shaw_attention.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_attention.py:201",
         "launches": launches["K1 CUDA-core"] + tl["K1 CUDA-core"],
         "max_abs_err": errs["K1"], **rows["K1"]},
        {"name": "shaw_attention_bwd", "route": "cuda",
         "source": f"{pkg}/csrc/shaw_attention_bwd.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_attention.py:533 and :616",
         "launches": tl["K2"], "max_abs_err": train["errs"]["K2"], **train["rows"]["K2"]},
        {"name": "stft_compress", "route": "cuda", "source": f"{pkg}/csrc/stft.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_stft.py:74",
         "launches": launches["K4"], "max_abs_err": errs["K4"], **rows["K4"]},
        {"name": "uncompress_istft", "route": "cuda", "source": f"{pkg}/csrc/stft.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_stft.py:157",
         "launches": launches["K5"], "max_abs_err": errs["K5"], **rows["K5"]},
        {"name": "swap_seq_axes", "route": "cuda", "source": f"{pkg}/csrc/relayout.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_relayout.py:48",
         "launches": tl["K6"], "max_abs_err": train["errs"]["K6"], **train["rows"]["K6"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
