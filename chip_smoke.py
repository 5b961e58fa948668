#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speech_enhancement_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with a CUDA card, nvcc
(PATH, $CUDA_HOME or /usr/local/cuda), g++ and no JAX needed.  Phases, one
line each (timings beside the card's name and power limit):

1. the device, and ``nvidia-smi --query-gpu=name,power.limit``; whether
   scipy imports;
2. build the eleven native sources of ``csrc/`` (ten CUDA sources and the
   PESQ engine), one compiler each, all started together (seconds);
   ptxas's registers and spills of the tensor-core instances of K1 and K2
   (bf16 and fp32 each), of K4 and K5, of the add-and-norm kernels and of
   the conv-module kernel (no spills allowed), and their resident warps
   per SM;
3. the serving path's kernels, from the table :data:`KERNELS`: K1 (all
   three instances: bf16 and fp32 on tensor cores at d 16 and 32, B'=3232
   n=321 and n=1281 included, CUDA cores at d 4 and 8, with its row
   log-sum-exp), K4 and K5 (each at n_fft 400 / hop 100 and 300 / 75), the
   conformers' add-and-LayerNorm kernel (``csrc/add_layer_norm.cu``: the
   batch cell's 8 s bucket, both conformers' shapes, and the single cell's
   6 s one, fp32 and bf16, y row-major and channels-major, with and without
   skip, the sum r bit for bit) and the conv module's GLU, depthwise k31,
   BatchNorm and swish kernel (``csrc/conv_module.cu``: the same shapes and
   the single cell's freq conformer, fp32 and bf16, u channels-major and as
   rows): each case against its plain PyTorch version on the card, with
   the tolerance stated beside it, launching the kernel once (by the one
   launch count, ``ops._native.launches``); then each kernel's rows (see
   Timing): K1 at 2 s and 8 s at batch 32 and at the training shape, beside
   the freq conformer's shape, K4 and K5 against their library calls in 5
   alternating rounds (K4 no slower), the add-and-norm kernel at the time
   conformer's shapes (host enqueue per call beside ``F.layer_norm``'s),
   the conv-module kernel at the 8 s batch bucket (fp32, bf16) and the 6 s
   batch-1 request (fp32);
4. the serving path itself: ``Enhancer(fused_stft=True)`` on a full-width
   ``TSCNet(64, 201, fused_attention=True)`` (seeded random weights)
   enhances 12 utterances of 1-4 s at batch 8, in bf16 and fp32 (at
   ``matmul_precision=None``, full fp32, and at the default
   ``"bfloat16"``, TF32 on the card); the outputs must be finite, in
   order, cut to length, and agree with the same weights run through the
   plain path; the launch count of every kernel of the path over that run
   must be > 0 (the CUDA-core K1 is on no main path: it takes head dims 4
   and 8 only);
5. kernel path against plain path for ``enhance_batch`` on [32, 32000] in
   bf16 (per call), and K1's device time in that batch from
   ``torch.profiler`` (the fp32 batch is the benchmark's
   ``cmgan-serve-batch`` cell, under ``sebench/``);
6. the training path's kernels, from the same table: K2 (the
   Shaw-attention backward, through the autograd route whose forward is
   K1; all three instances, B'=3232 n=321 included) and K6 (the axis swap,
   forward and backward: two launches) against their plain versions at
   training shapes, then their rows: K2's tensor-core instances at B'=808
   n=161 and B'=3232 n=321, its CUDA-core one at d=8, each against the
   autograd backward of K1's SDPA yardstick, and K6 at 1 s and 2 s;
7. the training path itself: ``make_fused_gan_train_step`` (generator
   step, host PESQ labels from the port's native engine, self-correcting
   discriminator step) on a full-width ``TSCNet(64, 201,
   fused_attention=True)`` and ``Discriminator(16)``, arch scp, MSE,
   SGD-Nesterov lr 0.01 (discriminator 0.02), batches of 8 x 1 s
   tone-plus-noise; fp32 and bf16 steps, finite losses, a falling
   generator loss on one repeated batch, the tensor-core instances of K1
   and K2 (bf16 and fp32 each) launched; per step each loss term, the
   self-correcting weights and the Gram entries they come from, and both
   models' gradient norms; one step of the kernel path against the plain
   path (``fused_attention=False``), and one with ``fused_relayout=True``
   (K6 launched);
8. training timings (CUDA events, median after warm-up): generator step,
   host labels, discriminator step, whole step, kernel path against plain
   path, fp32 and bf16; the bf16 step's device time by kernel and its
   busy share (``torch.profiler``); peak device memory of a step with and
   without rematerialization;
9. the entry points a user runs, on a synthetic corpus in the VoiceBank
   layout (48 + 6 pairs of 1.5-4 s harmonic "speech" at 0-15 dB SNR, from
   the seed, in a temporary directory): ``cli.main_gan`` for one epoch of
   6 steps (batch 8 x 1 s, scp, ``--fused-attention``) in each step mode
   at bf16 and in two-phase and pipelined at fp32 (finite losses, one
   discriminator update per generator step with the GAN term, K1 and K2
   launched), each with its step time (CUDA events, median of steps 2-6)
   and, in the same run, the device time of steps 2-4 (``torch.profiler``)
   over their time on the host's clock, the busy share, beside the wait
   for estimate labels and ``os.cpu_count()``, and the same for the
   synchronous ``make_fused_gan_train_step`` with all labels in the step;
   the two-phase loop against ``make_fused_gan_train_step`` step for step
   at lr 1e-3, with the same labels, in float64 under deterministic
   algorithms (losses rtol 1e-4) and, reported, in fp32 with K1 and K2;
   ``--resume auto`` at lr 1e-3 from the epoch-1 checkpoint of a run of
   two epochs, against that run's epoch 2, both under deterministic
   algorithms with the plain attention (the first epoch-2 loss bit for
   bit; epoch-2 losses 1e-3, all weights and their epoch-2 change 1e-3,
   and per entry of both models its weights 1e-3 and its epoch-2 change
   1e-2);
   ``cli.inference_gan`` on ``model_best`` in bf16 and fp32 and
   ``--validate-epochs`` (six finite metrics, K1, K4, K5 launched).  The
   CLI runs that are timed and inference run at torch's fp32 precision
   flags as the process started (what ``python -m`` gives a user), the
   two comparisons in full fp32;
10. the diffusion families at full width (``DiffuSE``: 64 channels, 30
   layers, GroupNorm, n_specs 201, hop 100, 50 steps, its zero-initialized
   output conv given seeded weights; ``DiffusionTSCNet(64, 201, 50)``), in
   full fp32: one train step of each at batch 8 x 1 s on the card against
   the same step on the CPU (the same weights and draws, dropout off; loss
   rtol 1e-4, all gradients relative RMS 1e-3, or 3x the card's fp32
   floor, its distance from the same step in float64, the larger), then
   5 bf16
   (``compute_dtype``) steps of each (finite losses) and 3 profiled ones
   (busy share); ``sample_tsc`` over the fast 6-step and the full 50-step
   schedules and ``sample_waveform`` over the fast one at batch 8 x 2 s,
   kernel route (K4, K5) against plain route (relative RMS 1e-4 for the
   fast schedules; for 50 steps 3x the card's own spread, two plain runs
   and one with noise of K4's and K5's measured size on every STFT and
   iSTFT output, at least 1e-4), with K4's and
   K5's launches per call checked (1 + steps and steps); each sampler's
   reverse step (CUDA events) and K4's and K5's device time inside
   ``sample_tsc``'s steps (``torch.profiler``); ``cli.main_diffuse`` for
   one epoch of each arch and ``cli.inference_diffuse --fast
   --validate-epochs`` on its checkpoints, on a corpus as phase 9's (six
   finite metrics); ``cli.convert_checkpoint`` on reference-layout
   DiffuSE, diffusion-TSCNet and GAN files of the phase's weights (the
   converted model's outputs equal the source's bit for bit);
11. standalone CDiffuSE at full width (the JAX CLI's ``PARAMS``: ``DiffuSE``
   64 channels, 30 layers, cycle 10, no GroupNorm, n_specs 201, hop 100;
   Adam 2e-4; batch 16 x 1 s; 50 linear steps), on a corpus as phase 9's
   (32 + 6 pairs): ``cli.preprocess`` (one float32 ``[201, frames]``
   finite spectrogram per wav, the first within 1e-6 of ``make_spectrum``);
   ``cli.cdiffuse`` for 6 steps, and for 3 then resumed to 6 in another
   directory (``summary.jsonl`` and ``weights/`` written, the resumed run
   starting at step 3, steps 3-5 taking the straight run's batches and
   seeds, checksummed through a hook on the learner's step; every loss and
   grad norm finite), with the step time (CUDA events, median of steps
   2-5), the busy share (``utils.profiling.trace``, resumed steps 4-5) and
   the peak allocated bytes (``utils.profiling.device_memory_stats``); one
   learner step on the card against the CPU (the same seeded weights,
   batch and draws: loss rtol 1e-5, grad_norm rtol 1e-4, gradients 1e-3;
   over a bound, against the CPU's float64 step: the loss within 1e-5 of
   it, the grad norm and the gradients at most 3x the CPU fp32 step's
   distance from it); ``cli.cdiffuse_inference --conditioner auto`` (K4, one
   launch an utterance) on the learner's checkpoint, fast and 50 steps
   (finite, in [-1, 1], cut to the sampled length), and ``predict``'s
   kernel route against ``plain`` on the same draws (relative RMS 1e-4);
   a reverse step at batch 1 x 4 s (CUDA events), its device time
   (``utils.profiling.trace``) and K4's share of it (K4 by CUDA events); ``cli.convert_checkpoint`` on two
   reference-layout ``weights.pt`` files of seeded weights (hop 100 / 201
   bins; hop 256 / 80 bins with ``params``: cycle 8, a 6-step schedule;
   the converted model's outputs equal the source's bit for bit) and
   ``cli.cdiffuse_inference --fast`` on each with ``auto``, ``se`` and
   ``mel``;
12. (a) int8 serving convolutions on ``TSCNet(64, 201,
   fused_attention=True, quantized_convs=True)`` with the float model's
   seeded weights: each of the 15 int8 convs at its shape in
   ``enhance_batch([32, 32000])`` (fp32, IEEE), its card route
   (``torch._int_mm``) against the plain one (the int8 values multiplied
   as fp32) on the conv's own input: int32 accumulators and outputs
   equal; one bf16 and one fp32 int8 batch (K1, K4, K5 and the int8 GEMMs
   launched, counted from zero), each batch's distance from the float
   model (reported) and its time against the float batch's (CUDA events,
   median of 10 in turns); the card's int8 model against the CPU's on
   ``[2, 32000]`` at IEEE (relative RMS, bound :data:`INT8_CARD_CPU_BOUND`);
   the 15 convs alone on seeded inputs of their shapes, int8 route
   against cuDNN's conv (``torch.profiler``, bf16 and fp32 inputs).
   (b) data parallelism on the one card (scp, dropout 0, fp32 at IEEE,
   fused attention: K1 and K2 fp32; global batch 8 x 1 s, fixed labels):
   one process in an NCCL group of world 1 bitwise equal to no group;
   two ranks started with ``spawn`` sharing the card over gloo against one
   process at the global batch (the generator and discriminator steps,
   ``diffuse_step`` on DiffuSE 64 x 30 and ``tsc_diffusion_step``:
   losses, self-correcting weights, gradients, updated parameters and
   BatchNorm statistics within a relative 1e-4; the ranks' states bitwise
   equal), and each rank's step time beside one process's (two ranks on
   one card: no data-parallel speed-up); ``cli.main_gan`` (pipelined,
   ``--fused-attention``, bf16) and ``cli.main_diffuse -a tsc-diffuse``
   with ``--num-processes 2`` for one epoch on a corpus as phase 9's
   (the ranks' replica digests equal, one checkpoint, written by rank 0);
   ``Enhancer(devices=["cuda:0", "cuda:0"], fused_stft=True)`` on 5
   ragged utterances against one device (atol 2e-5) and
   ``cli.inference_gan --n-devices 1`` and ``2`` on the checkpoint; the
   scp steps at the small width of tests/test_torch_disc_step_f64.py in
   fp32 on the card (IEEE) and on the CPU against the CPU's float64 step,
   the card held to 3x the closer of the CPU's figure and JAX's
   (:data:`JAX_SMALL_FP32_FLOOR`);
13. the quality scripts of ``speech_enhancement_tpu_torch/scripts``, cut
   in length, at torch's flags as the process started, each with every
   launch counter zeroed before it: (a) ``check_precision_quality`` at
   full width on 8 x 2 s, the IEEE fp32 reference and the five fast
   modes (``bf16`` and ``bf16_fused`` gated at PESQ 4.5, the others
   printed against the gate); (b) ``train_quality_proxy`` on the rich
   corpus of :data:`QUALITY_CORPUS` (its SHA-256 equal to the JAX
   script's), one epoch of scp in bf16 with the fused attention kernels
   in the async mode, and its sweep; (c) ``train_diffusion_proxy``,
   tsc-diffuse for one epoch of 2 steps and a 6-step sweep on 4 pairs;
   (d) ``train_cdiffuse_proxy`` for 20 steps and a 6-step sweep on 4
   pairs: each writes its report and a record of finite metrics, and
   launches the kernels of its path (K1, K2, K4, K5, the int8 GEMMs);
14. the long-run and runbook scripts, cut in length, at torch's flags as
   the process started, each with every launch counter zeroed before it
   and its children's launches read from their counters at exit
   (:class:`CountedChildren`): (a) ``make_pesq_validation_set``'s
   conformance sweep on this host's build of the PESQ engine against the
   committed ``tests/fixtures/pesq_engine_conformance.json`` (each MOS
   within 1e-4, no monotone violation, level and delay deltas within 0.02
   and 0.05); (b) ``run_full_recipe_proxy`` with :data:`DRILL_FLAGS` (bf16,
   fused attention): a real SIGKILL of the trainer after checkpoint 1, the
   resume at epoch 2, 8 loadable checkpoints and finite swept rows, and
   the noisy row of the script's default corpus, written and scored here,
   equal to ``docs/full_recipe_run.json``'s to three decimals; (c)
   ``label_bias_study``'s control and bias-0.3 arms for one epoch on 16 +
   8 pairs (records with finite rows, noisy rows bit-equal); (d)
   ``run_quality_parity`` on (b)'s corpus for one epoch, beside (c) (its
   report's scp row, best epoch 0); K1 and K2 bf16 launched in training, K1, K4 and K5
   in the sweeps.

Timing: a kernel's device time is CUDA events around N back-to-back calls
(N >= 20, and enough calls for >= 2 ms), queued behind a spin kernel so
that the host's per-call cost leaves no gap between them, divided by N;
its per-call time is CUDA events around one call, host included (median).
A row says whether its working set fits the 50 MB L2 (then the repeated
calls find their inputs there).  Bounds are the larger of the operations
over the card's peak rate for their type and the bytes (each input read
once, each output written once) over its bandwidth, the peaks of the
benchmark's table (``sebench.reference.flops.peaks``); a 3xTF32 kernel's
fp32 products count three TF32 products each.  ``library_ms`` is one
PyTorch call computing the same function, timed here and used nowhere in
the port.

The line before the last is the kernels' JSON record, one entry for each
kernel of :data:`KERNELS` (``launches``: the main paths' counts, read
from the one launch count: phases 4 and 7, each zeroed before its path,
phase 9's CLI calls, each counted from before to after it, phase 10's
kernel-route sampler runs and ``inference_diffuse`` calls (K4 and K5), phase 11's
``cdiffuse_inference`` calls with the |STFT| conditioner, phase 12's int8
batches, each zeroed before, and its two ranks' steps (each rank counts
from zero in its own process) and two-replica ``Enhancer``, phase 13's
four scripts, each zeroed before, and phase 14's three scripts and their
children; with ``launches_by_path``), after phase 9's, 10's and 11's
timings, phase 12's ``int8_timings`` and ``parallel_timings``, phase 13's
``quality_timings`` and phase 14's ``long_run_timings`` as JSON; the last is
``{"ok": true, "device": {...}}``.  Any failed check exits 1 without that
last line; with no CUDA device it exits 1 at once.

fp32 comparisons run with TF32 off for matmuls and cuDNN convolutions
(torch's ``fp32_precision`` flags, ``"ieee"``), so that the plain path is
full fp32; phase 9's timed runs restore the flags a process starts with.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from collections.abc import Callable, Iterable
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from speech_enhancement_tpu_torch.ops import _native

SEED = 0
SR = 16000
FAILURES: list[str] = []


def full_fp32() -> None:
    """fp32 matmuls and cuDNN convolutions in full fp32 (no TF32), by
    torch's ``fp32_precision`` flags only: torch refuses to read its
    precision once the legacy ``allow_tf32`` flags and these are mixed."""
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"


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


@functools.cache
def card_peaks() -> dict:
    """This card's peak rates, from the benchmark's table
    (``sebench.reference.flops.peaks``)."""
    from sebench.reference.flops import peaks

    kind = torch.cuda.get_device_name(0)
    table = peaks(kind)
    if table is None:
        raise RuntimeError(f"sebench/reference/flops.py has no peak rates for {kind}")
    return table


def bound(flops: float, nbytes: float, peak: str) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes"): the
    operations at the card's ``peak`` rate, ``"bf16"`` or ``"fp32"``
    (CUDA cores), or ``"3xtf32"`` (three TF32 products on tensor cores per
    fp32 product), and the bytes at its bandwidth."""
    table = card_peaks()
    rate = table["tf32"] / 3 if peak == "3xtf32" else table[peak]
    t_ops, t_bytes = flops / rate * 1e3, nbytes / table["bytes"] * 1e3
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
        lib: float | None, card: str, extra: str = "", *, shape: str,
        dtype: torch.dtype) -> dict:
    """Print one kernel row; returns its numbers for the kernels line, with
    the shape and dtype they were measured at."""
    warm = ("L2-warm" if nbytes < L2_BYTES else "L2-cold") + f" ({nbytes / 1e6:.2f} MB moved)"
    lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
    print(f"    {name}: device {dev:.4f} ms, per call {call:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bnd[0]:.4f} ms ({bnd[1]}; {100 * bnd[0] / dev:.1f}% of bound), "
          f"library {lib_s}; {warm}{extra} ({card})", flush=True)
    return {"ms": dev, "device_ms": dev, "call_ms": call, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
            "l2_warm": nbytes < L2_BYTES, "shape": shape, "dtype": DTYPE_NAMES[dtype]}


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


def attention_reference(q, k, v, table, max_pos, chunk=404):
    """``shaw_attention_reference`` and the row log-sum-exp of its scaled
    fp32 logits (what K2 reads), over batch chunks: the logits of B'=3232
    n=321 take 5.3 GB a tensor."""
    from speech_enhancement_tpu_torch.ops import fused_attention as fa

    d = q.shape[-1]
    rel = table[fa.relative_index(q.shape[1], max_pos, q.device)].float()
    outs, lses = [], []
    for i in range(0, q.shape[0], chunk):
        qc, kc, vc = (t[i:i + chunk] for t in (q, k, v))
        outs.append(fa.shaw_attention_reference(qc, kc, vc, table, max_pos))
        logits = (torch.einsum("bihd,bjhd->bhij", qc.float(), kc.float())
                  + torch.einsum("bihd,ijd->bhij", qc.float(), rel)) * d ** -0.5
        lses.append(torch.logsumexp(logits, -1))
        del logits
    return torch.cat(outs), torch.cat(lses)


def ptxas_report(log: str) -> dict[str, list[str]]:
    """ptxas -v's register and spill lines, by the mangled kernel name."""
    report, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("registers" in line or "spill" in line):
            report.setdefault(kernel, []).append(line.strip())
    return report


def in_turns(kernel_fn, library_fn, rounds: int = 5):
    """Device ms of a kernel and its library call, measured in alternating
    rounds (kernel, library, library, kernel, ...): (kernel medians,
    library medians, per-round ratios library / kernel)."""
    kernel, lib = [], []
    for r in range(rounds):
        for which in ((0, 1) if r % 2 == 0 else (1, 0)):
            if which == 0:
                kernel.append(device_ms(kernel_fn))
            else:
                lib.append(device_ms(library_fn))
    return kernel, lib, [b / a for a, b in zip(kernel, lib)]


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
    """Wrap ``opt.step`` so that it first copies the gradient of every
    parameter of ``module``."""
    named = list(module.named_parameters())
    grads: dict = {}
    step = opt.step

    def step_reading_grads():
        grads.update((n, p.grad.clone()) for n, p in named)
        step()

    opt.step = step_reading_grads
    return grads


@contextlib.contextmanager
def sc_weight_trace():
    """Every self-correcting weight computation of the discriminator steps
    inside (``train.gan._sc_weights_from_gram``, wrapped) appends its 3x3
    Gram matrix and its weights ``[w_c, w_e, w_n]`` (device tensors) to the
    list this yields."""
    from speech_enhancement_tpu_torch.train import gan

    seen: list = []
    original = gan._sc_weights_from_gram

    def traced(gram):
        w = original(gram)
        seen.append((gram.detach().clone(), w.detach().clone()))
        return w

    gan._sc_weights_from_gram = traced
    try:
        yield seen
    finally:
        gan._sc_weights_from_gram = original


def sc_step_text(metrics: dict, gram, w, disc_grad_norm) -> str:
    """One training step's losses, self-correcting weights, the Gram entries
    they come from (c = the (clean, clean) term's gradient, e = (clean,
    est), n = (clean, noisy)) and the discriminator's gradient norm."""
    m = {k: float(v) for k, v in metrics.items()}
    gram = gram.double().cpu().tolist()
    return (f"loss {m['loss']:.6g} (ri {m['loss_ri']:.5g}, mag {m['loss_mag']:.5g}, time "
            f"{m['time_loss']:.5g}, gan {m['gan_loss']:.5g}), disc_loss {m['disc_loss']:.5g}; "
            f"w_c, w_e, w_n {', '.join(f'{float(x):.5g}' for x in w)}; Gram c.c "
            f"{gram[0][0]:.4g}, e.e {gram[1][1]:.4g}, n.n {gram[2][2]:.4g}, c.e "
            f"{gram[0][1]:.4g}, c.n {gram[0][2]:.4g}, e.n {gram[1][2]:.4g}; discriminator "
            f"|grad| {float(disc_grad_norm):.4g}")


# --------------------------------------------------------------------------
# phases 3 and 6: every hand-written kernel against its plain version, then
# timed, from one table (KERNELS)

DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}
BOTH = (torch.float32, torch.bfloat16)


class Case(NamedTuple):
    """One check: ``run()`` calls the kernel and its plain twin on operands
    from the seed and returns ``(error, within tolerance, text)``; the
    kernel launches ``launches`` times in it, by the one count."""

    what: str
    dtype: torch.dtype
    run: Callable[[], tuple[float, bool, str]]
    launches: int = 1


class Timed(NamedTuple):
    """One row of the kernels line: the kernel call, its plain twin and the
    library yardstick (one PyTorch call computing the same function, named
    by ``library_is``), the bound's operations, bytes and peak kind
    (:func:`bound`), and ``more(dev, lib)``, the row's own text and keys.
    ``key`` nests the row under the kernel's first; ``in_turns`` times the
    kernel and the library in alternating rounds (their medians make the
    row); ``warmup`` and ``reps`` are :func:`time_pair`'s."""

    label: str
    shape: str
    dtype: torch.dtype
    kernel: Callable
    plain: Callable
    library: Callable
    library_is: str
    flops: float
    nbytes: float
    peak: str
    key: str | None = None
    more: Callable[[float, float | None], tuple[str, dict]] | None = None
    in_turns: bool = False
    warmup: int = 2
    reps: int = 10


class Kernel(NamedTuple):
    """One kernel of the kernels line: its name (its key in the one launch
    count), source under ``csrc/``, what it replaces, the phase that checks
    and times it, its cases and rows (functions of the seeded generator),
    and the main paths whose launches it reports (``by_path``: each path
    apart, else their sum), with ``check_launches_from`` where no main
    path reaches it."""

    name: str
    source: str
    replaces: str
    phase: int
    cases: Callable[[torch.Generator], Iterable[Case]]
    rows: Callable[[torch.Generator], Iterable[Timed]]
    paths: tuple
    by_path: bool = True
    err_key: str = "max_abs_err"
    err_by_dtype: bool = False
    check_launches_from: str | None = None


def kernel_phase(phase: int, card: str) -> dict:
    """Phase ``phase``'s kernels of :data:`KERNELS`, each in turn: every
    case against its plain twin (within its tolerance, launching the
    kernel as often as the case says), then every row.  Each kernel draws
    its operands from its own generator seeded with :data:`SEED`, so that
    adding, removing or moving a kernel leaves the others' operands as
    they are.  Returns, by kernel name, the largest error (by dtype for
    ``err_by_dtype``), the row with its nested rows, and the launches of
    the checks."""
    out = {}
    for k in KERNELS:
        if k.phase != phase:
            continue
        print(f"[{phase} kernels] {k.name} ({k.source}) against its plain version, then "
              f"timed; card {card}", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        errs, launched = {}, 0
        for case in k.cases(gen):
            before = _native.launches[k.name]
            err, ok, text = case.run()
            torch.cuda.synchronize()
            n = _native.launches[k.name] - before
            launched += n
            name = DTYPE_NAMES[case.dtype]
            errs[name] = max(errs.get(name, 0.0), err)
            check(ok and n == case.launches,
                  f"{case.what}: {text}; {n} launches ({case.launches} expected)")
            torch.cuda.empty_cache()
        result: dict = {}
        for spec in k.rows(gen):
            r = measure(spec, card)
            if spec.key is None:
                result.update(r)
            else:
                result[spec.key] = r
            del spec
            torch.cuda.empty_cache()
        out[k.name] = {"err": errs if k.err_by_dtype else max(errs.values()), "row": result,
                       "check_launches": launched}
    return out


def measure(spec: Timed, card: str) -> dict:
    """Time one row (see the module's docstring), print it and return its
    numbers with the row's own keys."""
    call, plain = time_pair(spec.kernel, spec.plain, spec.warmup, spec.reps)
    extra, keys = f"; library: {spec.library_is}", {}
    if spec.in_turns:
        kern, libs, ratios = in_turns(spec.kernel, spec.library)
        dev, lib = statistics.median(kern), statistics.median(libs)
        extra += (f"; in turns, 5 rounds: kernel {', '.join(f'{m:.4f}' for m in kern)} ms, "
                  f"library {', '.join(f'{m:.4f}' for m in libs)} ms, library/kernel "
                  f"{', '.join(f'{r:.2f}' for r in ratios)}: the kernel "
                  f"{'wins' if dev < lib else 'loses'}")
        keys["in_turns"] = {"kernel_ms": kern, "library_ms": libs}
    else:
        dev, lib = device_ms(spec.kernel), library(spec.library)
    if spec.more is not None:
        text, own = spec.more(dev, lib)
        extra += text
        keys.update(own)
    r = row(spec.label, dev, call, plain, bound(spec.flops, spec.nbytes, spec.peak),
            spec.nbytes, lib, card, extra, shape=spec.shape, dtype=spec.dtype)
    r.update(keys)
    return r


def host_us(fn, calls: int = 200) -> float:
    """The host's microseconds to enqueue one call of ``fn``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return spent


def ms_text(ms: float | None) -> str:
    return "n/a" if ms is None else f"{ms:.4f} ms"


# K1 and K2: fp32 differs in summation order only (rtol 1e-4, atol 1e-5,
# as tests/test_pallas_attention.py); bf16 may flip a rounding of P or of
# the output, one bf16 step of order-1 values
ATTENTION_TOLS = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
# K1's cases (B', n, max_pos_emb, head dim, dtypes): main-path shapes (2 s
# at batch 32 is B' = 3232 n = 321, whole; 8 s a slice of B' = 3232 n =
# 1281, clipping on), then short, full-tile and clipped edge cases
# (max_pos_emb 8) and the other head dims; d 16 and 32 take the
# tensor-core instances (bf16, and fp32 in 3xTF32), d 4 and 8 the CUDA-core
# one (B' = 3232 n = 321 d = 8 fp32: its timed shape)
K1_CASES = ((3232, 321, 512, 16, BOTH), (3232, 321, 512, 32, (torch.float32,)),
            (8, 1281, 512, 16, BOTH), (5, 7, 512, 16, BOTH), (3, 100, 8, 16, BOTH),
            (2, 64, 512, 16, BOTH), (8, 1281, 8, 16, BOTH), (6, 321, 512, 32, BOTH),
            (4, 1281, 512, 32, BOTH), (5, 7, 512, 32, BOTH), (3, 100, 8, 32, BOTH),
            (6, 70, 512, 4, BOTH), (6, 70, 512, 8, BOTH), (3232, 321, 512, 8, (torch.float32,)))
# K2's: B' = 808 n = 161, the time conformer of batch 8 x 1 s; B' = 3232
# n = 321, 2 s at batch 32; n = 1281, the length at which the JAX package
# took K3; max_pos_emb 8: clipped table rows; then the other head dims K2
# is built for, d = 32 at n = 161 and at n = 1281 unclipped (the
# tensor-core pass A's largest band) included
K2_CASES = ((808, 161, 512, 16, BOTH), (3232, 321, 512, 16, BOTH), (8, 1281, 512, 16, BOTH),
            (3, 100, 8, 16, BOTH), (8, 1281, 8, 16, BOTH), (8, 1281, 8, 32, BOTH),
            (6, 70, 512, 4, BOTH), (6, 70, 512, 8, BOTH), (6, 70, 512, 32, BOTH),
            (3, 100, 8, 32, BOTH), (6, 321, 512, 32, BOTH), (808, 161, 512, 32, BOTH),
            (8, 1281, 512, 32, BOTH))


def attention_cases(check_fn, shapes, direction: str, instance: str, gen):
    """The cases of ``shapes`` that take ``instance`` of K1 or K2."""
    from speech_enhancement_tpu_torch.ops.fused_attention import kernel_instance

    kernel = {"forward": "K1", "backward": "K2"}[direction]
    for b, n, max_pos, d, dtypes in shapes:
        for dtype in dtypes:
            if kernel_instance(dtype, d, direction) == instance:
                yield Case(f"{kernel} ({instance}) B'={b} n={n} h=4 d={d} max_pos_emb={max_pos} "
                           f"{dtype}", dtype, partial(check_fn, gen, b, n, max_pos, d,
                                                                 dtype))


def k1_check(gen, b, n, max_pos, d, dtype):
    """K1 and its row log-sum-exp (what K2 reads: fp32 sums of the same
    logits in another order, atol 1e-4 on values of order 10) against the
    plain versions."""
    from speech_enhancement_tpu_torch.ops import fused_attention as fa

    q, k, v, table = attention_operands(b, n, dtype, gen, d=d, max_pos=max_pos)
    got, lse = fa.fused_shaw_attention_fwd(q, k, v, table, max_pos, d ** -0.5, with_lse=True)
    want, lse_want = attention_reference(q, k, v, table, max_pos)
    lse_err = float((lse - lse_want).abs().max())
    rtol, atol = ATTENTION_TOLS[dtype]
    err, ok = within(got, want, rtol, atol)
    return (err, ok and lse_err < 1e-4 and got.dtype == dtype and got.shape == want.shape,
            f"max abs err {err:.3e} (rtol {rtol}, atol {atol}); lse max abs err "
            f"{lse_err:.2e} (atol 1e-4)")


def bwd_reference(q, k, v, table, g, max_pos, chunk=404):
    """shaw_attention_bwd_reference over batch chunks (its fp32 logits of
    B'=3232 n=321 would take 5 GB a tensor); the table in fp32 (its values
    are the table's), so that the chunks' dtable sum in fp32."""
    from speech_enhancement_tpu_torch.ops import fused_attention as fa

    parts = [fa.shaw_attention_bwd_reference(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk],
                                             table.float(), g[i:i + chunk], max_pos)
             for i in range(0, q.shape[0], chunk)]
    return (*(torch.cat([p[j] for p in parts]) for j in range(3)),
            sum(p[3] for p in parts).to(table.dtype))


def k2_check(gen, b, n, max_pos, d, dtype):
    """K2 through the autograd route whose forward is K1, against the plain
    backward: fp32 dq, dk, dv within rtol 1e-4 + atol 1e-5 (summation
    order), dtable relative RMS < 1e-5 (fp32 atomics); bf16 relative RMS <
    1e-2 for each (roundings of P and dS*scale may flip)."""
    from speech_enhancement_tpu_torch.ops import fused_attention as fa

    q, k, v, table = attention_operands(b, n, dtype, gen, d=d, max_pos=max_pos)
    g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, table)]
    got = torch.autograd.grad(fa.fused_shaw_attention(*leaves, max_pos), leaves, g)
    del leaves
    want = bwd_reference(q, k, v, table, g, max_pos)
    report, worst = [], 0.0
    ok = all(a.dtype == dtype and a.shape == w.shape for a, w in zip(got, want))
    for name, a, w in zip(("dq", "dk", "dv", "dtable"), got, want):
        err, rr = float((a.float() - w.float()).abs().max()), rel_rms_t(a, w)
        worst = max(worst, err)
        if dtype == torch.bfloat16:
            ok = ok and rr < 1e-2
        elif name == "dtable":
            ok = ok and rr < 1e-5
        else:
            ok = ok and within(a, w, 1e-4, 1e-5)[1]
        report.append(f"{name} {err:.2e}/{rr:.1e}")
    return worst, ok, f"max abs err/relative RMS {', '.join(report)}"


def shaw_bias(q, table, max_pos=512):
    """The Shaw bias ``[B', h, n, n]`` of q ``[B', n, h, d]``, scaled, by
    the plain gather and einsum: SDPA's mask in K1's yardstick."""
    from speech_enhancement_tpu_torch.ops.fused_attention import relative_index

    idx = relative_index(q.shape[1], max_pos, q.device)
    return torch.einsum("bhid,ijd->bhij", q.transpose(1, 2), table[idx]) * q.shape[-1] ** -0.5


def sdpa(q, k, v, bias):
    """``scaled_dot_product_attention`` with ``bias`` as its mask, q, k, v
    as ``[B', h, n, d]`` views."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                                          attn_mask=bias)


def other_bound(flops, nbytes, peak):
    """``more`` of an fp32 attention row: the bound of the other fp32 route
    beside the row's (67 TFLOP/s on CUDA cores, or 3xTF32 on tensor
    cores)."""
    other = "fp32" if peak == "3xtf32" else "3xtf32"
    name, key = {"fp32": ("67 TFLOP/s fp32", "bound_fp32_cuda_core_ms"),
                 "3xtf32": ("3xTF32", "bound_3xtf32_ms")}[other]

    def more(dev, lib):
        ms, by = bound(flops, nbytes, other)
        return f"; {name} bound {ms:.4f} ms ({by}; {100 * ms / dev:.1f}%)", {key: ms}
    return more


def lazy(build):
    """A call of the function ``build()`` returns, built at the first call:
    a yardstick's operands, not held while the plain version is timed."""
    made = []

    def call():
        if not made:
            made.append(build())
        return made[0]()
    return call


def k1_row(gen, b, n, d, dtype, peak, label, key=None, beside="chain", chain_key=None):
    """A K1 row: three n x n x d contractions per (sequence, head); q, k,
    v, out; the library SDPA with the bias built beforehand.  Beside the
    row: SDPA with the bias built in each call (``chain_key``: also as
    that key), or (``beside="other"``) the other fp32 route's bound."""
    from speech_enhancement_tpu_torch.ops import fused_attention as fa

    q, k, v, table = attention_operands(b, n, dtype, gen, d=d)
    flops, nbytes = 6.0 * b * 4 * n * n * d, 4 * q.numel() * q.element_size()
    if beside == "other":
        more = other_bound(flops, nbytes, peak)
    else:
        def more(dev, lib):
            chain = library(lambda: sdpa(q, k, v, shaw_bias(q, table)))
            return (f"; SDPA with the bias built in each call {ms_text(chain)}",
                    {} if chain_key is None else {chain_key: chain})
    return Timed(label, f"B'={b} n={n} h=4 d={d}", dtype,
                 lambda: fa.fused_shaw_attention(q, k, v, table),
                 lambda: fa.shaw_attention_reference(q, k, v, table),
                 lazy(lambda: partial(sdpa, q, k, v, shaw_bias(q, table))),
                 "SDPA with the Shaw bias as its mask, built beforehand", flops, nbytes, peak,
                 key, more)


def k1_rows(instance, gen):
    """K1's rows: the tensor-core instance at 2 s and 8 s at batch 32 and at
    the training shape, the fp32 one at 2 s and the training shape, the
    CUDA-core one at d = 8, the head dim it keeps."""
    from speech_enhancement_tpu_torch.ops import fused_attention as fa

    if instance == "tensor_core":
        yield k1_row(gen, 3232, 321, 16, torch.bfloat16, "bf16",
                     "K1 tensor-core B'=3232 n=321 bf16 (2 s at batch 32)",
                     chain_key="library_chain_ms")
        # SDPA's bias would take 26 GB whole: its yardstick is 8 calls on a
        # chunk of B' = 404 (a 5.3 GB bias, built beforehand)
        q, k, v, table = attention_operands(3232, 1281, torch.bfloat16, gen)

        def eight_chunks():
            chunk = [t[:404] for t in (q, k, v)]
            bias = shaw_bias(chunk[0], table)
            return lambda: [sdpa(*chunk, bias) for _ in range(8)]
        yield Timed("K1 tensor-core B'=3232 n=1281 bf16 (8 s at batch 32)",
                    "B'=3232 n=1281 h=4 d=16", torch.bfloat16,
                    lambda: fa.fused_shaw_attention(q, k, v, table),
                    lambda: chunked(fa.shaw_attention_reference, 202, q, k, v, table),
                    lazy(eight_chunks),
                    "SDPA with the bias, 8 chunks of B'=404 (one chunk's, 8 times); plain "
                    "in 16 chunks of 202", 6.0 * 3232 * 4 * 1281 * 1281 * 16, 4 * q.numel() * 2,
                    "bf16", key="n1281", warmup=1, reps=2)
        del q, k, v, table
        q, k, v, table = attention_operands(10272, 101, torch.bfloat16, gen)
        eager = device_ms(lambda: torch.softmax(
            (torch.einsum("bihd,bjhd->bhij", q, k) + torch.einsum(
                "bihd,ijd->bhij", q, table[fa.relative_index(101, 512, q.device)])) * 0.25,
            dim=-1) @ v.transpose(1, 2))
        print(f"    info K1 tensor-core at the freq conformer's B'=10272 n=101 bf16 (not "
              f"routed through K1): device "
              f"{device_ms(lambda: fa.fused_shaw_attention(q, k, v, table)):.4f} ms; the eager "
              f"bf16 attention there {eager:.4f} ms", flush=True)
        del q, k, v, table
        yield k1_row(gen, 808, 161, 16, torch.bfloat16, "bf16",
                     "K1 tensor-core B'=808 n=161 bf16 (the training shape)", key="n161")
    elif instance == "tensor_core_tf32":
        yield k1_row(gen, 3232, 321, 16, torch.float32, "3xtf32",
                     "K1 fp32 tensor-core (3xTF32) B'=3232 n=321 d=16 fp32", beside="other")
        yield k1_row(gen, 808, 161, 16, torch.float32, "3xtf32",
                     "K1 fp32 tensor-core (3xTF32) B'=808 n=161 fp32 (the training shape)",
                     key="n161")
    else:
        yield k1_row(gen, 3232, 321, 8, torch.float32, "fp32", "K1 CUDA-core B'=3232 n=321 d=8 "
                     "fp32", beside="other")


def k2_rows(instance, gen):
    """K2's rows: the tensor-core instances at the training shape and at 2 s
    x batch 32, the CUDA-core one at d = 8, the head dim it keeps; the
    library the autograd backward of the bias build and SDPA (K1's
    yardstick).  Eight n x n x d contractions (s, the bias, dP, dV, dQ and
    its bias term, dK, dtable); q, k, v, out, g, lse in, dq, dk, dv out."""
    from speech_enhancement_tpu_torch.ops import fused_attention as fa

    dtype, d = {"tensor_core": (torch.bfloat16, 16), "tensor_core_tf32": (torch.float32, 16),
                "cuda_core": (torch.float32, 8)}[instance]
    peak = "3xtf32" if instance == "tensor_core_tf32" else DTYPE_NAMES[dtype]
    shapes = ((None, 808, 161),) if instance == "cuda_core" else ((None, 808, 161),
                                                                  ("n321", 3232, 321))
    for key, b, n in shapes:
        q, k, v, table = attention_operands(b, n, dtype, gen, d=d)
        g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        out, lse = fa.fused_shaw_attention_fwd(q, k, v, table, 512, d ** -0.5, with_lse=True)
        flops = 16.0 * b * 4 * n * n * d
        nbytes = (8 * q.numel() * q.element_size() + lse.numel() * 4
                  + table.numel() * q.element_size())

        def yardstick():
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, table)]
            y = sdpa(*leaves[:3], shaw_bias(leaves[0], leaves[3])).transpose(1, 2)
            return lambda: torch.autograd.grad(y, leaves, g, retain_graph=True)
        yield Timed(f"K2 {instance.replace('_', '-')} B'={b} n={n} d={d} {dtype}",
                    f"B'={b} n={n} h=4 d={d}", dtype,
                    lambda: fa.fused_shaw_attention_bwd(q, k, v, table, out, lse, g),
                    lambda: fa.shaw_attention_bwd_reference(q, k, v, table, g),
                    lazy(yardstick), "autograd backward of the bias build and SDPA", flops,
                    nbytes, peak, key,
                    other_bound(flops, nbytes, peak) if dtype == torch.float32 else None,
                    warmup=1, reps=6)
        del q, k, v, table, g, out, lse


# K4 and K5 at the serving path's geometry: what an FFT-based STFT needs,
# a real FFT of 400 samples per frame (2.5 N log2 N flops) plus the window
# and a few flops per bin for the compression; the bytes (20.6 MB: the
# [32, 32000] audio and its [32, 321, 201] complex spectrum) bound it, not
# these 0.12 GFLOP
STFT_FLOPS = 32 * 321 * (2.5 * 400 * math.log2(400) + 400 + 8 * 201)
STFT_BYTES = 32 * 32000 * 4 + 32 * 321 * 201 * 8


def k4_cases(gen):
    """K4: 3xTF32 sums (about fp32) in another order; compression amplifies
    the error of near-empty bins (rtol 1e-4, atol 2e-4, as
    tests/test_pallas_stft.py); the main path's geometry, then n_fft 300,
    hop 75 (K padded 151 -> 152, a ragged last frame tile)."""
    for shape, n_fft, hop in (((32, 32000), 400, 100), ((8, 24037), 300, 75)):
        yield Case(f"K4 stft+compress {list(shape)} n_fft {n_fft} hop {hop} fp32", torch.float32,
                   partial(k4_check, gen, shape, n_fft, hop))


def k4_check(gen, shape, n_fft, hop):
    from speech_enhancement_tpu_torch.ops import fused_stft as fs

    x = torch.randn(*shape, device="cuda", generator=gen)  # RMS 1, as normalized audio
    spec, spec_ref = fs.fused_stft(x, n_fft, hop), fs.stft_reference(x, n_fft, hop)
    err, ok = within(torch.view_as_real(spec), torch.view_as_real(spec_ref), 1e-4, 2e-4)
    return (err, ok and spec.shape == spec_ref.shape == (shape[0], 1 + shape[1] // hop,
                                                       n_fft // 2 + 1),
            f"max abs err {err:.3e} (rtol 1e-4, atol 2e-4)")


def k4_rows(gen):
    """K4 against ``torch.stft`` and the compression in turns; the kernel
    must be no slower (a check)."""
    from speech_enhancement_tpu_torch.ops import fused_stft as fs

    x = torch.randn(32, 32000, device="cuda", generator=gen)
    window = torch.hamming_window(400, device="cuda")

    def no_slower(dev, lib):
        check(dev <= lib, f"K4 device time {dev:.4f} ms no higher than torch.stft, then the "
                          f"compression {lib:.4f} ms (medians in turns)")
        return "", {}
    yield Timed("K4 stft+compress [32, 32000] fp32", "[32, 32000] n_fft=400 hop=100",
                torch.float32, lambda: fs.fused_stft(x), lambda: fs.stft_reference(x),
                lambda: fs._gated_rescale(torch.stft(x, 400, 100, window=window,
                                                     return_complex=True).transpose(1, 2), -0.35),
                "torch.stft, then the compression", STFT_FLOPS, STFT_BYTES, "fp32",
                more=no_slower, in_turns=True)


def k5_cases(gen):
    """K5: 3xTF32 sums (about fp32) of 201 products of order-1 values in
    another order (rtol 1e-4, atol 1e-4); the main path's geometry, then
    n_fft 300, hop 75 (K padded 151 -> 152, 151 of 208 n columns); 31963
    and 23911 cut inside a hop block."""
    for shape, n_fft, hop, lengths in (((32, 32000), 400, 100, (32000, 31963)),
                                       ((8, 24037), 300, 75, (24000, 23911))):
        for length in lengths:
            yield Case(f"K5 uncompress+istft {[shape[0], 1 + shape[1] // hop, n_fft // 2 + 1]} "
                       f"n_fft {n_fft} hop {hop} length {length} fp32", torch.float32,
                       partial(k5_check, gen, shape, n_fft, hop, length))


def k5_check(gen, shape, n_fft, hop, length):
    from speech_enhancement_tpu_torch.ops import fused_stft as fs

    spec = fs.stft_reference(torch.randn(*shape, device="cuda", generator=gen), n_fft, hop)
    wav = fs.fused_istft(spec, n_fft, hop, length=length)
    wav_ref = fs.istft_reference(spec, n_fft, hop, length=length)
    err, ok = within(wav, wav_ref, 1e-4, 1e-4)
    return (err, ok and wav.shape == wav_ref.shape == (shape[0], length),
            f"max abs err {err:.3e} (rtol 1e-4, atol 1e-4)")


def k5_rows(gen):
    from speech_enhancement_tpu_torch.ops import fused_stft as fs

    spec = fs.stft_reference(torch.randn(32, 32000, device="cuda", generator=gen))
    window = torch.hamming_window(400, device="cuda")
    yield Timed("K5 uncompress+istft [32, 321, 201] fp32", "[32, 321, 201] n_fft=400 hop=100",
                torch.float32, lambda: fs.fused_istft(spec, length=32000),
                lambda: fs.istft_reference(spec, length=32000),
                lambda: torch.istft(fs._gated_rescale(spec, (1.0 / 0.3 - 1.0) / 2.0).transpose(
                    1, 2), 400, 100, window=window, length=32000),
                "the uncompression, then torch.istft", STFT_FLOPS, STFT_BYTES, "fp32",
                in_turns=True)


# the conformers' add-and-norm at the serving cells' shapes ([rows, N, 64]):
# the batch cell's 8 s bucket, 32 x 101 sequences of 1281 frames in the
# time conformer and 32 x 1281 of 101 bins in the freq conformer, and the
# single cell's 6 s bucket, 101 sequences of 961 frames
NORM_SHAPES = {"8 s batch, time": (3232, 1281), "8 s batch, freq": (40992, 101),
               "6 s single, time": (101, 961)}
# fp32: the sum r is one rounding of x + s y either way (bit for bit); n
# differs in the statistics' summation order and rsqrt (values of order
# 1-5); bf16: a rounding of n may flip, and skip is added after it (two
# bf16 steps of order-1 values)
NORM_TOLS = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}


def norm_operands(gen, b, n, dtype):
    """A LayerNorm(64) with weights from ``gen`` and x ``[b, n, 64]``."""
    from torch import nn

    from speech_enhancement_tpu_torch.models.conformer import LN_EPS

    norm = nn.LayerNorm(64, eps=LN_EPS).to(device="cuda", dtype=dtype)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.5 * torch.randn(64, device="cuda", generator=gen))
        norm.bias.copy_(0.5 * torch.randn(64, device="cuda", generator=gen))
    return norm, torch.randn(b, n, 64, device="cuda", generator=gen).to(dtype)


def norm_y(gen, b, n, dtype, layout):
    """y row-major, channels-major (the conv residual) or None."""
    if layout == "rows":
        return torch.randn(b, n, 64, device="cuda", generator=gen).to(dtype)
    if layout == "cols":
        return torch.randn(b, 64, n, device="cuda", generator=gen).to(dtype).transpose(1, 2)
    return None


def norm_cases(gen):
    for label, (b, n) in NORM_SHAPES.items():
        for dtype in BOTH:
            for layout in ("rows", "cols", "none"):
                yield Case(f"add_layer_norm {label} [{b}, {n}, 64] {DTYPE_NAMES[dtype]}, y "
                           f"{layout}, scale 0.5 and 1, with and without skip", dtype,
                           partial(norm_check, gen, b, n, dtype, layout), launches=4)


def norm_check(gen, b, n, dtype, layout):
    """Four calls (scale 0.5 and 1, with and without skip) against the plain
    version; the sum r bit for bit."""
    from speech_enhancement_tpu_torch.ops import fused_norm as fnorm

    norm, x = norm_operands(gen, b, n, dtype)
    skip = torch.randn(b, n, 64, device="cuda", generator=gen).to(dtype)
    y = norm_y(gen, b, n, dtype, layout)
    rtol, atol = NORM_TOLS[dtype]
    worst, ok = 0.0, True
    for scale, sk in ((0.5, None), (1.0, None), (0.5, skip), (1.0, skip)):
        r, got = fnorm.add_layer_norm(x, y, scale, norm, sk)
        want_r, want = fnorm.add_layer_norm_reference(x, y, scale, norm, sk)
        err, good = within(got, want, rtol, atol)
        worst = max(worst, err)
        ok &= (good and got.dtype == dtype and got.is_contiguous() and torch.equal(r, want_r))
    return worst, ok, f"max abs err {worst:.3e} (rtol {rtol}, atol {atol}), r bit for bit"


def norm_rows(gen):
    """The time conformer's shapes in fp32 (what the cells serve): x + 0.5 y
    with r and n written (x, y read; r, n written); beside the row,
    ``F.layer_norm`` alone, y channels-major and the host's enqueue per
    call against ``F.layer_norm``'s."""
    import torch.nn.functional as F

    from speech_enhancement_tpu_torch.models.conformer import LN_EPS
    from speech_enhancement_tpu_torch.ops import fused_norm as fnorm

    for key, label in ((None, "8 s batch, time"), ("single", "6 s single, time")):
        b, n = NORM_SHAPES[label]
        norm, x = norm_operands(gen, b, n, torch.float32)
        y = norm_y(gen, b, n, torch.float32, "rows")
        yc = norm_y(gen, b, n, torch.float32, "cols")
        nbytes = 4 * x.numel() * 4

        def layer_norm():
            return F.layer_norm(x, (64,), norm.weight, norm.bias, LN_EPS)

        def more(dev, lib):
            alone = library(layer_norm)
            cols = device_ms(lambda: fnorm.add_layer_norm(x, yc, 1.0, norm))
            host = host_us(lambda: fnorm.add_layer_norm(x, y, 0.5, norm))
            host_ln = host_us(layer_norm)
            share = 100 * bound(0.0, nbytes, "fp32")[0] / cols
            return (f"; F.layer_norm alone {ms_text(alone)}; y channels-major (the conv "
                    f"residual) {cols:.4f} ms ({share:.1f}% of bound); host enqueue per call: "
                    f"wrapper {host:.1f} us, F.layer_norm {host_ln:.1f} us",
                    {"cols_device_ms": cols, "layer_norm_ms": alone, "host_us": host,
                     "layer_norm_host_us": host_ln})
        yield Timed(f"add_layer_norm {label} [{b}, {n}, 64] fp32, x + 0.5 y, r and n written",
                    f"[{b}, {n}, 64]", torch.float32,
                    lambda: fnorm.add_layer_norm(x, y, 0.5, norm),
                    lambda: fnorm.add_layer_norm_reference(x, y, 0.5, norm),
                    lambda: F.layer_norm(torch.add(x, y, alpha=0.5), (64,), norm.weight,
                                         norm.bias, LN_EPS),
                    "torch.add(alpha=0.5) and F.layer_norm", 0.0, nbytes, "fp32", key, more)
        del norm, x, y, yc


# the conv module's middle at the serving cells' shapes ([B', 256, N] in):
# the conformers' shapes of NORM_SHAPES and the single cell's 6 s freq one
CONV_SHAPES = {**NORM_SHAPES, "6 s single, freq": (961, 101)}
# relative RMS: fp32 differs in BatchNorm's arithmetic and the sum's order;
# bf16 in a rounding of an intermediate that may flip
CONV_TOLS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def conv_module(gen, dtype):
    """A ConvModule(64) in eval mode, weights and statistics from ``gen``."""
    from speech_enhancement_tpu_torch.models.conformer import ConvModule

    m = ConvModule(64).to("cuda").eval()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, device="cuda", generator=gen)
                    / math.sqrt(p[0].numel() if p.ndim > 1 else 4))
        norm = m.net[5]
        norm.weight.add_(1.0)
        norm.running_mean.copy_(0.5 * torch.randn(128, device="cuda", generator=gen))
        norm.running_var.copy_(torch.rand(128, device="cuda", generator=gen) * 1.5 + 0.5)
    return m.to(dtype)


def conv_u(gen, b, n, dtype, layout):
    """u ``[b, 256, n]`` channels-major, or as rows (a channels-last
    pointwise product)."""
    if layout == "cols":
        return torch.randn(b, 256, n, device="cuda", generator=gen).to(dtype)
    return torch.randn(b, n, 256, device="cuda", generator=gen).to(dtype).transpose(1, 2)


def conv_cases(gen):
    for label, (b, n) in CONV_SHAPES.items():
        for dtype in BOTH:
            for layout in ("cols", "rows"):
                yield Case(f"glu_conv_swish {label} [{b}, 256, {n}] {DTYPE_NAMES[dtype]}, u "
                           f"{layout}", dtype,
                           partial(conv_check, gen, b, n, dtype, layout))


@torch.no_grad()
def conv_check(gen, b, n, dtype, layout):
    from speech_enhancement_tpu_torch.ops import fused_conv_module as fcm

    m = conv_module(gen, dtype)
    conv, norm = m.net[4].conv, m.net[5]
    u = conv_u(gen, b, n, dtype, layout)
    got = fcm.glu_conv_swish(u, conv, norm)
    err = rel_rms_t(got, fcm.glu_conv_swish_reference(u, conv, norm))
    return (err, err <= CONV_TOLS[dtype] and got.dtype == dtype and got.is_contiguous()
            and got.shape == (b, 128, n), f"relative RMS {err:.3e} (tolerance {CONV_TOLS[dtype]})")


def conv_rows(gen):
    """The 8 s batch bucket's time conformer (fp32, bf16) and the 6 s batch-1
    request's (fp32), u in the layout the model's pointwise conv hands over
    (u read once, the output written once); beside it the other layout."""
    from speech_enhancement_tpu_torch.ops import fused_conv_module as fcm

    for key, label, dtype in ((None, "8 s batch, time", torch.float32),
                              ("single", "6 s single, time", torch.float32),
                              ("bf16", "8 s batch, time", torch.bfloat16)):
        b, n = CONV_SHAPES[label]
        m = conv_module(gen, dtype)
        net, conv, norm = m.net, m.net[4].conv, m.net[5]
        with torch.no_grad():  # the first pointwise conv's output, as the model makes it
            u = net[2](net[1](torch.randn(b, n, 64, device="cuda", generator=gen).to(dtype)))
        names = {fcm.COLS: "channels-major", fcm.ROWS: "rows"}
        layout = names.get(fcm.u_layout(u), "other")
        other = conv_u(gen, b, n, dtype, "cols" if fcm.u_layout(u) == fcm.ROWS else "rows")
        nbytes = u.numel() * u.element_size() * 3 / 2

        def more(dev, lib):
            dev_other = device_ms(torch.no_grad()(lambda: fcm.glu_conv_swish(other, conv, norm)))
            share = 100 * bound(0.0, nbytes, "fp32")[0] / dev_other
            return (f"; u {names[fcm.u_layout(other)]} {dev_other:.4f} ms ({share:.1f}% of "
                    f"bound)", {"u_layout": layout, "other_layout_device_ms": dev_other})
        yield Timed(f"glu_conv_swish {label} [{b}, 256, {n}] {DTYPE_NAMES[dtype]}, u {layout}",
                    f"[{b}, 256, {n}]", dtype,
                    torch.no_grad()(lambda: fcm.glu_conv_swish(u, conv, norm)),
                    torch.no_grad()(lambda: fcm.glu_conv_swish_reference(u, conv, norm)),
                    torch.no_grad()(lambda: net[6](net[5](net[4](net[3](u))))),
                    "the module's eager GLU, pad, depthwise conv, BatchNorm, swish", 0.0,
                    nbytes, "fp32", key, more)
        del m, net, conv, norm, u, other


# K6 at the time conformer's [B, F, T, C] of 1 s and 2 s
SWAP_SHAPES = ((8, 101, 161, 64), (32, 101, 321, 64))


def swap_cases(gen):
    for shape in SWAP_SHAPES:
        for dtype in BOTH:
            yield Case(f"K6 swap {list(shape)} {dtype} forward and backward", dtype,
                       partial(swap_check, gen, shape, dtype), launches=2)


def swap_check(gen, shape, dtype):
    """K6 forward and backward, exact."""
    from speech_enhancement_tpu_torch.ops import fused_relayout as fr

    x = torch.randn(shape, device="cuda", generator=gen).to(dtype).requires_grad_()
    y = fr.swap_seq_axes(x)
    gy = torch.randn(y.shape, device="cuda", generator=gen).to(dtype)
    (gx,) = torch.autograd.grad(y, x, gy)
    y = y.detach()
    want_y, want_gx = x.detach().transpose(1, 2).contiguous(), gy.transpose(1, 2)
    err = max(float((y - want_y).abs().max()), float((gx - want_gx).abs().max()))
    return (err, torch.equal(y, want_y) and torch.equal(gx, want_gx) and y.is_contiguous(),
            f"exact (max abs err {err})")


def swap_rows(gen):
    """bf16, x read and written once; beside the row the host's enqueue per
    call against ``transpose().contiguous()``'s."""
    from speech_enhancement_tpu_torch.ops import fused_relayout as fr

    for key, shape, aim in ((None, SWAP_SHAPES[0], "no slower than transpose().contiguous()"),
                            ("serving", SWAP_SHAPES[1], ">= 65% of the bound")):
        x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)

        def more(dev, lib, aim=aim):
            host = host_us(lambda: fr.swap_seq_axes(x))
            return (f"; host enqueue per call: wrapper {host:.1f} us, transpose().contiguous() "
                    f"{host_us(lambda: fr.swap_seq_axes_reference(x)):.1f} us; aim: {aim}",
                    {"host_us": host})
        yield Timed(f"K6 {list(shape)} bf16", f"[B, F, T, C]={list(shape)}", torch.bfloat16,
                    lambda: fr.swap_seq_axes(x), lambda: fr.swap_seq_axes_reference(x),
                    lambda: x.transpose(1, 2).contiguous(), "transpose().contiguous()", 0.0,
                    2 * x.numel() * 2, "bf16", key, more, reps=20)
        del x


# the main paths whose launches the kernels line reports (each path's
# phase counts its own)
SERVED = ("serving (phase 4)", "training (phase 7)", "entry points (phase 9)")
LATER = ("int8 serving (phase 12)", "data parallel (phase 12)", "quality scripts (phase 13)",
         "long-run scripts (phase 14)")
DIFFUSION = ("diffusion (phase 10)",)
NO_MAIN_PATH = ("serving (phase 4)", "training (phase 7)")
K1_SOURCE = "speech_enhancement_tpu/ops/pallas_attention.py:201"
K2_SOURCE = "speech_enhancement_tpu/ops/pallas_attention.py:533 and :616"

KERNELS = (
    Kernel("shaw_attention_fwd_tensor_core", "shaw_attention_mma.cu", K1_SOURCE, 3,
           partial(attention_cases, k1_check, K1_CASES, "forward", "tensor_core"),
           partial(k1_rows, "tensor_core"), SERVED + LATER),
    Kernel("shaw_attention_fwd_tf32", "shaw_attention_tf32.cu", K1_SOURCE, 3,
           partial(attention_cases, k1_check, K1_CASES, "forward", "tensor_core_tf32"),
           partial(k1_rows, "tensor_core_tf32"), SERVED + LATER),
    Kernel("shaw_attention_fwd_cuda_core", "shaw_attention.cu", K1_SOURCE, 3,
           partial(attention_cases, k1_check, K1_CASES, "forward", "cuda_core"),
           partial(k1_rows, "cuda_core"), NO_MAIN_PATH, by_path=False,
           check_launches_from="phase-3 checks at head dims 4 and 8: no main path reaches it"),
    Kernel("shaw_attention_bwd_tensor_core", "shaw_attention_bwd_mma.cu", K2_SOURCE, 6,
           partial(attention_cases, k2_check, K2_CASES, "backward", "tensor_core"),
           partial(k2_rows, "tensor_core"), SERVED + LATER),
    Kernel("shaw_attention_bwd_tf32", "shaw_attention_bwd_tf32.cu", K2_SOURCE, 6,
           partial(attention_cases, k2_check, K2_CASES, "backward", "tensor_core_tf32"),
           partial(k2_rows, "tensor_core_tf32"), SERVED + LATER),
    Kernel("shaw_attention_bwd_cuda_core", "shaw_attention_bwd.cu", K2_SOURCE, 6,
           partial(attention_cases, k2_check, K2_CASES, "backward", "cuda_core"),
           partial(k2_rows, "cuda_core"), NO_MAIN_PATH, by_path=False,
           check_launches_from="phase-6 checks at head dims 4 and 8: no main path reaches it"),
    Kernel("stft_compress", "stft.cu", "speech_enhancement_tpu/ops/pallas_stft.py:74", 3,
           k4_cases, k4_rows, SERVED + DIFFUSION + ("cdiffuse (phase 11)",) + LATER),
    Kernel("uncompress_istft", "stft.cu", "speech_enhancement_tpu/ops/pallas_stft.py:157", 3,
           k5_cases, k5_rows, SERVED + DIFFUSION + LATER),
    Kernel("add_layer_norm", "add_layer_norm.cu",
           "no TPU kernel: aten's LayerNorm and the adds around it", 3, norm_cases, norm_rows,
           SERVED + DIFFUSION + LATER, err_by_dtype=True),
    Kernel("glu_conv_swish", "conv_module.cu", "no TPU kernel: the conv module's eager GLU, "
           "pad, depthwise conv, BatchNorm and swish", 3, conv_cases, conv_rows,
           SERVED + DIFFUSION + LATER, err_key="max_rel_rms", err_by_dtype=True),
    Kernel("swap_seq_axes", "relayout.cu", "speech_enhancement_tpu/ops/pallas_relayout.py:48", 6,
           swap_cases, swap_rows, ("fused_relayout step (phase 7)",), by_path=False),
)


def kernels_line(checked: dict, paths: dict) -> list:
    """The kernels line: each kernel of :data:`KERNELS` with its launches on
    the main paths (``paths``: each path's counts by kernel name), its
    largest error and its rows (``checked``: :func:`kernel_phase`'s)."""
    out = []
    for k in KERNELS:
        got = checked[k.name]
        entry = {"name": k.name, "route": "cuda",
                 "source": f"speech_enhancement_tpu_torch/csrc/{k.source}",
                 "replaces": k.replaces, "launches": sum(paths[p][k.name] for p in k.paths)}
        if k.by_path:
            entry["launches_by_path"] = {p: paths[p][k.name] for p in k.paths}
        if k.check_launches_from:
            entry.update(check_launches=got["check_launches"],
                         check_launches_from=k.check_launches_from)
        out.append({**entry, k.err_key: got["err"], **got["row"]})
    return out


def training_phases(card: str) -> dict:
    """Phases 7-8: the training path through ``make_fused_gan_train_step``,
    and its timings.  Returns the path's launches, and those of the step
    with ``fused_relayout=True`` (K6's path)."""
    from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
    from speech_enhancement_tpu_torch.train import (
        create_gan_state,
        gan_discriminator_step,
        gan_generator_step,
        l2_loss,
        make_fused_gan_train_step,
    )
    from speech_enhancement_tpu_torch.train.gan import host_pesq_labels

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
                                              else dtype) for dtype in BOTH}
    states = {dtype: new_state() for dtype in BOTH}
    # each step's gradient norms (the generator's by leaf), losses and
    # self-correcting weights, so that a loss that does not fall shows
    # which step, leaf and weight took the large update
    seen = {dtype: read_grads(states[dtype].gen_opt, states[dtype].gen) for dtype in BOTH}
    disc_seen = {dtype: read_grads(states[dtype].disc_opt, states[dtype].disc) for dtype in BOTH}
    leaf_norms = {dtype: [] for dtype in BOTH}
    disc_norms = {dtype: [] for dtype in BOTH}
    weights = {dtype: [] for dtype in BOTH}
    _native.clear_launches()
    t0 = time.perf_counter()
    history = {dtype: [] for dtype in BOTH}
    with sc_weight_trace() as sc:
        for dtype in BOTH:
            for i, (clean, noisy) in enumerate((batches[0],) * 3 + (batches[1],)):
                # steps 0-2 on one repeated batch
                history[dtype].append(steps[dtype](states[dtype], clean, noisy, i))
                leaf_norms[dtype].append({n: g.double().norm() for n, g in seen[dtype].items()})
                disc_norms[dtype].append(torch.stack([g.double().norm()
                                                      for g in disc_seen[dtype].values()]).norm())
                weights[dtype].append(sc[-1])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = kernel_counts()
    print(f"[7 training path] make_fused_gan_train_step, TSCNet(64, 201, fused_attention=True) "
          f"+ Discriminator(16), scp, batch 8 x 16000, 4 steps each fp32 and bf16 in "
          f"{train_s:.2f} s (first calls included); launches {launches} (no training path has "
          f"d 4 or 8)", flush=True)
    for name in ("shaw_attention_fwd_tensor_core", "shaw_attention_fwd_tf32",
                 "shaw_attention_bwd_tensor_core", "shaw_attention_bwd_tf32"):
        check(launches[name] > 0, f"{name} launched {launches[name]} times by the training path")
    for dtype in BOTH:
        values = [{k: float(v) for k, v in m.items()} for m in history[dtype]]
        check(all(np.isfinite(x) for m in values for x in m.values()),
              f"{dtype} training: every loss finite")
        for i, norms in enumerate(leaf_norms[dtype]):
            norms = {n: float(x) for n, x in norms.items()}
            top = max(norms, key=norms.get)
            print(f"    info {dtype} step {i}: "
                  f"{sc_step_text(history[dtype][i], *weights[dtype][i], disc_norms[dtype][i])}; "
                  f"generator |grad| {math.sqrt(sum(x * x for x in norms.values())):.4g} "
                  f"(largest leaf {top} {norms[top]:.3g})", flush=True)
        gen_losses = [m["loss"] for m in values[:3]]
        check(gen_losses[-1] < gen_losses[0],
              f"{dtype} generator loss on one repeated batch falls: "
              f"{', '.join(f'{x:.5f}' for x in gen_losses)}")
        print(f"    info {dtype} last step: "
              + ", ".join(f"{k} {v:.5f}" for k, v in values[-1].items()), flush=True)
    del states, seen, disc_seen, leaf_norms, disc_norms, weights

    # one fp32 step from the same weights, batch and seed: kernel path, and
    # kernel path with the K6 fold, against the plain path
    clean, noisy = batches[2]
    runs = {}
    for label, fused_attention, fused_relayout in (("plain", False, False),
                                                   ("kernel", True, False),
                                                   ("kernel+K6", True, True)):
        state = new_state(fused_attention, fused_relayout)
        grads = read_grads(state.gen_opt, state.gen)
        before = kernel_counts()
        metrics = steps[torch.float32](state, clean, noisy, 100)
        torch.cuda.synchronize()
        runs[label] = ({k: float(v) for k, v in metrics.items()}, grads, counts_since(before))
        del state
    k6_launches = runs["kernel+K6"][2]["swap_seq_axes"]
    check(k6_launches > 0 and runs["kernel"][2]["swap_seq_axes"] == 0,
          f"K6 launched {k6_launches} times by the fused_relayout=True step (0 without)")
    relayout_launches = runs["kernel+K6"][2]
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

    whole_step = {}  # (dtype, path): median whole-step ms
    for dtype in BOTH:
        compute_dtype = None if dtype == torch.float32 else dtype
        order = (("kernel", True), ("plain", False), ("plain", False), ("kernel", True))
        collected = {"kernel": [], "plain": []}
        for label, fused_attention in order:
            state = new_state(fused_attention)
            collected[label].append(phase_times(state, compute_dtype))
            del state
        for label, runs_ in collected.items():
            med = [statistics.median(r[j] for r in runs_) for j in range(4)]
            whole_step[dtype, label] = med[3]
            print(f"    training step {dtype} {label} path: generator {med[0]:.3f} ms, host "
                  f"labels {med[1]:.3f} ms, discriminator {med[2]:.3f} ms, whole step "
                  f"{med[3]:.3f} ms ({card})", flush=True)
    torch.cuda.empty_cache()

    # where the bf16 step's time goes: torch.profiler (CUDA entries only)
    # over 3 steps of the kernel path after 2 warm-up steps
    from torch.profiler import ProfilerActivity, profile
    state = new_state()
    for i in range(2):
        steps[torch.bfloat16](state, *batches[i], i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(2, 5):
            steps[torch.bfloat16](state, *batches[i % len(batches)], i)
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) / 3 * 1e3
    step_ms = whole_step[torch.bfloat16, "kernel"]
    kernel_us = [(e.key, e.self_device_time_total / 3, e.count // 3) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(us for _, us, _ in kernel_us) / 1e3
    k1_ms = sum(us for key, us, _ in kernel_us if "shaw_attention" in key) / 1e3
    k2_ms = sum(us for key, us, _ in kernel_us if "bwd_" in key and "_kernel" in key) / 1e3
    print(f"    torch.profiler, bf16 kernel-path step (3 after 2 warm-ups): {busy_ms:.3f} ms of "
          f"device kernel time per step against the {step_ms:.3f} ms step above: busy share "
          f"{busy_ms / step_ms:.3f} (profiled steps {profiled_ms:.3f} ms each); K1 {k1_ms:.3f} "
          f"ms, K2 {k2_ms:.3f} ms per step ({card})", flush=True)
    print("    info busiest kernels per step: " + "; ".join(
        f"{us / 1e3:.3f} ms x{calls} {key[:50]}"
        for key, us, calls in sorted(kernel_us, key=lambda e: -e[1])[:8]), flush=True)
    del state, prof
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
    return {"launches": launches, "relayout_launches": relayout_launches}


def write_corpus(root, rng, n_train: int = 48, n_test: int = 6) -> str:
    """A synthetic corpus in the VoiceBank layout under ``root``: pairs of
    1.5-4 s harmonic, amplitude-modulated "speech" (a gliding f0 of
    100-250 Hz with six harmonics, 2.5-5 Hz syllable envelope) and the same
    with white noise at 0-15 dB SNR, as tests/test_cli.py builds its pairs,
    but longer; and an overlay on ``config/scp.yaml`` that points ``DATA``
    there with batch 8.  Returns the overlay's path."""
    import os

    from speech_enhancement_tpu_torch.data import save_wav

    dirs = {}
    for split, n in (("train", n_train), ("test", n_test)):
        clean_dir, noisy_dir = (os.path.join(root, f"{kind}_{split}")
                                for kind in ("clean", "noisy"))
        os.makedirs(clean_dir)
        os.makedirs(noisy_dir)
        for i in range(n):
            length = int(rng.integers(24000, 64001))
            t = np.arange(length) / SR
            f0 = rng.uniform(100.0, 250.0) * (
                1.0 + 0.05 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t))
            phase = 2 * np.pi * np.cumsum(f0) / SR
            voiced = sum(np.sin(k * phase) / k for k in range(1, 7))
            syllables = 2 * np.pi * rng.uniform(2.5, 5.0) * t + rng.uniform(0, 6.3)
            envelope = 0.5 + 0.5 * np.sin(syllables)
            clean = 0.3 * envelope * voiced / np.abs(voiced).max()
            noise = rng.standard_normal(length)
            snr_db = rng.uniform(0.0, 15.0)
            noise *= np.sqrt(np.mean(clean ** 2) / (np.mean(noise ** 2) * 10 ** (snr_db / 10)))
            save_wav(os.path.join(clean_dir, f"p{i:03d}.wav"), clean.astype(np.float32))
            save_wav(os.path.join(noisy_dir, f"p{i:03d}.wav"), (clean + noise).astype(np.float32))
        dirs[split] = (clean_dir, noisy_dir)
    import speech_enhancement_tpu_torch.config as config_pkg

    overlay = os.path.join(root, "corpus.yaml")
    with open(overlay, "w") as f:
        f.write(f"BASE: ['{os.path.join(os.path.dirname(config_pkg.__file__), 'scp.yaml')}']\n"
                f"DATA:\n  TRAIN_CLEAN_DIR: '{dirs['train'][0]}'\n"
                f"  TRAIN_NOISY_DIR: '{dirs['train'][1]}'\n"
                f"  TEST_CLEAN_DIR: '{dirs['test'][0]}'\n"
                f"  TEST_NOISY_DIR: '{dirs['test'][1]}'\n  BATCH_SIZE: 8\n")
    return overlay


@contextlib.contextmanager
def fp32_precision(matmul: str, conv: str):
    """torch's fp32 matmul and cuDNN convolution precision flags set to
    ``matmul`` and ``conv`` inside, and restored after."""
    saved = (torch.backends.cuda.matmul.fp32_precision,
             torch.backends.cudnn.conv.fp32_precision)
    torch.backends.cuda.matmul.fp32_precision = matmul
    torch.backends.cudnn.conv.fp32_precision = conv
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.fp32_precision,
         torch.backends.cudnn.conv.fp32_precision) = saved


class StepClock:
    """An ``on_step(idx)`` hook: a CUDA event after every step, and
    ``torch.profiler`` (CUDA activity) over steps 2-4 of the same run.
    After step 1 the card is synchronized and the profiler started; after
    step 4 the card is synchronized, the host's time since the start read
    and the profiler stopped."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.events: list = []
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t_start = self.window_s = None

    def __call__(self, idx: int) -> bool:
        self.events.append(torch.cuda.Event(enable_timing=True))
        self.events[-1].record()
        if idx == 1:
            torch.cuda.synchronize()
            self.prof.start()
            self.t_start = time.perf_counter()
        elif idx == 4:
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - self.t_start
            self.prof.stop()
        return False

    def timings(self, label_wait_ms) -> dict:
        """The step time (median of the intervals between the events: steps
        2-6 of six), the profiled steps' device time and host time per step,
        and their ratio, the busy share."""
        steps_ms = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
        device_ms = sum(e.self_device_time_total for e in self.prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 3 / 1e3
        profiled_ms = self.window_s / 3 * 1e3
        return {"step_ms": statistics.median(steps_ms), "steps_ms": steps_ms,
                "device_ms": device_ms, "profiled_step_ms": profiled_ms,
                "busy": device_ms / profiled_ms, "label_wait_ms": label_wait_ms}


@contextlib.contextmanager
def clocked_epochs():
    """Each epoch of ``cli.main_gan`` inside runs a new :class:`StepClock`
    after the loop's own ``on_step`` (``train.run_gan_epoch`` wrapped);
    the list of the epochs' clocks is yielded."""
    from speech_enhancement_tpu_torch.cli import main_gan

    clocks: list = []
    original = main_gan.run_gan_epoch

    def clocked(state, batches, *, on_step, **kw):
        clock = StepClock()
        clocks.append(clock)

        def on_step_clocked(idx, stats):
            stop = on_step(idx, stats)
            clock(idx)
            return stop

        return original(state, batches, on_step=on_step_clocked, **kw)

    main_gan.run_gan_epoch = clocked
    try:
        yield clocks
    finally:
        main_gan.run_gan_epoch = original


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms (warning, not raising, where an op
    has none), deterministic cuDNN without benchmarking, and cuBLAS's
    fixed workspace, all restored on exit; yields the list, filled on exit,
    of the ops that warned."""
    import os
    import warnings

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    warned: list = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield warned
        warned.extend(sorted({str(w.message)[:120] for w in caught
                              if "deterministic" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:4]
        if saved[4] is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[4]


# the float64 loop against the float64 step: their losses' relative
# distance at any of the 6 steps
LOOP_STEP_RTOL = 1e-4


def loop_against_step(batches, make_state, dtype) -> tuple:
    """Six steps of the two-phase loop (``train.run_gan_epoch``) and six of
    ``make_fused_gan_train_step`` from one fresh state each
    (``make_state()``), on ``batches`` in ``dtype``: ``(loop, step)``, each
    ``(generator losses, discriminator losses)`` by step.  The step labels
    its estimate against the normalized audio, the loop against the batch's
    audio, as in the JAX package (PESQ level-aligns both, up to rounding):
    here the step's estimate is labelled against the batch's audio too, so
    that both sides get the same labels."""
    from speech_enhancement_tpu_torch.data import Batch
    from speech_enhancement_tpu_torch.train import (
        gan,
        l2_loss,
        make_fused_gan_train_step,
        run_gan_epoch,
    )
    from speech_enhancement_tpu_torch.train.loop import step_seed

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    batches = [Batch(*(None if a is None else a.astype(np_dtype) for a in b)) for b in batches]
    looped = run_gan_epoch(make_state(), batches, epoch=0, seed=0, criterion=l2_loss,
                           step_mode="two-phase")
    engine_labels = gan.host_pesq_labels
    state, step, out = make_state(), make_fused_gan_train_step(criterion=l2_loss), []
    device = next(state.gen.parameters()).device
    for i, batch in enumerate(batches):
        clean, noisy, q_clean, q_noisy = (torch.from_numpy(a).to(device) for a in batch)
        gan.host_pesq_labels = lambda ref, est, sr=SR, audio=batch.audio: engine_labels(
            torch.from_numpy(audio[:, :est.shape[1]]), est, sr)
        try:
            metrics = step(state, clean, noisy, step_seed(0, 0, i), q_clean, q_noisy)
        finally:
            gan.host_pesq_labels = engine_labels
        out.append({k: float(v) for k, v in metrics.items()})
    return ((looped.gen_losses, looped.disc_losses),
            ([m["loss"] for m in out], [m["disc_loss"] for m in out]))


def entry_point_phase(card: str, user_precision: tuple) -> dict:
    """Phase 9: ``cli.main_gan`` in every step mode and ``cli.inference_gan``
    on its checkpoints, on a synthetic corpus, at full width; the loop
    against the synchronous step, and resume against a straight run.  The
    timed CLI runs, the synchronous yardstick and inference run at torch's
    precision flags as the process found them (``user_precision``: what a
    user's ``python -m`` gets); the two comparisons in full fp32, as every
    other comparison here.  Returns the launch counts of the CLI calls
    alone, and the timings."""
    import os
    import shutil
    import tempfile

    from speech_enhancement_tpu_torch.cli import inference_gan, main_gan
    from speech_enhancement_tpu_torch.data import Collator, DataLoader, VoicebankDataset
    from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
    from speech_enhancement_tpu_torch.train import (
        create_gan_state,
        l2_loss,
        make_fused_gan_train_step,
    )
    from speech_enhancement_tpu_torch.utils import load_variables

    t_phase = time.perf_counter()
    launches = dict.fromkeys(_native.KERNELS, 0)  # the CLI calls' own, summed
    last: dict = {}  # the latest CLI call's

    def run_cli(entry, args):
        """``entry(args)``; its launches, also when it raises, are put in
        ``last`` and added to ``launches``."""
        before = kernel_counts()
        try:
            return entry(args)
        finally:
            last.update(counts_since(before))
            for k, v in last.items():
                launches[k] += v

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_")
    root = tmp.name
    overlay = write_corpus(root, np.random.default_rng(SEED))
    print(f"[9 entry points] synthetic corpus of 48 + 6 pairs, 1.5-4 s, 0-15 dB SNR, batch 8 "
          f"x 1 s crops (6 steps an epoch); os.cpu_count() {os.cpu_count()}; timed runs and "
          f"inference at torch's fp32 flags as found (matmul {user_precision[0]!r}, cuDNN conv "
          f"{user_precision[1]!r}), the comparisons at 'ieee'; card {card}", flush=True)

    def cli_args(out, *extra, fused=True):
        return ["-a", "scp", "--cfg", overlay, "--output", os.path.join(root, out), "--seed",
                "0", *(["--fused-attention"] if fused else []), *extra]

    # the epoch-0 host batches, for the synchronous step and the comparison
    ds = VoicebankDataset(os.path.join(root, "clean_train"), os.path.join(root, "noisy_train"))
    loader = DataLoader(ds, 8, Collator(precompute_labels=True), seed=0)
    loader.set_epoch(0)
    batches = list(loader)

    def new_state(lr=0.01):
        gen_model = TSCNet(64, 201, fused_attention=True, device="cuda",
                           generator=torch.Generator().manual_seed(SEED))
        disc = Discriminator(16, device="cuda", generator=torch.Generator().manual_seed(SEED + 1))
        return create_gan_state(gen_model, disc, "sgd", lr, momentum=0.9, weight_decay=0.01)

    # one epoch of 6 steps in every step mode, bf16, and two of them in
    # fp32, each clocked and profiled in its own run; then the synchronous
    # step with all three label sets inside, as the yardstick
    timings = {}
    with fp32_precision(*user_precision):
        for mode, precision in (("two-phase", "bf16"), ("async", "bf16"),
                                ("pipelined", "bf16"), ("fused", "bf16"),
                                ("two-phase", "fp32"), ("pipelined", "fp32")):
            t0 = time.perf_counter()
            with clocked_epochs() as clocks:
                (record,) = run_cli(main_gan.main, cli_args(
                    f"{mode}_{precision}", "--epochs", "1", "--step-mode", mode,
                    "--precision", precision))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            stats = record["train"]
            kernels = (("shaw_attention_fwd_tensor_core", "shaw_attention_bwd_tensor_core")
                       if precision == "bf16"
                       else ("shaw_attention_fwd_tf32", "shaw_attention_bwd_tf32"))
            losses = (stats.gen_losses + stats.disc_losses
                      + [record["valid_gen"], record["valid_disc"]])
            check(len(stats.gen_losses) == 6 and all(math.isfinite(x) for x in losses)
                  and stats.gan_steps == len(stats.disc_losses) == 6
                  and all(last[k] > 0 for k in kernels),
                  f"cli.main_gan --step-mode {mode} --precision {precision}: 6 steps, every "
                  f"loss finite, {len(stats.disc_losses)} discriminator updates for "
                  f"{stats.gan_steps} generator steps with the GAN term; launches {last}")
            timings[mode, precision] = {
                **clocks[0].timings(1e3 * stats.label_wait / len(stats.gen_losses)),
                "run_s": run_s}
            print(f"    info {mode} {precision}: generator losses "
                  f"{', '.join(f'{x:.4f}' for x in stats.gen_losses)}; discriminator losses "
                  f"{', '.join(f'{x:.4f}' for x in stats.disc_losses)}; valid gen "
                  f"{record['valid_gen']:.4f} disc {record['valid_disc']:.4f}; run "
                  f"{run_s:.2f} s", flush=True)

        state, clock = new_state(), StepClock()
        sync = make_fused_gan_train_step(criterion=l2_loss, compute_dtype=torch.bfloat16)
        for i, batch in enumerate(batches):
            clean, noisy = (torch.from_numpy(a).pin_memory().cuda(non_blocking=True)
                            for a in batch[:2])
            float(sync(state, clean, noisy, i)["loss"])
            clock(i)
        timings["synchronous", "bf16"] = clock.timings(None)
        del state, clock
        torch.cuda.empty_cache()

    # the two-phase loop against make_fused_gan_train_step, step for step,
    # 6 steps at lr 1e-3 (the CPU tests' rate) from one state, in float64
    # (plain attention: K1 and K2 take fp32 and bf16) under deterministic
    # algorithms, where both sides compute the same sums (on the CPU they
    # agree bit for bit, tests/test_torch_loop.py); and in fp32 with K1 and K2,
    # reported: there the card's nondeterminism (K2's table-gradient
    # atomics, cuDNN's algorithm choice) grows over six steps to ~1e-4, and
    # two runs of the step alone part by 5e-6 in one run and 1.8e-4 in the
    # next, so no bound set from them holds
    def float64_state():
        gen_model = TSCNet(64, 201, fused_attention=False, device="cuda",
                           generator=torch.Generator().manual_seed(SEED))
        disc = Discriminator(16, device="cuda", generator=torch.Generator().manual_seed(SEED + 1))
        return create_gan_state(gen_model.double(), disc.double(), "sgd", 1e-3, momentum=0.9,
                                weight_decay=0.01)

    with deterministic_algorithms():
        pairs = {"float64": loop_against_step(batches, float64_state, torch.float64)}
    pairs["fp32"] = loop_against_step(batches, lambda: new_state(1e-3), torch.float32)
    for dtype, (looped, stepped) in pairs.items():
        for name, i in (("generator", 0), ("discriminator", 1)):
            gaps = [abs(a / b - 1) for a, b in zip(looped[i], stepped[i])]
            print(f"    info {dtype} {name} losses by step, the loop against the step: "
                  + ", ".join(f"{g:.1e}" for g in gaps), flush=True)
            if dtype == "float64":
                check(len(gaps) == 6 and max(gaps) <= LOOP_STEP_RTOL,
                      f"float64 two-phase loop vs make_fused_gan_train_step, 6 steps at lr "
                      f"1e-3, same batches, weights and labels: {name} losses within rtol "
                      f"{max(gaps):.2e} (bound {LOOP_STEP_RTOL:.0e})")
    torch.cuda.empty_cache()

    # resume: 2 epochs straight through, then that run's epoch-1 checkpoint
    # alone in a new output directory, resumed with --resume auto for epoch
    # 2 (as a run killed after its first epoch is; fp32, pipelined, lr 1e-3
    # as above).  Both run under torch's deterministic algorithms with the
    # plain attention (K2 sums its table gradient with atomics): with the
    # card's nondeterminism in epoch 2, rounding has grown past the bounds
    # below (gen.mask_decoder.norm.bias 1.76e-2 in one run, 2.3e-4 in
    # others).  Both epoch 2s start from the same bits, so the
    # first epoch-2 loss must be equal; the CPU test holds resume bit-exact.
    with deterministic_algorithms() as nondeterministic:
        _, straight = run_cli(main_gan.main, cli_args("straight", "--epochs", "2", "--lr",
                                                      "1e-3", fused=False))
        first_epoch = os.path.join("scp", "default", "checkpoint_0000")
        shutil.copytree(os.path.join(root, "straight", first_epoch),
                        os.path.join(root, "resumed", first_epoch))
        (resumed,) = run_cli(main_gan.main, cli_args("resumed", "--epochs", "2", "--lr",
                                                     "1e-3", "--resume", "auto", fused=False))
    print(f"    info --resume auto runs under deterministic algorithms; ops that warned of no "
          f"deterministic version: {nondeterministic or 'none'}", flush=True)
    (ref0, ref1), (got0, got1) = (
        [load_variables(os.path.join(root, run, "scp", "default", f"checkpoint_{e:04d}"))
         for e in (0, 1)] for run in ("straight", "resumed"))
    # per floating-point entry of both models: the relative RMS of the
    # weights after epoch 2, and of their change over epoch 2 (checkpoint 1
    # less checkpoint 0) over the straight run's change or 100 fp32 steps of
    # the entry's RMS, the larger (the rule of tests/test_torch_loop_jax.py)
    floor_steps, per, flat = 100 * float(np.finfo(np.float32).eps), {}, ([], [], [], [])
    for m in ref1:
        for k, want in ref1[m].items():
            if not want.is_floating_point() or not want.abs().max() > 0:
                continue
            want, start, got, got_start = (
                t.double() for t in (want, ref0[m][k], got1[m][k], got0[m][k]))
            d_want, d_got = want - start, got - got_start
            scale = max(float(d_want.pow(2).mean().sqrt()),
                        floor_steps * float(want.pow(2).mean().sqrt()))
            per[f"{m}.{k}"] = (rel_rms_t(got, want),
                               float((d_got - d_want).pow(2).mean().sqrt()) / scale)
            for store, t in zip(flat, (got, want, d_got, d_want)):
                store.append(t.reshape(-1))
    values, changes = (rel_rms_t(torch.cat(a), torch.cat(b))
                       for a, b in (flat[:2], flat[2:]))
    got_losses, want_losses = resumed["train"].gen_losses, straight["train"].gen_losses
    by_step = [abs(a / b - 1) for a, b in zip(got_losses, want_losses)]
    worst_values, worst_changes = (max(per, key=lambda n: per[n][i]) for i in (0, 1))
    check(got_losses[0] == want_losses[0],
          f"--resume auto: the first epoch-2 generator loss equals the straight run's bit "
          f"for bit ({got_losses[0]!r}, {want_losses[0]!r})")
    check(len(by_step) == 6 and max(by_step) <= 1e-3 and values <= 1e-3 and changes <= 1e-3
          and per[worst_values][0] <= 1e-3 and per[worst_changes][1] <= 1e-2,
          f"--resume auto from epoch 1's checkpoint vs 2 epochs straight (fp32, pipelined, lr "
          f"1e-3, plain attention, deterministic algorithms; bit for bit: "
          f"{max(by_step) == values == changes == 0}): epoch-2 generator losses within rtol "
          f"{max(by_step):.2e} (bound 1e-3; by "
          f"step {', '.join(f'{x:.1e}' for x in by_step)}); all weights relative RMS "
          f"{values:.2e}, their epoch-2 change {changes:.2e} (bounds 1e-3); each of {len(per)} "
          f"entries: weights within {per[worst_values][0]:.2e} ({worst_values}; bound 1e-3), "
          f"epoch-2 change within {per[worst_changes][1]:.2e} ({worst_changes}; bound 1e-2)")

    # inference on model_best, bf16 and fp32, and the epoch sweep
    run_dir = os.path.join(root, "straight", "scp", "default")
    with fp32_precision(*user_precision):
        for extra in (["--precision", "bf16"], ["--precision", "fp32"], ["--validate-epochs"]):
            sweep = extra == ["--validate-epochs"]
            result = run_cli(inference_gan.main, [
                "--cfg", overlay, "-m", run_dir if sweep else os.path.join(run_dir, "model_best"),
                "-o", os.path.join(root, "enhanced"), *extra])
            results = result if sweep else [(None, result)]
            k1 = last["shaw_attention_fwd_tensor_core" if "bf16" in extra
                      else "shaw_attention_fwd_tf32"]
            path = ("stft_compress", "uncompress_istft", "add_layer_norm", "glu_conv_swish")
            check(all(np.isfinite(m).all() and len(m) == 6 for _, m in results) and k1 > 0
                  and all(last[k] > 0 for k in path) and len(results) == (2 if sweep else 1),
                  f"cli.inference_gan {' '.join(extra)}: six finite metrics "
                  f"{'; '.join(', '.join(f'{x:.3f}' for x in m) for _, m in results)}; "
                  f"launches K1 {k1}, {', '.join(f'{k} {last[k]}' for k in path)}")

    for (mode, precision), t in timings.items():
        wait = ("labels inside the step" if t["label_wait_ms"] is None
                else f"label wait {t['label_wait_ms']:.3f} ms a step")
        print(f"    {mode} {precision} step: {t['step_ms']:.3f} ms (median of steps 2-6: "
              f"{', '.join(f'{x:.1f}' for x in t['steps_ms'])}); steps 2-4 under the profiler "
              f"{t['profiled_step_ms']:.3f} ms a step, of which device {t['device_ms']:.3f} ms: "
              f"busy share {t['busy']:.3f}; {wait}; os.cpu_count() {os.cpu_count()} ({card})",
              flush=True)
    tmp.cleanup()
    print(f"    phase 9 in {time.perf_counter() - t_phase:.1f} s; launches of the CLI calls "
          f"{launches}", flush=True)
    return {"launches": launches, "timings": {f"{m} {p}": t for (m, p), t in timings.items()}}


FAMILIES = ("diffuse", "tsc-diffuse")


def diffusion_models(device: str) -> dict:
    """Full-width ``DiffuSE`` (64 channels, 30 layers, GroupNorm, n_specs
    201, hop 100, 50 steps) and ``DiffusionTSCNet(64, 201, 50)`` from
    seeds.  DiffuSE's output conv starts at zero; it gets seeded weights of
    RMS 0.01 here, so that the network's output and every gradient are not
    zero."""
    from speech_enhancement_tpu_torch.models import DiffuSE, DiffusionTSCNet

    diffuse = DiffuSE(device=device, generator=torch.Generator().manual_seed(SEED + 10))
    with torch.no_grad():
        w = torch.randn(diffuse.output_projection.weight.shape,
                        generator=torch.Generator().manual_seed(SEED + 11))
        diffuse.output_projection.weight.copy_(0.01 * w)
    return {"diffuse": diffuse,
            "tsc-diffuse": DiffusionTSCNet(64, 201, 50, device=device,
                                           generator=torch.Generator().manual_seed(SEED + 12))}


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def profiled(fn) -> tuple:
    """(result of ``fn()``, the device time of its CUDA kernels by name in
    ms, the host's ms from start to a synchronized end) under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    return out, kernels, host_ms


def diffusion_phase(card: str, user_precision: tuple) -> dict:
    """Phase 10: the diffusion families at full width.  (a) one fp32 train
    step of each on the card against the same step on the CPU (the same
    weights and draws, dropout off), then bf16 steps; (b) both samplers,
    kernel route (K4, K5) against plain route, with K4's and K5's launches
    per ``sample_tsc`` call counted; (c) ``cli.main_diffuse``,
    ``cli.inference_diffuse`` and ``cli.convert_checkpoint``; (d) the
    timings.  The comparisons run at IEEE fp32; the timed steps, samplers
    and CLIs at ``user_precision`` (torch's fp32 matmul and cuDNN flags as
    the process started: what a user's ``python -m`` gets).  Returns the K4
    and K5 launches of the path (the kernel-route sampler runs and the
    inference CLI calls) and the timings."""
    import copy
    import os
    import tempfile

    from speech_enhancement_tpu_torch.cli import (
        convert_checkpoint,
        inference_diffuse,
        main_diffuse,
    )
    from speech_enhancement_tpu_torch.models import DiffusionTSCNet, Discriminator, TSCNet
    from speech_enhancement_tpu_torch.ops import fused_stft as fs
    from speech_enhancement_tpu_torch.train import (
        ModuleState,
        build_optimizer,
        diffuse_step,
        inference_schedule,
        l1_loss,
        linear_noise_schedule,
        sample_tsc,
        sample_waveform,
        tsc_diffusion_step,
    )
    from speech_enhancement_tpu_torch.utils import load_variables

    t_phase = time.perf_counter()
    betas = linear_noise_schedule(50)
    full = inference_schedule(betas)
    fast = inference_schedule(betas, [0.0001, 0.001, 0.01, 0.05, 0.2, 0.35], fast=True)
    rng = np.random.default_rng(SEED + 13)
    timings: dict = {}

    def train_step(family, state, clean, noisy, seed, **kw):
        if family == "diffuse":
            return diffuse_step(state, clean, noisy, betas, seed, criterion=l1_loss, **kw)
        return tsc_diffusion_step(state, clean, noisy, betas, seed, **kw)

    def event_ms(fn):
        """(fn(), its ms between two CUDA events, the host included)."""
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def step_grads(family, model, dev, dtype):
        """(loss, every gradient flattened in float64 on the CPU, seconds)
        of one step of ``model`` on the first batch and the fixed draws,
        dropout off."""
        state = ModuleState(no_dropout(model), build_optimizer("sgd", 1e-3, model))
        grads = read_grads(state.opt, model)
        clean, noisy = (x.to(dev, dtype) for x in batches[0])
        t0 = time.perf_counter()
        loss = float(train_step(family, state, clean, noisy, 0, t=t_draw.to(dev),
                                noise=noise_draw.to(dev, dtype)))
        return (loss, torch.cat([grads[k].reshape(-1).double().cpu() for k in sorted(grads)]),
                time.perf_counter() - t0)

    # (a) one fp32 step of each family, card against CPU: the same seeded
    # weights, batch and draws (t, noise), dropout off (the CPU's and the
    # card's dropout streams differ), SGD-Nesterov lr 1e-3, IEEE fp32
    print(f"[10 diffusion] full width: DiffuSE(64 channels, 30 layers, GroupNorm, n_specs "
          f"201, hop 100, 50 steps), DiffusionTSCNet(64, 201, 50); ({card})", flush=True)
    batches = make_batches(rng, 6, 8, SR)
    draws = torch.Generator().manual_seed(SEED + 14)
    shape = batches[0][0].shape
    t_draw = torch.randint(0, 50, shape[:1], generator=draws)
    noise_draw = torch.randn(shape, generator=draws)
    card_models, cpu_models = diffusion_models("cuda"), diffusion_models("cpu")
    for family in FAMILIES:
        exact_model = copy.deepcopy(cpu_models[family])
        card_loss, card_grads, _ = step_grads(family, card_models[family], "cuda",
                                              torch.float32)
        cpu_loss, cpu_grads, cpu_s = step_grads(family, cpu_models[family], "cpu",
                                                torch.float32)
        grad_err = rel_rms_t(card_grads, cpu_grads)
        grads_ok, how = grad_err <= 1e-3, "bound 1e-3"
        if not grads_ok:
            # over 1e-3, each fp32 step is held to its distance from the same
            # step in float64 on the CPU, a reference the card does not
            # compute: the card's at most 3x the CPU's.  (The L1 loss's
            # gradient sums 128k signed terms and keeps their fp32 roundings,
            # on either device; a card that lost precision, TF32 say, would
            # stand far past 3x.)
            _, exact, exact_s = step_grads(family, exact_model.double(), "cpu", torch.float64)
            card_floor, cpu_floor = rel_rms_t(card_grads, exact), rel_rms_t(cpu_grads, exact)
            grads_ok = card_floor <= 3 * cpu_floor
            how = (f"over 1e-3, so each step against the CPU's float64 step ({exact_s:.1f} s): "
                   f"the card's distance {card_floor:.2e}, at most 3x the CPU fp32 step's "
                   f"{cpu_floor:.2e} (ratio {card_floor / cpu_floor:.2f})")
        del exact_model
        loss_err = abs(card_loss / cpu_loss - 1)
        check(math.isfinite(card_loss) and loss_err <= 1e-4 and grads_ok,
              f"{family} fp32 train step, card vs CPU (batch 8 x 16000, same weights and draws, "
              f"dropout off): loss {card_loss:.6g} vs {cpu_loss:.6g} (rtol {loss_err:.2e}, bound "
              f"1e-4); all {len(cpu_grads)} gradients relative RMS {grad_err:.2e} ({how}); the "
              f"CPU fp32 step took {cpu_s:.1f} s on {torch.get_num_threads()} threads")
    del cpu_models
    # the timed steps below at the user's flags: fp32 steps 2-4 of the
    # compared state, then bf16 (compute_dtype) 5 steps of each from fresh
    # weights, dropout on, and 3 more under the profiler for the busy share
    flags = f"fp32 flags {user_precision}"
    with fp32_precision(*user_precision):
        for family in FAMILIES:
            model = card_models[family]
            state = ModuleState(model, build_optimizer("sgd", 1e-3, model))
            times = [event_ms(lambda b=b, i=i: float(train_step(family, state, *b, i)))[1]
                     for i, b in enumerate(batches[1:4])]
            timings[f"{family} fp32 step ms"] = statistics.median(times)
        del card_models
        torch.cuda.empty_cache()
        for family, model in diffusion_models("cuda").items():
            state = ModuleState(model, build_optimizer("sgd", 1e-3, model))
            losses, times = [], []
            for i, b in enumerate(batches[:5]):
                loss, ms = event_ms(lambda b=b, i=i: float(
                    train_step(family, state, *b, i, compute_dtype=torch.bfloat16)))
                losses.append(loss)
                times.append(ms)
            _, kernels, host_ms = profiled(lambda: [float(train_step(
                family, state, *b, 10 + i, compute_dtype=torch.bfloat16))
                for i, b in enumerate(batches[:3])])
            device = sum(kernels.values())
            timings[f"{family} bf16 step ms"] = statistics.median(times[1:])
            timings[f"{family} bf16 busy"] = device / host_ms
            check(all(math.isfinite(x) for x in losses),
                  f"{family} bf16 (compute_dtype) train steps, dropout on: losses "
                  f"{', '.join(f'{x:.5g}' for x in losses)}")
            print(f"    info {family} train step at {flags}: fp32 "
                  f"{timings[f'{family} fp32 step ms']:.2f} ms (median of 3, CUDA events), bf16 "
                  f"{timings[f'{family} bf16 step ms']:.2f} ms (median of steps 2-5); 3 profiled "
                  f"bf16 steps: device {device / 3:.2f} ms a step over {host_ms / 3:.2f} ms on the "
                  f"host's clock, busy share {device / host_ms:.3f} ({card})", flush=True)
            del model, state
    torch.cuda.empty_cache()

    # (b) both samplers on the card, kernel route against plain route at
    # IEEE fp32, the same generator seed; batch 8 x 2 s
    models = {k: no_dropout(m).eval() for k, m in diffusion_models("cuda").items()}
    noisy2s = make_batches(rng, 1, 8, 2 * SR)[0][1]
    path_launches = dict.fromkeys(_native.KERNELS, 0)

    def add_to_path(counts):
        for k, v in counts.items():
            path_launches[k] += v

    def sampler(kind, schedule, plain):
        g = torch.Generator(device="cuda").manual_seed(SEED + 15)
        fn = sample_tsc if kind == "tsc-diffuse" else sample_waveform
        before = kernel_counts()
        out, ms = event_ms(lambda: fn(models[kind], noisy2s, schedule, g, plain=plain))
        counts = counts_since(before)
        if not plain:
            add_to_path(counts)
        return out, ms, (counts["stft_compress"], counts["uncompress_istft"])

    for kind in FAMILIES:  # warm-up: the models' first calls at these shapes
        sampler(kind, fast, True)
    for kind, name, schedule, steps in (("tsc-diffuse", "sample_tsc", fast, 6),
                                        ("tsc-diffuse", "sample_tsc", full, 50),
                                        ("diffuse", "sample_waveform", fast, 6)):
        got, ms, used = sampler(kind, schedule, False)
        want, _, plain_used = sampler(kind, schedule, True)
        err = rel_rms_t(got, want)
        bnd, how = 1e-4, "bound 1e-4"
        if steps == 50:
            # 50 network calls carry K4's and K5's roundings on: the kernel
            # route measured 5.03e-4 here on an H100, the same to three
            # digits in every run (PERF.md), where two plain runs were
            # bit-equal; the bound is twice that, fixed
            again, _, _ = sampler(kind, schedule, True)
            bnd, how = 1e-3, f"bound 1e-3; two plain runs {rel_rms_t(again, want):.2e} apart"
        want_launches = ((1 + steps, steps) if kind == "tsc-diffuse" else (1, 0))
        check(bool(torch.isfinite(got).all()) and err <= bnd and used == want_launches
              and plain_used == (0, 0),
              f"{name} {steps} steps, batch 8 x 2 s: kernel route vs plain route relative RMS "
              f"{err:.2e} ({how}); K4, K5 launches {used} (expected "
              f"{want_launches}; plain route {plain_used})")
        if steps == 50:
            timings["sample_tsc step ms at IEEE"] = ms / 50

    # (d) the samplers' times at the user's flags: a reverse step of each
    # (the 50-step sample_tsc's and the 6-step sample_waveform's, by CUDA
    # events over the run), both routes over the 6-step schedule, and K4's
    # and K5's device time inside one profiled 6-step sample_tsc
    with fp32_precision(*user_precision):
        for kind in FAMILIES:  # warm-up at these flags
            sampler(kind, fast, False)
        timings["sample_tsc 50-step ms"] = sampler("tsc-diffuse", full, False)[1]
        timings["sample_tsc step ms"] = timings["sample_tsc 50-step ms"] / 50
        for kind, name in (("tsc-diffuse", "sample_tsc"), ("diffuse", "sample_waveform")):
            for plain in ("", " plain"):
                timings[f"{name} 6-step{plain} ms"] = sampler(kind, fast, bool(plain))[1]
        timings["sample_waveform step ms"] = timings["sample_waveform 6-step ms"] / 6
        _, kernels, host_ms = profiled(lambda: sampler("tsc-diffuse", fast, False))
    device = sum(kernels.values())
    k5 = sum(v for k, v in kernels.items() if "istft_kernel" in k)
    k4 = sum(v for k, v in kernels.items() if "stft_kernel" in k and "istft_kernel" not in k)
    timings.update({"sample_tsc K4 ms per step": k4 / 6, "sample_tsc K5 ms per step": k5 / 6,
                    "sample_tsc device ms per step": device / 6,
                    "sample_tsc busy": device / host_ms})
    print(f"    info reverse step, batch 8 x 2 s, at {flags} (CUDA events over the run / its "
          f"steps): sample_tsc {timings['sample_tsc step ms']:.3f} ms (its 50-step run; at "
          f"IEEE {timings['sample_tsc step ms at IEEE']:.3f} ms), sample_waveform "
          f"{timings['sample_waveform step ms']:.3f} ms (its 6-step run); 6-step runs, kernel "
          f"and plain route: sample_tsc {timings['sample_tsc 6-step ms']:.1f} and "
          f"{timings['sample_tsc 6-step plain ms']:.1f} ms, sample_waveform "
          f"{timings['sample_waveform 6-step ms']:.1f} and "
          f"{timings['sample_waveform 6-step plain ms']:.1f} ms; one profiled 6-step "
          f"sample_tsc: device {device / 6:.3f} ms a step, of which K4 {k4 / 6:.4f} ms (7 "
          f"launches / 6) and K5 {k5 / 6:.4f} ms ({100 * (k4 + k5) / device:.2f}% of device "
          f"time), busy share {device / host_ms:.3f} ({card})", flush=True)
    sampler_launches = dict(path_launches)
    check(sampler_launches["add_layer_norm"] > 0 and sampler_launches["glu_conv_swish"] > 0,
          f"sample_tsc's DiffusionTSCNet conformers took the add-and-norm and conv-module "
          f"kernels: {sampler_launches['add_layer_norm']} and "
          f"{sampler_launches['glu_conv_swish']} launches")

    # (c) the entry points on the synthetic corpus: one epoch of each arch,
    # inference --fast --validate-epochs on its checkpoints, and the
    # converter on reference-layout files written from this phase's weights
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_diffusion_")
    root = tmp.name
    overlay = write_corpus(root, np.random.default_rng(SEED + 16))
    with fp32_precision(*user_precision):  # the CLIs as a user runs them
        for arch in FAMILIES:
            out = os.path.join(root, arch)
            t0 = time.perf_counter()
            (record,) = main_diffuse.main(["-a", arch, "--cfg", overlay, "--output", out, "--seed",
                                           "0", "--epochs", "1"])
            train_s = time.perf_counter() - t0
            before = kernel_counts()
            t0 = time.perf_counter()
            results = inference_diffuse.main(["-a", arch, "--cfg", overlay, "--fast", "-m",
                                              os.path.join(out, arch, "default"), "-o",
                                              os.path.join(root, f"enhanced_{arch}"),
                                              "--validate-epochs"])
            infer_s = time.perf_counter() - t0
            counts = counts_since(before)
            used = (counts["stft_compress"], counts["uncompress_istft"])
            # the path's add-and-norm and conv-module launches are the
            # samplers' alone
            add_to_path({"stft_compress": used[0], "uncompress_istft": used[1]})
            losses = record["train_losses"] + [record["valid_loss"]]
            metrics = results[0][1] if results else np.array([])
            check(len(record["train_losses"]) == 6 and all(math.isfinite(x) for x in losses)
                  and len(results) == 1 and len(metrics) == 6 and np.isfinite(metrics).all()
                  and used[0] > 0 and (used[1] > 0) == (arch == "tsc-diffuse"),
                  f"cli.main_diffuse -a {arch} (1 epoch, 6 steps, {train_s:.1f} s): losses "
                  f"{', '.join(f'{x:.4g}' for x in record['train_losses'])}, valid "
                  f"{record['valid_loss']:.4g}; cli.inference_diffuse --fast --validate-epochs "
                  f"({infer_s:.1f} s): six finite metrics "
                  f"{', '.join(f'{x:.3f}' for x in metrics)}; launches K4, K5 {used}")
            timings[f"{arch} cli epoch s"], timings[f"{arch} cli inference s"] = train_s, infer_s

    x1 = noisy2s[:2, :SR].contiguous()
    spec = fs.fused_stft(x1)
    t = torch.tensor([3, 31], device="cuda")
    gen_model = TSCNet(64, 201, device="cuda", generator=torch.Generator().manual_seed(SEED))
    disc_model = Discriminator(16, device="cuda",
                               generator=torch.Generator().manual_seed(SEED + 1))
    sources = {
        "diffuse": ({"arch": "diffuse", "state_dict": models["diffuse"].state_dict()},
                    lambda m: (m(x1, spec.abs()[:, :-1], t),)),
        "tsc-diffuse": ({"arch": "tsc-diffuse",
                         "state_dict": models["tsc-diffuse"].state_dict()},
                        lambda m: m(spec, spec, t)),
        "gan": ({"epoch": 1, "arch": "scp", "gen_state_dict": gen_model.state_dict(),
                 "disc_state_dict": disc_model.state_dict()},
                lambda m: m.eval()(spec)),
    }
    for name, (ckpt, run) in sources.items():
        path = os.path.join(root, f"{name}.pth.tar")
        torch.save({k: ({f"module.{n}": v.cpu() for n, v in sd.items()}
                        if isinstance(sd, dict) else sd) for k, sd in ckpt.items()}, path)
        convert_checkpoint.main([path, os.path.join(root, f"converted_{name}")])
        variables = load_variables(os.path.join(root, f"converted_{name}"))
        if name == "gan":
            src, model = gen_model, TSCNet(64, 201, device="cuda")
            model.load_state_dict(variables["gen"])
        else:
            src = models[name]
            model = (convert_checkpoint.diffuse_from_state_dict(variables["model"])
                     if name == "diffuse" else DiffusionTSCNet(64, 201, device="cpu"))
            model.load_state_dict(variables["model"])
            model = model.cuda().eval()
        with torch.no_grad():
            got, want = run(model), run(src.eval())
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        check(same, f"cli.convert_checkpoint on a reference-layout {name} file of this "
                    f"phase's weights: the converted model's outputs equal the source's "
                    f"bit for bit")
    tmp.cleanup()
    print(f"    phase 10 in {time.perf_counter() - t_phase:.1f} s; K4, K5 launches of the "
          f"diffusion path: samplers {sampler_launches}, all {path_launches}", flush=True)
    return {"launches": path_launches, "timings": timings}


def longest(kernels: dict, n: int = 6) -> str:
    """The ``n`` entries of ``kernels`` (name: ms) with the most time, as
    text."""
    return "; ".join(f"{k[:60]} {v:.2f} ms"
                     for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:n])


def cdiffuse_model(device: str, seed: int, **sizes):
    """A full-width standalone-CDiffuSE ``DiffuSE`` (64 channels, 30 layers,
    no GroupNorm; ``sizes`` override the hop, bins, cycle, steps) from
    ``seed``, its zero-initialized output conv given seeded weights of RMS
    0.01."""
    from speech_enhancement_tpu_torch.models import DiffuSE

    model = DiffuSE(use_groupnorm=False, device=device,
                    generator=torch.Generator().manual_seed(seed), **sizes)
    with torch.no_grad():
        w = torch.randn(model.output_projection.weight.shape,
                        generator=torch.Generator().manual_seed(seed + 1))
        model.output_projection.weight.copy_(0.01 * w)
    return model


def cdiffuse_phase(card: str, user_precision: tuple) -> dict:
    """Phase 11: standalone CDiffuSE at full width (the JAX CLI's ``PARAMS``:
    64 channels, 30 layers, cycle 10, 201 bins at hop 100, batch 16 x 1 s,
    Adam 2e-4, 50 linear steps) on a synthetic corpus.  (a) ``cli.preprocess``;
    (b) ``cli.cdiffuse`` to 6 steps straight, and to 3 then resumed to 6,
    the batches and seeds of steps 3-5 held equal through a hook on the
    learner's step, with the step time, busy share and peak memory; (c) one
    learner step, card against CPU at IEEE fp32; (d) ``cli.cdiffuse_inference``
    on the learner's checkpoint (``auto``: K4), fast and 50 steps, and the
    kernel route against ``plain`` on the same draws; the reverse step's
    time and K4's share; (e) ``cli.convert_checkpoint`` on two
    reference-layout ``weights.pt`` files (hop 100 / 201 bins, and hop 256 /
    80 bins with params: cycle 8, 6 steps) and inference on each with
    ``auto``, ``se`` and ``mel``.  The CLIs and timings run at
    ``user_precision``, the comparisons at IEEE.  Returns K4's launches of
    the inference CLI calls and the timings."""
    import copy
    import glob
    import hashlib
    import os
    import tempfile

    from speech_enhancement_tpu_torch.cli import cdiffuse, cdiffuse_inference, convert_checkpoint
    from speech_enhancement_tpu_torch.cli import preprocess as preprocess_cli
    from speech_enhancement_tpu_torch.data import Collator, DataLoader, VoicebankDataset, load_wav
    from speech_enhancement_tpu_torch.data.preprocess import make_spectrum
    from speech_enhancement_tpu_torch.ops import fused_stft as fs
    from speech_enhancement_tpu_torch.train import ModuleState, diffuse_step, l1_loss
    from speech_enhancement_tpu_torch.train import learner as learner_mod
    from speech_enhancement_tpu_torch.utils import device_memory_stats, trace

    t_phase = time.perf_counter()
    flags = f"fp32 flags {user_precision}"
    timings: dict = {"timed at": f"{flags} (torch's as the process started)",
                     "compared at": "ieee"}
    path_launches = dict.fromkeys(_native.KERNELS, 0)  # of the |STFT| conditioner's CLI calls
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cdiffuse_")
    root = tmp.name
    # 32 training pairs: two batches of 16 a pass, so that a stop at step 3
    # falls inside pass 1
    write_corpus(root, np.random.default_rng(SEED + 20), n_train=32, n_test=6)
    clean_dir, noisy_dir, test_dir = (os.path.join(root, d) for d in
                                      ("clean_train", "noisy_train", "noisy_test"))
    print(f"[11 cdiffuse] full width: DiffuSE(64 channels, 30 layers, cycle 10, n_specs 201, "
          f"hop 100, no GroupNorm), Adam 2e-4, batch 16 x 1 s, 50 linear steps; synthetic "
          f"corpus of 32 + 6 pairs; CLIs and timings at {flags}, comparisons at 'ieee' "
          f"({card})", flush=True)

    # (a) preprocessing on the host
    t0 = time.perf_counter()
    files = preprocess_cli.main([clean_dir, os.path.join(root, "specs"), "--workers", "4"])
    timings["preprocess s"] = time.perf_counter() - t0
    wavs = sorted(glob.glob(f"{clean_dir}/*.wav"))
    specs = [np.load(f) for f in files]
    want, _, _ = make_spectrum(wavs[0])
    err = float(np.abs(specs[0] - want).max())
    check([os.path.basename(f) for f in files] == [os.path.basename(w) + ".spec.npy"
                                                   for w in wavs]
          and all(x.dtype == np.float32 and x.ndim == 2 and x.shape[0] == 201
                  and np.isfinite(x).all() for x in specs) and err <= 1e-6,
          f"cli.preprocess on {len(wavs)} wavs ({timings['preprocess s']:.1f} s): one "
          f".wav.spec.npy each, [201, frames] float32, finite; the first against "
          f"make_spectrum max abs {err:.2e} (bound 1e-6)")

    # (b) the learner through its CLI, its step recorded by a hook
    real_step = learner_mod.diffuse_step
    record: list = []  # (step, seed, clean sha1, noisy sha1, loss, grad_norm)
    events: list = []
    window: dict = {}

    def recording_step(state, clean, noisy, schedule, seed, **kw):
        idx = state.step
        if idx == window.get("first"):
            torch.cuda.synchronize()
            window["stack"] = contextlib.ExitStack()
            window["prof"] = window["stack"].enter_context(trace(os.path.join(root, "trace")))
            window["t0"] = time.perf_counter()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
        loss, grad_norm = real_step(state, clean, noisy, schedule, seed, **kw)
        marks[1].record()
        if idx == window.get("last"):
            torch.cuda.synchronize()
            window["host_s"] = time.perf_counter() - window["t0"]
            window["stack"].close()
        events.append(marks)
        record.append((idx, seed, *(hashlib.sha1(x.cpu().numpy().tobytes()).hexdigest()[:16]
                                    for x in (clean, noisy)), float(loss), float(grad_norm)))
        return loss, grad_norm

    def run_learner(model_dir, max_steps):
        record.clear()
        events.clear()
        t0 = time.perf_counter()
        learner = cdiffuse.main([model_dir, clean_dir, noisy_dir, "--max-steps", str(max_steps),
                                 "-j", "4"])
        return learner, list(record), [a.elapsed_time(b) for a, b in events], \
            time.perf_counter() - t0

    learner_mod.diffuse_step = recording_step
    try:
        with fp32_precision(*user_precision):
            straight_dir, resumed_dir = (os.path.join(root, d) for d in ("straight", "resumed"))
            torch.cuda.reset_peak_memory_stats()
            straight, straight_rec, step_ms, straight_s = run_learner(straight_dir, 6)
            peak = device_memory_stats()[0]["allocated_bytes.all.peak"]
            stopped, stopped_rec, _, stopped_s = run_learner(resumed_dir, 3)
            window.update(first=4, last=5)
            resumed, resumed_rec, _, resumed_s = run_learner(resumed_dir, 6)
    finally:
        learner_mod.diffuse_step = real_step
    learner_kernels = {e.key: e.self_device_time_total / 2e3
                       for e in window["prof"].key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA}
    device = 2 * sum(learner_kernels.values())
    timings.update({"learner step ms": statistics.median(step_ms[1:5]), "learner steps ms": step_ms,
                    "learner busy": device / (window["host_s"] * 1e3),
                    "learner peak allocated bytes": peak,
                    "cdiffuse cli s (6 steps, 3, resume to 6)": [straight_s, stopped_s, resumed_s]})
    losses = [r[4:] for r in straight_rec + stopped_rec + resumed_rec]
    written = all(os.path.exists(os.path.join(d, name)) for d in (straight_dir, resumed_dir)
                  for name in ("summary.jsonl", "weights/state.pt", "weights/variables.pt"))
    check(straight.step == 6 and stopped.step == 3 and resumed.step == 6 and written
          and [r[0] for r in resumed_rec] == [3, 4, 5]
          and [r[:4] for r in resumed_rec] == [r[:4] for r in straight_rec[3:]]
          and [r[:4] for r in stopped_rec] == [r[:4] for r in straight_rec[:3]]
          and all(math.isfinite(x) for pair in losses for x in pair),
          f"cli.cdiffuse 6 steps straight ({straight_s:.1f} s), then 3 and a resume to 6 in "
          f"another directory ({stopped_s:.1f} + {resumed_s:.1f} s): summary.jsonl and "
          f"weights/ written; the resumed run starts at step {resumed_rec[0][0]}; steps 3-5 "
          f"take the straight run's batches and seeds (sha1 of each batch); losses "
          f"{', '.join(f'{r[4]:.4g}' for r in straight_rec)} and grad norms "
          f"{', '.join(f'{r[5]:.4g}' for r in straight_rec)} (straight run), all finite")
    print(f"    info learner step at {flags}: {timings['learner step ms']:.2f} ms (CUDA events, "
          f"median of steps 2-5: {', '.join(f'{x:.2f}' for x in step_ms)}); busy share "
          f"{timings['learner busy']:.3f} (utils.profiling.trace over resumed steps 4-5: device "
          f"{device / 2:.2f} ms a step over {window['host_s'] * 1e3 / 2:.2f} ms on the host's "
          f"clock); peak allocated {peak / 2 ** 30:.2f} GiB (device_memory_stats); the six "
          f"longest kernels a step: {longest(learner_kernels)} ({card})", flush=True)
    del straight, stopped, resumed

    # (c) one learner step, card against CPU, IEEE fp32: the same seeded
    # weights, first batch and draws (t, noise), Adam 2e-4
    loader = DataLoader(VoicebankDataset(clean_dir, noisy_dir, 100, 160), 16,
                        Collator(100, 160, rng=np.random.default_rng(0), silence_check=False),
                        shuffle=True, seed=0, num_workers=4)
    batch = next(iter(loader))
    draws = torch.Generator().manual_seed(SEED + 21)
    t_draw = torch.randint(0, 50, (16,), generator=draws)
    noise_draw = torch.randn((16, 16000), generator=draws)
    betas = np.linspace(1e-4, 0.035, 50)

    def learner_step(model, dev, dtype):
        """(loss, grad_norm, every gradient flattened in float64 on the CPU,
        seconds) of one learner step of ``model``."""
        state = ModuleState(model, torch.optim.Adam(model.parameters(), lr=2e-4))
        grads = read_grads(state.opt, model)
        clean, noisy = (torch.from_numpy(x).to(dev, dtype) for x in (batch.audio, batch.noisy))
        t0 = time.perf_counter()
        loss, norm = diffuse_step(state, clean, noisy, betas, 0, criterion=l1_loss,
                                  t=t_draw.to(dev), noise=noise_draw.to(dev, dtype),
                                  return_grad_norm=True)
        loss, norm = float(loss), float(norm)
        return (loss, norm, torch.cat([grads[k].reshape(-1).double().cpu() for k in sorted(grads)]),
                time.perf_counter() - t0)

    cpu_model = cdiffuse_model("cpu", SEED + 22)
    exact_model = copy.deepcopy(cpu_model).double()
    card_loss, card_norm, card_grads, _ = learner_step(copy.deepcopy(cpu_model).cuda(), "cuda",
                                                       torch.float32)
    cpu_loss, cpu_norm, cpu_grads, cpu_s = learner_step(cpu_model, "cpu", torch.float32)
    loss_err, norm_err = abs(card_loss / cpu_loss - 1), abs(card_norm / cpu_norm - 1)
    grad_err = rel_rms_t(card_grads, cpu_grads)
    ok = loss_err <= 1e-5 and norm_err <= 1e-4 and grad_err <= 1e-3
    how = "each against the CPU fp32 step's"
    if not ok:
        # the CPU's fp32 step is a reference with its own roundings (about
        # 3e-5 in the loss, 6e-4 in the grad norm and 1e-3 in the gradients
        # from float64 on an H100 host): over a bound, the card is held to
        # the same step in float64 on the CPU: the loss within 1e-5 of it;
        # the grad norm and the gradients by phase 10's rule, the card's
        # distance at most 3x the CPU fp32 step's
        exact_loss, exact_norm, exact, exact_s = learner_step(exact_model, "cpu", torch.float64)
        dist = {name: (abs(card / exact_v - 1), abs(cpu / exact_v - 1)) for name, card, cpu, exact_v
                in (("loss", card_loss, cpu_loss, exact_loss),
                    ("grad_norm", card_norm, cpu_norm, exact_norm))}
        card_floor, cpu_floor = rel_rms_t(card_grads, exact), rel_rms_t(cpu_grads, exact)
        ok = ((loss_err <= 1e-5 or dist["loss"][0] <= 1e-5)
              and (norm_err <= 1e-4 or dist["grad_norm"][0] <= 3 * dist["grad_norm"][1])
              and (grad_err <= 1e-3 or card_floor <= 3 * cpu_floor))
        how = (f"over a bound, so against the CPU's float64 step ({exact_s:.1f} s): loss, card "
               f"{dist['loss'][0]:.2e} and CPU fp32 {dist['loss'][1]:.2e} from it (bound 1e-5); "
               f"grad_norm {dist['grad_norm'][0]:.2e} and {dist['grad_norm'][1]:.2e}, "
               f"gradients {card_floor:.2e} and {cpu_floor:.2e} (bounds: 3x the CPU's)")
        timings.update({"card vs float64 loss rtol": dist["loss"][0],
                        "cpu fp32 vs float64 loss rtol": dist["loss"][1],
                        "card vs float64 grad_norm rtol": dist["grad_norm"][0],
                        "cpu fp32 vs float64 grad_norm rtol": dist["grad_norm"][1],
                        "card vs float64 gradients rel rms": card_floor,
                        "cpu fp32 vs float64 gradients rel rms": cpu_floor})
    del exact_model
    check(math.isfinite(card_loss) and ok,
          f"learner step (diffuse_step, return_grad_norm) card vs CPU, batch 16 x 16000, same "
          f"weights and draws: loss {card_loss:.7g} vs {cpu_loss:.7g} (rtol {loss_err:.2e}, "
          f"bound 1e-5); grad_norm {card_norm:.7g} vs {cpu_norm:.7g} (rtol {norm_err:.2e}, "
          f"bound 1e-4); all {len(cpu_grads)} gradients relative RMS {grad_err:.2e} (bound "
          f"1e-3); {how}; the CPU fp32 step took {cpu_s:.1f} s on {torch.get_num_threads()} "
          f"threads")
    timings.update({"card vs cpu loss rtol": loss_err, "card vs cpu grad_norm rtol": norm_err,
                    "card vs cpu gradients rel rms": grad_err})

    # (d) inference on the learner's checkpoint: the CLI (auto: K4) fast and
    # at 50 steps, then the kernel route against plain on the same draws
    noisy_test = [load_wav(p)[0] for p in sorted(glob.glob(f"{test_dir}/*.wav"))]

    def infer(model_dir, *extra, on_path=True):
        """cdiffuse_inference.main on the test wavs: (results, seconds, K4
        launches of the call); ``on_path``: its launches are the path's."""
        before = kernel_counts()
        t0 = time.perf_counter()
        out = cdiffuse_inference.main(["--model-dir", model_dir, "--noisy", test_dir, "-o",
                                       os.path.join(root, "enhanced"), *extra])
        secs, counts = time.perf_counter() - t0, counts_since(before)
        if on_path:
            for k, v in counts.items():
                path_launches[k] += v
        return out, secs, counts["stft_compress"]

    def sane(results, hop, cut_to_hop):
        """Finite, in [-1, 1], and cut to the input's length where the
        sampled buffer reaches it: hop * (L // hop) for the |STFT|
        conditioner, hop * (1 + L // hop) >= L for the host ones."""
        lengths = [len(x) - len(x) % hop if cut_to_hop else len(x) for x in noisy_test]
        return (len(results) == len(noisy_test)
                and [len(est) for _, est in results] == lengths
                and all(np.isfinite(est).all() and np.abs(est).max() <= 1.0
                        for _, est in results))

    weights_dir = os.path.join(straight_dir, "weights")
    with fp32_precision(*user_precision):
        for name, extra, steps in (("fast", ["--fast"], 6), ("50 steps", [], 50)):
            results, secs, k4 = infer(straight_dir, *extra)
            timings[f"cdiffuse_inference {name} s (6 utterances)"] = secs
            check(sane(results, 100, True) and k4 == len(noisy_test),
                  f"cli.cdiffuse_inference --conditioner auto ({name}, {secs:.1f} s) on the "
                  f"learner's checkpoint, {len(noisy_test)} test wavs of 1.5-4 s: finite, in "
                  f"[-1, 1], hop * (L // hop) samples; K4 launches {k4} (one an utterance)")
    errs, used = [], {False: [], True: []}
    for x in noisy_test:
        noises = torch.randn((6, 1, 100 * (len(x) // 100)),
                             generator=torch.Generator().manual_seed(SEED + 23))
        outs = []
        for plain in (False, True):
            before = kernel_counts()
            outs.append(cdiffuse_inference.predict(x, weights_dir, fast=True, noises=noises,
                                                   plain=plain))
            used[plain].append(counts_since(before)["stft_compress"])
        errs.append(rel_rms(*outs))
    n = len(noisy_test)
    # the route by output: K4's 3xTF32 sums round otherwise than the plain
    # STFT's, so the two routes' outputs differ, within the bound
    check(0 < min(errs) and max(errs) <= 1e-4 and used == {False: [1] * n, True: [0] * n},
          f"cdiffuse_inference.predict, kernel route (K4) vs plain route (ops/stft.py), fast "
          f"schedule, the same draws, {n} utterances: relative RMS {min(errs):.2e} to "
          f"{max(errs):.2e} (bound 1e-4; above 0: not one route); K4 launches {used[False]} "
          f"and {used[True]} (plain)")
    x4 = (0.3 * np.random.default_rng(SEED + 24).standard_normal(4 * SR)).astype(np.float32)
    with fp32_precision(*user_precision):
        cdiffuse_inference.predict(x4, weights_dir, fast=True)  # warm-up at this length
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        cdiffuse_inference.predict(x4, weights_dir)
        end.record()
        end.synchronize()
        step = start.elapsed_time(end) / 50
        # the port's own hook (CPU and CUDA activity); its CUDA entries
        # are the kernels
        before = kernel_counts()
        torch.cuda.synchronize()
        with trace(os.path.join(root, "trace_reverse")) as prof:
            t0 = time.perf_counter()
            cdiffuse_inference.predict(x4, weights_dir, fast=True)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        k4_launched = counts_since(before)["stft_compress"]
    kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    device = sum(kernels.values())
    k4_keys = [k for k in kernels if "stft_kernel" in k and "istft_kernel" not in k]
    k4_profiled = sum(kernels[k] for k in k4_keys)
    print(f"    info the trace's CUDA entries: {len(kernels)}, K4's {k4_keys or 'none'}",
          flush=True)
    # K4 at this call's shape by CUDA events (device_ms): earlier runs of
    # this script listed no K4 entry in this trace though K4 launched, where
    # a fresh process lists it under every activity setting
    x4_card = torch.from_numpy(x4[None]).cuda()
    k4_ms = device_ms(lambda: fs.fused_stft(x4_card, comp_type="none"))
    timings.update({"reverse step ms (batch 1 x 4 s)": step,
                    "reverse 6-step device ms": device, "reverse 6-step host ms": host_ms,
                    "reverse K4 ms per call (profiler)": k4_profiled,
                    "reverse K4 ms per call (CUDA events)": k4_ms,
                    "reverse K4 share": k4_ms / device})
    print(f"    info reverse step at batch 1 x 4 s, at {flags}: {step:.3f} ms (CUDA events over "
          f"a 50-step predict / 50); one 6-step predict under utils.profiling.trace: device "
          f"{device:.3f} ms over {host_ms:.3f} ms on the host's clock (busy "
          f"{device / host_ms:.3f}), K4 launched {k4_launched} time(s), its profiler entry "
          f"{k4_profiled:.4f} ms; K4 at [1, 64000] by CUDA events {k4_ms:.4f} ms a call, "
          f"{100 * k4_ms / device:.3f}% of the call's device time; the six longest kernels: "
          f"{longest(kernels)} ({card})", flush=True)

    # (e) reference-layout weights.pt files of this phase's seeded weights,
    # converted and served with each conditioner their widths allow
    fast6 = [0.0001, 0.001, 0.01, 0.05, 0.2, 0.35]
    upstream = {
        "hop 100, 201 bins": ({}, {}, ("auto", "se", "mel")),
        "hop 256, 80 bins": (dict(hop_length=256, n_specs=80, dilation_cycle_length=8,
                                  num_steps=6),
                             {"dilation_cycle_length": 8, "noise_schedule": fast6,
                              "inference_noise_schedule": fast6}, ("auto", "se", "mel")),
    }
    for i, (name, (sizes, params, modes)) in enumerate(upstream.items()):
        source = cdiffuse_model("cuda", SEED + 25 + i, **sizes).eval()
        path, out = (os.path.join(root, f"{x}{i}") for x in ("weights.pt.", "converted_"))
        torch.save({"step": 1000, "model": {k: v.cpu() for k, v in source.state_dict().items()},
                    "params": params}, path)
        convert_checkpoint.main([path, out])
        model, saved = cdiffuse_inference.load_model(out, "cuda")
        hop, bins = source.hop_length, source.n_specs
        audio = torch.from_numpy(noisy_test[0][None, :hop * 40]).cuda()
        cond = torch.rand((1, 40, bins), generator=torch.Generator().manual_seed(SEED + 27))
        t = torch.tensor([3.5], device="cuda")
        with torch.no_grad():
            same = torch.equal(model(audio, cond.cuda(), t), source(audio, cond.cuda(), t))
        dilations = [b.dilated_conv.dilation[0] for b in model.residual_layers]
        check(same and dilations == [2 ** (j % params.get("dilation_cycle_length", 10))
                                     for j in range(len(dilations))]
              and model.diffusion_embedding.embedding.shape[0] == len(
                  params.get("noise_schedule", betas)),
              f"cli.convert_checkpoint on a reference-layout weights.pt ({name}, params "
              f"{sorted(params)}): the converted model's outputs equal the source's bit for "
              f"bit; dilation cycle {params.get('dilation_cycle_length', 10)} and "
              f"{model.diffusion_embedding.embedding.shape[0]} steps from params.json")
        with fp32_precision(*user_precision):
            for mode in modes:
                route = cdiffuse_inference.conditioner_route(model, mode)
                results, secs, k4 = infer(out, "--fast", "--conditioner", mode,
                                          on_path=mode == "auto")
                stft_route = route.startswith("stft")
                check(sane(results, hop, stft_route)
                      and k4 == (len(noisy_test) if stft_route else 0),
                      f"cli.cdiffuse_inference --fast --conditioner {mode} on the converted "
                      f"{name} model ({secs:.1f} s): finite outputs in [-1, 1], cut to length; "
                      f"route {route}; K4 launches {k4}")
        del source, model
        cdiffuse_inference._model_cache.clear()
    tmp.cleanup()
    torch.cuda.empty_cache()
    timings["phase s"] = time.perf_counter() - t_phase
    print(f"    phase 11 in {timings['phase s']:.1f} s; K4 launches of the cdiffuse_inference "
          f"CLI calls {path_launches['stft_compress']}", flush=True)
    return {"launches": path_launches, "timings": timings}


# --------------------------------------------------------------------------
# phase 12: int8 serving convolutions and data parallelism on the one card

DP_ROWS = 8  # the global batch of the data-parallel checks: 8 x 1 s


def kernel_counts() -> dict:
    """A copy of the one launch count (``ops._native.launches``), by kernel
    name."""
    return dict(_native.launches)


def counts_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernel_counts().items()}


def launched(counts: dict, *names: str) -> bool:
    """Whether every kernel of ``names`` launched in ``counts``."""
    return all(counts[name] > 0 for name in names)


def int8_phase(card: str) -> dict:
    """Phase 12 (a): the int8 serving convolutions on a full-width
    ``TSCNet(64, 201, fused_attention=True, quantized_convs=True)`` with
    the float model's seeded weights.  Returns the main path's launches
    (one bf16 and one fp32 int8 ``enhance_batch``) and the timings."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from speech_enhancement_tpu_torch.enhance import Enhancer
    from speech_enhancement_tpu_torch.models import TSCNet
    from speech_enhancement_tpu_torch.ops import int8

    t_phase = time.perf_counter()
    float_model = TSCNet(64, 201, fused_attention=True, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    quant = TSCNet(64, 201, fused_attention=True, quantized_convs=True, device="cuda")
    quant.load_state_dict(float_model.state_dict())
    convs = [m for m in quant.modules() if isinstance(m, int8.QuantConv2d)]
    check(len(convs) == 15, f"TSCNet(quantized_convs=True): {len(convs)} int8 convs (15)")
    batch = (0.1 * np.random.default_rng(SEED + 30).standard_normal((32, 32000))).astype(
        np.float32)
    print(f"[12a int8] TSCNet(64, 201, fused_attention=True, quantized_convs=True), the float "
          f"model's seeded weights; enhance_batch [32, 32000]; card {card}", flush=True)

    # the 15 convs at the shapes of the fp32 batch (at IEEE): the card's
    # route (torch._int_mm) against the plain one (the same int8 values
    # multiplied as fp32, exact below 2^24) on the conv's own input
    shapes, exact = [], []

    def hold(module, inputs, output):
        ph, pw = module.padding
        x = F.pad(inputs[0], (pw, pw, ph, ph))
        xq, _ = int8.quantize_symmetric(x)
        wq, _ = int8.quantize_symmetric(module.weight, dim=(1, 2, 3))
        acc = int8.int8_accumulate(xq, wq, module.stride, module.dilation)
        acc_plain = int8.int8_accumulate(xq, wq, module.stride, module.dilation, plain=True)
        y_plain = int8.int8_conv2d(x, module.weight, module.bias, stride=module.stride,
                                   dilation=module.dilation, plain=True)
        exact.append((torch.equal(acc, acc_plain), torch.equal(output, y_plain),
                      int((acc - acc_plain).abs().max())))
        shapes.append((tuple(x.shape), tuple(module.weight.shape), tuple(module.stride),
                       tuple(module.dilation)))

    hooks = [m.register_forward_hook(hold) for m in convs]
    Enhancer(quant, matmul_precision=None, fused_stft=True, device="cuda").enhance_batch(batch)
    for h in hooks:
        h.remove()
    for (xs, ws, st, dl), (acc_ok, out_ok, diff) in zip(shapes, exact):
        check(acc_ok and out_ok, f"int8 conv x {list(xs)} w {list(ws)} stride {st} dilation "
                                 f"{dl}: int32 accumulators equal (max |diff| {diff}), output "
                                 f"equal to the plain route's fp32 rescale")
    torch.cuda.empty_cache()

    enhancers = {
        ("int8", "bf16"): Enhancer(quant, compute_dtype=torch.bfloat16, fused_stft=True,
                                   device="cuda"),
        ("int8", "fp32"): Enhancer(quant, fused_stft=True, device="cuda"),
        ("float", "bf16"): Enhancer(float_model, compute_dtype=torch.bfloat16,
                                    fused_stft=True, device="cuda"),
        ("float", "fp32"): Enhancer(float_model, fused_stft=True, device="cuda")}
    # the main path: one int8 batch in each dtype, counts from zero
    before = kernel_counts()
    outs = {key: enhancers[key].enhance_batch(batch) for key in (("int8", "bf16"),
                                                                  ("int8", "fp32"))}
    torch.cuda.synchronize()
    launches = counts_since(before)
    for name in ("shaw_attention_fwd_tensor_core", "shaw_attention_fwd_tf32", "stft_compress",
                 "uncompress_istft", "int8_conv2d", "add_layer_norm", "glu_conv_swish"):
        check(launches[name] > 0, f"{name} launched {launches[name]} times by the int8 "
                                  f"serving batches (bf16 and fp32)")
    timings: dict = {"launches": launches}
    for dtype in ("bf16", "fp32"):
        want = enhancers[("float", dtype)].enhance_batch(batch)
        got = outs[("int8", dtype)]
        dist_ = rel_rms(got, want)
        check(got.shape == want.shape and np.isfinite(got).all(),
              f"int8 enhance_batch {dtype}: finite [32, 32000]; relative RMS from the float "
              f"model {dist_:.4f} (reported; tests/test_int8.py's random-init bound is "
              f"0.25 at width 16: {'within' if dist_ < 0.25 else 'beyond'} it)")
        timings[f"int8 vs float rel_rms {dtype}"] = dist_
        int8_ms, float_ms = time_pair(lambda d=dtype: enhancers[("int8", d)].enhance_batch(batch),
                                      lambda d=dtype: enhancers[("float", d)].enhance_batch(
                                          batch), reps=10)
        timings[f"batch ms {dtype}"] = {"int8": int8_ms, "float": float_ms}
        print(f"    enhance_batch [32, 32000] {dtype} (matmul_precision default), CUDA events, "
              f"median of 10 after warm-up, in turns: int8 {int8_ms:.3f} ms, float "
              f"{float_ms:.3f} ms, int8/float {int8_ms / float_ms:.3f} ({card})", flush=True)
    del outs, enhancers
    torch.cuda.empty_cache()

    # the card's int8 model against the CPU's, [2, 32000] at IEEE fp32
    quant_cpu = TSCNet(64, 201, fused_attention=True, quantized_convs=True, device="cpu")
    quant_cpu.load_state_dict(quant.state_dict())
    small = batch[:2]
    t0 = time.perf_counter()
    cpu_out = Enhancer(quant_cpu, matmul_precision=None, device="cpu").enhance_batch(small)
    cpu_s = time.perf_counter() - t0
    card_out = Enhancer(quant, matmul_precision=None, fused_stft=True,
                        device="cuda").enhance_batch(small)
    dist_ = rel_rms(card_out, cpu_out)
    timings["card vs cpu rel_rms"] = dist_
    check(np.isfinite(card_out).all() and dist_ < INT8_CARD_CPU_BOUND,
          f"int8 model [2, 32000] fp32 at IEEE, card (K1, K4, K5, torch._int_mm) vs CPU "
          f"(plain, {cpu_s:.1f} s): relative RMS {dist_:.3e} (bound {INT8_CARD_CPU_BOUND}: "
          f"int8 rounding flips at +-0.5 steps from the float layers' rounding)")
    del quant_cpu

    # the 15 convs alone, each at its shape on seeded inputs: the int8 route
    # against cuDNN's conv, device time by torch.profiler (3 calls each)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    rows, sums = [], {}

    def profiled_ms(fn, reps: int = 3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.key, e.self_device_time_total / 1e3 / reps) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        gemm = sum(ms for key, ms in kernels
                   if any(s in key.lower() for s in ("gemm", "xmma", "cutlass", "imma")))
        return sum(ms for _, ms in kernels), gemm, kernels

    with fp32_precision("tf32", "tf32"):  # the serving default for fp32 convs
        for xs, ws, st, dl in shapes:
            conv = next(m for m in convs if tuple(m.weight.shape) == ws
                        and tuple(m.stride) == st and tuple(m.dilation) == dl)
            entry = {"x": list(xs), "w": list(ws), "stride": list(st), "dilation": list(dl)}
            for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
                x = torch.randn(xs, device="cuda", generator=gen).to(dtype)
                w, b = conv.weight.to(dtype), conv.bias.to(dtype)
                i8, i8_gemm, kernels = profiled_ms(
                    lambda: int8.int8_conv2d(x, w, b, stride=st, dilation=dl))
                cudnn, _, _ = profiled_ms(lambda: F.conv2d(x, w, b, st, 0, dl))
                entry[name] = {"int8_ms": i8, "int8_gemm_ms": i8_gemm, "cudnn_ms": cudnn}
                for k, v in entry[name].items():
                    sums[f"{k} {name}"] = sums.get(f"{k} {name}", 0.0) + v
                if len(rows) == 0 and name == "bf16":
                    top = sorted(kernels, key=lambda e: -e[1])[:5]
                    print("    info int8 conv kernels (first conv, bf16): " + "; ".join(
                        f"{ms:.4f} ms {key[:50]}" for key, ms in top), flush=True)
                del x
            rows.append(entry)
    torch.cuda.empty_cache()
    for name in ("bf16", "fp32"):
        print(f"    15 convs by torch.profiler, {name} inputs: int8 route "
              f"{sums[f'int8_ms {name}']:.3f} ms (of it int8 GEMMs "
              f"{sums[f'int8_gemm_ms {name}']:.3f} ms), cuDNN conv "
              f"{sums[f'cudnn_ms {name}']:.3f} ms ({card})", flush=True)
    timings.update(convs=rows, conv_sums=sums)
    timings["phase s"] = time.perf_counter() - t_phase
    print(f"    phase 12a in {timings['phase s']:.1f} s", flush=True)
    return timings


# the card's int8 model against the CPU's on [2, 32000] (fp32, IEEE)
INT8_CARD_CPU_BOUND = 0.1


def dp_gan_state(device, dtype=torch.float32):
    """Full-width scp models from seeds, every dropout rate 0, SGD lr 1e-3;
    in fp32 the time conformers' attention on K1 and K2, in float64 (which
    they do not take) the plain attention."""
    from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
    from speech_enhancement_tpu_torch.train import create_gan_state

    gen_model = no_dropout(TSCNet(64, 201, fused_attention=dtype == torch.float32,
                                  device=device,
                                  generator=torch.Generator().manual_seed(SEED + 40)))
    disc = Discriminator(16, dropout=0.0, device=device,
                         generator=torch.Generator().manual_seed(SEED + 41))
    return create_gan_state(gen_model.to(dtype), disc.to(dtype), "sgd", 1e-3)


# the small-width scp step of tests/test_torch_disc_step_f64.py: TSCNet(8,
# 201) and Discriminator(4) from these seeds, batch 2 x 4000, fixed labels
SMALL_SEEDS = (SEED + 50, SEED + 51)
SMALL_LABELS = ((0.62, 0.35), ((4.64 - 1) / 3.5,) * 2, (0.21, 0.40))  # est, clean, noisy
# JAX's fp32 scp step at that size on the CPU, its gradients' relative RMS
# from its own float64 step (tests/test_torch_disc_step_f64.py prints it)
JAX_SMALL_FP32_FLOOR = {"gen": 2.4e-5, "disc": 3.5e-6}


def small_gan_grads(device, dtype) -> dict:
    """One scp generator step and one discriminator step at the small width
    (dropout 0, SGD lr 1e-3, plain attention) on ``device`` in ``dtype``
    (fp32 at IEEE on a card): ``{"gen", "disc"}``, each model's gradients
    as the optimizer takes them, flattened in parameter order, float64 on
    the CPU."""
    from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
    from speech_enhancement_tpu_torch.train import create_gan_state, gan, l2_loss

    full_fp32()
    gen_model = no_dropout(TSCNet(8, 201, device="cpu",
                                  generator=torch.Generator().manual_seed(SMALL_SEEDS[0])))
    disc = Discriminator(4, dropout=0.0, device="cpu",
                         generator=torch.Generator().manual_seed(SMALL_SEEDS[1]))
    state = create_gan_state(gen_model.to(device, dtype), disc.to(device, dtype), "sgd", 1e-3)
    rng = np.random.default_rng(0)
    clean = (0.1 * rng.standard_normal((2, 4000))).astype(np.float32)
    noisy = (clean + 0.02 * rng.standard_normal((2, 4000))).astype(np.float32)
    clean, noisy = (torch.from_numpy(a).to(device, dtype) for a in (clean, noisy))
    labels = [torch.tensor(q, dtype=dtype, device=device) for q in SMALL_LABELS]
    grads = {"gen": read_grads(state.gen_opt, state.gen),
             "disc": read_grads(state.disc_opt, state.disc)}
    aux = gan.gan_generator_step(state, clean, noisy, 1, criterion=l2_loss, arch="scp")
    gan.gan_discriminator_step(state, aux, *labels, 2, criterion=l2_loss, arch="scp")
    return {name: torch.cat([g.double().cpu().reshape(-1) for g in grads[name].values()])
            for name in grads}


def dp_inputs(device):
    """The global batch (8 x 1 s, fixed labels as in
    tests/distributed_trainstep_common.py) and the diffusion draws."""
    (clean, noisy), = make_batches(np.random.default_rng(SEED + 42), 1, batch=DP_ROWS)
    rng = np.random.default_rng(SEED + 43)
    labels = [torch.from_numpy(a).to(device) for a in (
        np.linspace(0.4, 0.9, DP_ROWS, dtype=np.float32), np.ones(DP_ROWS, np.float32),
        np.linspace(0.2, 0.5, DP_ROWS, dtype=np.float32))]
    t = torch.from_numpy(rng.integers(0, 50, DP_ROWS)).to(device)
    noise = torch.from_numpy(rng.standard_normal((DP_ROWS, SR)).astype(np.float32)).to(device)
    return clean.to(device), noisy.to(device), labels, t, noise


def dp_steps(rows: slice, timed: int = 0, diffusion: bool = True,
             dtype=torch.float32) -> dict:
    """On ``rows`` of the global batch, in ``dtype`` (fp32 at IEEE, or
    float64): one scp generator step and one discriminator step (in fp32
    K1 and K2), one ``diffuse_step``
    (DiffuSE 64 x 30) and one ``tsc_diffusion_step``, each from fresh
    seeded state: losses, self-correcting weights, gradients (as the
    optimizers take them) and the new state_dicts on the CPU, the grad
    norm, the launch counts; then ``timed`` more GAN step pairs, CUDA
    events around each."""
    from speech_enhancement_tpu_torch.train import (
        ModuleState,
        build_optimizer,
        diffuse_step,
        gan,
        l1_loss,
        l2_loss,
        linear_noise_schedule,
        tsc_diffusion_step,
    )

    full_fp32()
    clean, noisy, labels, t, noise = dp_inputs("cuda")
    clean, noisy, noise = (a[rows].to(dtype) for a in (clean, noisy, noise))
    t = t[rows]
    labels = [q[rows].to(dtype) for q in labels]
    before = kernel_counts()
    state = dp_gan_state("cuda", dtype)
    grads = read_grads(state.gen_opt, state.gen)
    disc_grads = read_grads(state.disc_opt, state.disc)
    with sc_weight_trace() as seen:
        aux = gan.gan_generator_step(state, clean, noisy, 1, criterion=l2_loss, arch="scp")
        disc_loss = gan.gan_discriminator_step(state, aux, *labels, 2, criterion=l2_loss,
                                               arch="scp")
    # copies: later steps update the state in place
    cpu = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}  # noqa: E731
    out = {"metrics": {k: float(v) for k, v in aux.metrics.items()},
           "disc_loss": float(disc_loss), "weights": seen[-1][1].cpu(),
           "grads": cpu({**{f"gen.{k}": v for k, v in grads.items()},
                         **{f"disc.{k}": v for k, v in disc_grads.items()}}),
           "state": cpu({**{f"gen.{k}": v for k, v in state.gen.state_dict().items()},
                         **{f"disc.{k}": v for k, v in state.disc.state_dict().items()}})}
    sched = linear_noise_schedule(50).astype(np.float32)
    for name, model in (diffusion_models("cuda") if diffusion else {}).items():
        model = no_dropout(model).to(dtype)
        mstate = ModuleState(model, build_optimizer("sgd", 1e-3, model))
        mgrads = read_grads(mstate.opt, model)
        if name == "diffuse":
            loss, norm = diffuse_step(mstate, clean, noisy, sched, 0, criterion=l1_loss,
                                      t=t, noise=noise, return_grad_norm=True)
            out["diffuse grad_norm"] = float(norm)
        else:
            loss = tsc_diffusion_step(mstate, clean, noisy, sched, 0, t=t, noise=noise)
        out[name] = {"loss": float(loss), "grads": cpu(mgrads), "state": cpu(model.state_dict())}
        del model, mstate, mgrads
    torch.cuda.synchronize()
    out["launches"] = counts_since(before)
    step_ms = []
    for _ in range(timed):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        aux = gan.gan_generator_step(state, clean, noisy, 1, criterion=l2_loss, arch="scp")
        gan.gan_discriminator_step(state, aux, *labels, 2, criterion=l2_loss, arch="scp")
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    out["step_ms"] = step_ms
    return out


def _dp_rank(process_id: int, world: int, coordinator: str, out_dir: str) -> None:
    """One rank of phase 12 (b)'s two-process check: joins the group (two
    ranks on one card: gloo), runs :func:`dp_steps` on its rows and saves
    the result to ``out_dir/rank{process_id}.pt``."""
    import os

    from speech_enhancement_tpu_torch import parallel

    backend = parallel.init_distributed(coordinator, world, process_id, "cuda:0")
    try:
        idx = parallel.shard_rows(np.arange(DP_ROWS))
        rows = slice(int(idx[0]), int(idx[-1]) + 1)
        out = {"fp32": dp_steps(rows, timed=3), "float64": dp_steps(rows, dtype=torch.float64),
               "backend": backend}
    finally:
        parallel.destroy()
    torch.save(out, os.path.join(out_dir, f"rank{process_id}.pt"))


def _world1_rank(process_id: int, world: int, coordinator: str, out_dir: str) -> None:
    """Phase 12 (b) 1: with deterministic algorithms, the GAN steps twice
    without a group, then once in an NCCL group of world 1, counting the
    collectives issued; saved to ``out_dir/world1.pt`` with the ops that
    warned of no deterministic version."""
    import os
    import warnings

    import torch.distributed as dist

    from speech_enhancement_tpu_torch import parallel

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        alone = [dp_steps(slice(0, DP_ROWS), diffusion=False) for _ in range(2)]
        store = dist.TCPStore("127.0.0.1", parallel.free_port(), 1, is_master=True)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device("cuda:0"))
        calls = {"all_reduce": 0, "broadcast": 0}
        real = {name: getattr(dist, name) for name in calls}

        def counted(name):
            def call(*args, **kwargs):
                calls[name] += 1
                return real[name](*args, **kwargs)
            return call

        for name in calls:
            setattr(dist, name, counted(name))
        try:
            grouped = dp_steps(slice(0, DP_ROWS), diffusion=False)
        finally:
            for name in calls:
                setattr(dist, name, real[name])
            dist.destroy_process_group()
    nondeterministic = sorted({str(w.message)[:120] for w in caught
                               if "deterministic" in str(w.message)})
    torch.save({"alone": alone, "grouped": grouped, "calls": calls,
                "nondeterministic": nondeterministic}, os.path.join(out_dir, "world1.pt"))


def dp_distances(got: dict, want: dict) -> dict:
    """Relative distances of a data-parallel result from one process's."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731

    def flat(d, keys):
        return torch.cat([d[k].double().reshape(-1) for k in keys])

    gen_keys = [k for k in want["grads"] if k.startswith("gen.")]
    disc_keys = [k for k in want["grads"] if k.startswith("disc.")]
    float_state = [k for k, v in want["state"].items() if v.is_floating_point()]
    bn = [k for k in float_state if k.endswith(("running_mean", "running_var"))]
    out = {"gen loss": rel(got["metrics"]["loss"], want["metrics"]["loss"]),
           "disc loss": rel(got["disc_loss"], want["disc_loss"]),
           "sc weights": rel_rms_t(got["weights"], want["weights"]),
           "gen grads": rel_rms_t(flat(got["grads"], gen_keys), flat(want["grads"], gen_keys)),
           "disc grads": rel_rms_t(flat(got["grads"], disc_keys),
                                   flat(want["grads"], disc_keys)),
           "params": rel_rms_t(flat(got["state"], float_state), flat(want["state"], float_state)),
           "bn running stats": rel_rms_t(flat(got["state"], bn), flat(want["state"], bn))}
    for name in ("diffuse", "tsc-diffuse"):
        g, w = got[name], want[name]
        keys = list(w["grads"])
        out[f"{name} loss"] = rel(g["loss"], w["loss"])
        out[f"{name} grads"] = rel_rms_t(flat(g["grads"], keys), flat(w["grads"], keys))
        fs_ = [k for k, v in w["state"].items() if v.is_floating_point()]
        out[f"{name} params"] = rel_rms_t(flat(g["state"], fs_), flat(w["state"], fs_))
    out["diffuse grad_norm"] = rel(got["diffuse grad_norm"], want["diffuse grad_norm"])
    return out


def parallel_phase(card: str, user_precision: tuple) -> dict:
    """Phase 12 (b): data parallelism on the one card.  Returns the launches
    of the two ranks' steps and of the two-replica Enhancer, and the
    timings."""
    import gc
    import os
    import tempfile

    from speech_enhancement_tpu_torch import parallel
    from speech_enhancement_tpu_torch.cli import inference_gan, main_diffuse, main_gan
    from speech_enhancement_tpu_torch.enhance import Enhancer
    from speech_enhancement_tpu_torch.models import TSCNet

    t_phase = time.perf_counter()
    timings: dict = {}
    print(f"[12b data parallel] scp TSCNet(64, 201, fused_attention=True) + "
          f"Discriminator(16), dropout 0, fp32 at IEEE, global batch {DP_ROWS} x 1 s, fixed "
          f"labels; DiffuSE 64 x 30 and DiffusionTSCNet(64); card {card}", flush=True)

    # 1. one process in an NCCL group of world 1 against no group, in a
    # process of its own with deterministic algorithms (cuBLAS's workspace
    # set before its first handle).  Two backward ops of the step have no
    # deterministic CUDA version, so its gradients differ from run to run in
    # the last bits with or without a group: the forward (losses, BatchNorm
    # running statistics) is held bitwise, the collectives issued must be
    # none, and the gradients' distance is printed beside the run-to-run one
    def forward_same(a, b) -> bool:
        bn = [k for k in a["state"] if k.endswith(("running_mean", "running_var"))]
        return a["metrics"] == b["metrics"] and all(torch.equal(a["state"][k], b["state"][k])
                                                   for k in bn)

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dp_")
    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        parallel.spawn(_world1_rank, 1, tmp.name)
    finally:
        if saved is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved
    runs = torch.load(os.path.join(tmp.name, "world1.pt"), weights_only=False)
    alone, grouped = runs["alone"], runs["grouped"]

    def grads_rel(a, b) -> float:
        keys = list(b["grads"])
        return rel_rms_t(torch.cat([a["grads"][k].double().reshape(-1) for k in keys]),
                         torch.cat([b["grads"][k].double().reshape(-1) for k in keys]))

    print(f"    info deterministic algorithms; ops that warned of no deterministic version: "
          f"{runs['nondeterministic'] or 'none'}; gradients, run to run without a group "
          f"{grads_rel(alone[1], alone[0]):.3e}, with the group against without "
          f"{grads_rel(grouped, alone[0]):.3e} (relative RMS)", flush=True)
    check(forward_same(alone[1], alone[0]) and forward_same(grouped, alone[0])
          and sum(runs["calls"].values()) == 0,
          f"an NCCL group of world 1: the scp steps' losses and BatchNorm running statistics "
          f"bitwise equal to the same steps without a group (and to a second run without), "
          f"collectives issued {runs['calls']}")
    del runs, alone, grouped
    one = {"fp32": dp_steps(slice(0, DP_ROWS), timed=3),
           "float64": dp_steps(slice(0, DP_ROWS), dtype=torch.float64)}
    gc.collect()
    torch.cuda.empty_cache()

    # 2-3. two ranks sharing the card over gloo against one process
    t0 = time.perf_counter()
    parallel.spawn(_dp_rank, 2, tmp.name)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    tmp.cleanup()
    check(all(r["backend"] == "gloo" for r in ranks),
          f"two ranks on one card joined over {ranks[0]['backend']} (gloo: NCCL refuses two "
          f"ranks on one device)")
    # float64 (plain attention): the semantics, to 1e-5; fp32 with K1 and K2:
    # within 1e-4, or, where the network amplifies rounding, within 3x the
    # fp32 step's own distance from the float64 one measured here
    exact = dp_distances(ranks[0]["float64"], one["float64"])
    floor = dp_distances(one["fp32"], one["float64"])
    fp32 = dp_distances(ranks[0]["fp32"], one["fp32"])
    timings["two ranks vs one process"] = {"float64": exact, "fp32": fp32,
                                           "fp32 one process vs float64": floor}
    # the fp32 step's own distance from float64, like with like: the scp
    # steps at the small width of tests/test_torch_disc_step_f64.py (plain
    # attention, batch 2 x 4000) on the card at IEEE and on this host's CPU
    # against the CPU's float64 step, beside JAX's figure on the CPU
    small64 = small_gan_grads("cpu", torch.float64)
    small = {where: {m: rel_rms_t(g, small64[m])
                     for m, g in small_gan_grads(where, torch.float32).items()}
             for where in ("cuda", "cpu")}
    timings["small width fp32 vs float64"] = {"card": small["cuda"], "cpu": small["cpu"],
                                              "jax cpu": JAX_SMALL_FP32_FLOOR}
    print(f"    info fp32 step's gradients from float64, full width, card: generator "
          f"{floor['gen grads']:.3e}, discriminator {floor['disc grads']:.3e}", flush=True)
    for m, name in (("gen", "generator"), ("disc", "discriminator")):
        limit = 3 * min(small["cpu"][m], JAX_SMALL_FP32_FLOOR[m])
        check(small["cuda"][m] <= limit,
              f"the small-width fp32 scp step's {name} gradients from float64: card (IEEE) "
              f"{small['cuda'][m]:.3e}, this host's CPU {small['cpu'][m]:.3e}, JAX on a CPU "
              f"{JAX_SMALL_FP32_FLOOR[m]:.1e} (bound {limit:.2e}: 3x the closer of the two; "
              f"TF32 in the run would put it near 1e-3)")
    for name, d in exact.items():
        check(d <= 1e-5, f"float64, two ranks x {DP_ROWS // 2} rows vs one process x "
                         f"{DP_ROWS}: {name} relative {d:.3e} (bound 1e-5)")
    for name, d in fp32.items():
        limit = max(1e-4, 3 * floor[name])
        check(d <= limit, f"fp32 (K1, K2), two ranks vs one process: {name} relative {d:.3e} "
                          f"(bound {limit:.3e}: 1e-4, or 3x the one-process fp32 step's "
                          f"distance from float64, {floor[name]:.3e})")
    for key in ("fp32", "float64"):
        a, b = ranks[0][key], ranks[1][key]
        equal = all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
        equal &= all(torch.equal(a[m]["state"][k], b[m]["state"][k])
                     for m in ("diffuse", "tsc-diffuse") for k in a[m]["state"])
        check(equal, f"{key}: the two ranks' updated GAN, DiffuSE and diffusion-TSCNet states "
                     f"are bitwise equal")
    launches = {k: ranks[0]["fp32"]["launches"][k] + ranks[1]["fp32"]["launches"][k]
                for k in ranks[0]["fp32"]["launches"]}
    for name in ("shaw_attention_fwd_tf32", "shaw_attention_bwd_tf32"):
        check(launches[name] > 0, f"{name} launched {launches[name]} times by the two ranks' "
                                  f"steps")
    one_ms = one["fp32"]["step_ms"]
    rank_ms = [r["fp32"]["step_ms"] for r in ranks]
    timings["step ms"] = {"rank 0": rank_ms[0], "rank 1": rank_ms[1], "one process": one_ms}
    print(f"    scp step pair, fp32 IEEE: two ranks of {DP_ROWS // 2} rows sharing the card "
          f"{statistics.median(rank_ms[0]):.1f} / "
          f"{statistics.median(rank_ms[1]):.1f} ms, one process of {DP_ROWS} rows "
          f"{statistics.median(one_ms):.1f} ms (medians of 3; two ranks on one card share "
          f"its SMs: no data-parallel speed-up is measured here); the two-rank spawn took "
          f"{spawn_s:.1f} s ({card})", flush=True)
    del ranks, one

    # 4. the training CLIs with --num-processes 2 on phase 9's corpus
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dp_cli_")
    root = tmp.name
    overlay = write_corpus(root, np.random.default_rng(SEED))
    with fp32_precision(*user_precision):
        for label, entry, argv in (
                ("cli.main_gan", main_gan,
                 ["-a", "scp", "--step-mode", "pipelined", "--fused-attention", "--precision",
                  "bf16"]),
                ("cli.main_diffuse", main_diffuse, ["-a", "tsc-diffuse"])):
            arch = argv[1]
            out = os.path.join(root, arch)
            t0 = time.perf_counter()
            history = entry.main([*argv, "--cfg", overlay, "--output", out, "--seed", "0",
                                  "--epochs", "1", "--num-processes", "2"])
            epoch_s = time.perf_counter() - t0
            run = os.path.join(out, arch, "default")
            logs = [open(os.path.join(run, f"log_rank{r}.txt")).read() for r in range(2)]
            digests = [[line.split("replicas: ", 1)[1] for line in log.splitlines()
                        if "replicas: " in line] for log in logs]
            ckpts = sorted(p for p in os.listdir(run) if p.startswith("checkpoint_"))
            losses = (history[0]["train"].gen_losses if arch == "scp"
                      else history[0]["train_losses"])
            check(len(history) == 1 and losses and all(math.isfinite(x) for x in losses)
                  and digests[0] and digests[0] == digests[1] and ckpts == ["checkpoint_0000"]
                  and "saved checkpoint_0000" in logs[0]
                  and "saved checkpoint_0000" not in logs[1],
                  f"{label} {' '.join(argv)} --num-processes 2, one epoch ({epoch_s:.1f} s, "
                  f"spawn included): rank 0's losses {', '.join(f'{x:.4g}' for x in losses)}; "
                  f"both ranks' replica digests {digests[0][-1][:40] if digests[0] else None}... "
                  f"equal; checkpoints {ckpts}, written by rank 0 alone")
            timings[f"{label} epoch s"] = epoch_s

        # 5. serving on two replicas of one card; the inference CLI
        gen_model = TSCNet(64, 201, fused_attention=True, device="cuda",
                           generator=torch.Generator().manual_seed(SEED + 44))
        rng = np.random.default_rng(SEED + 45)
        utts = [(0.1 * rng.standard_normal(n)).astype(np.float32)
                for n in (16000, 23100, 31900, 40000, 47700)]
        before = kernel_counts()
        got = Enhancer(gen_model, matmul_precision="float32", fused_stft=True,
                       devices=["cuda:0", "cuda:0"]).enhance(utts, batch_size=5)
        serving = counts_since(before)
        want = Enhancer(gen_model, matmul_precision="float32", fused_stft=True,
                        device="cuda").enhance(utts, batch_size=5)
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        check(err <= 2e-5, f"Enhancer(devices=['cuda:0', 'cuda:0'], fused_stft=True) on 5 "
                           f"ragged utterances (6 rows, 3 + 3) vs one device: max abs "
                           f"{err:.3e} (atol 2e-5, as tests/test_parallel.py)")
        for name in ("shaw_attention_fwd_tf32", "stft_compress", "uncompress_istft",
                     "add_layer_norm", "glu_conv_swish"):
            check(serving[name] > 0, f"{name} launched {serving[name]} times by the "
                                     f"two-replica Enhancer")
            launches[name] += serving[name]
        metrics = {}
        for n in (1, 2):
            metrics[n] = inference_gan.main([
                "--cfg", overlay, "-m", os.path.join(root, "scp", "scp", "default",
                                                     "model_best"),
                "-o", os.path.join(root, f"enhanced_{n}"), "--n-devices", str(n)])
        diff = float(np.abs(np.asarray(metrics[1]) - np.asarray(metrics[2])).max())
        check(np.isfinite(metrics[1]).all() and np.isfinite(metrics[2]).all() and diff < 1e-3,
              f"cli.inference_gan --n-devices 1 on rank 0's checkpoint: six finite metrics "
              f"{', '.join(f'{x:.3f}' for x in metrics[1])}; --n-devices 2 (two replicas on "
              f"the card) within {diff:.2e} of them")
    tmp.cleanup()
    timings["launches"] = launches
    timings["phase s"] = time.perf_counter() - t_phase
    print(f"    phase 12b in {timings['phase s']:.1f} s; launches of the two ranks' steps and "
          f"the two-replica Enhancer {launches}", flush=True)
    return timings


# phase 13 (b)'s rich corpus (train pairs, test pairs, seconds) and the
# SHA-256 of the JAX script's make_corpus at those flags and rng 7
# (train_quality_proxy.corpus_digest; tests/test_torch_quality_proxy.py)
QUALITY_CORPUS = (16, 8, 2.0)
QUALITY_CORPUS_SHA256 = "94497e119e15af6d39686e24ee62939c5bd732fc5475617dfa1500e07ec59f70"


def proxy_outputs(report: str, record: str, per_key: str) -> tuple[bool, str]:
    """Whether a proxy script wrote its report (with the summary line) and a
    record of finite six-metric rows, and the summary line."""
    import os
    import re

    if not (os.path.exists(report) and os.path.exists(record)):
        return False, f"missing: {report if not os.path.exists(report) else record}"
    with open(report) as f:
        text = f.read()
    with open(record) as f:
        rows = json.load(f)
    rows = [rows["noisy"], *rows[per_key].values()]
    value = r"-?[\d.]+"  # STOI is negative on an untrained model's output
    summary = re.search(rf"Best \w+ \d+: PESQ {value} vs noisy {value} \(Δ [+-][\d.]+\); STOI "
                        rf"{value} vs {value} \(Δ [+-][\d.]+\)\.", text)
    ok = summary is not None and len(rows) > 1 and all(
        len(r) == 6 and all(math.isfinite(v) for v in r) for r in rows)
    return ok, summary.group(0) if summary else "no summary line"


def quality_phase(card: str, user_precision: tuple) -> dict:
    """Phase 13: the quality scripts (``speech_enhancement_tpu_torch/scripts``)
    at full width, cut in length: (a) the precision check on 8 x 2 s, the
    IEEE fp32 reference and the five fast modes; (b) the GAN proxy on the
    rich corpus of :data:`QUALITY_CORPUS` (its digest held to the JAX
    script's), one epoch of scp in bf16 with the fused attention kernels in
    the async mode, and its sweep; (c) the diffusion proxy, tsc-diffuse
    for one epoch of 2 steps and a 6-step sweep on 4 pairs; (d) the CDiffuSE
    proxy for 20 learner steps and a 6-step sweep on 4 pairs.  Each runs
    at torch's precision flags as the process started, with every launch
    counter zeroed before it and read after it.  Returns the launches per
    kernel summed over (a)-(d) and the timings."""
    import os
    import tempfile

    from speech_enhancement_tpu_torch.scripts import (
        check_precision_quality,
        train_cdiffuse_proxy,
        train_diffusion_proxy,
        train_quality_proxy,
    )

    t_phase = time.perf_counter()
    timings: dict = {}
    launches = {k: 0 for k in kernel_counts()}

    def counted(label: str, fn):
        """``fn()`` with the counters zeroed before it; its launches, added
        to the phase's, and its seconds."""
        _native.clear_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = kernel_counts()
        for k, v in got.items():
            launches[k] += v
        timings[f"{label} s"] = secs
        timings[f"{label} launches"] = got
        return out, got, secs

    print(f"[13 quality] the quality scripts at full width, cut in length, at torch's flags as "
          f"the process started; card {card}", flush=True)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_quality_")
    with fp32_precision(*user_precision):
        # (a) the precision check
        modes = list(check_precision_quality.MODES)
        results, got, secs = counted("precision check", lambda: check_precision_quality.main(
            ["--batch", "8", "--seconds", "2", "--modes", *modes]))
        timings["precision check"] = results
        gate = check_precision_quality.GATE_PESQ
        for mode in ("bf16", "bf16_fused"):
            r = results[mode]
            check(r["pesq_vs_fp32_mean"] >= gate,
                  f"(a) precision check {mode}: PESQ against the IEEE fp32 output mean "
                  f"{r['pesq_vs_fp32_mean']}, min {r['pesq_vs_fp32_min']} (gate {gate} on the "
                  f"mean), relative RMS {r['rel_rms']}")
        for mode in ("fp32", "bf16_fused_int8", "fp32_int8"):
            r = results[mode]
            print(f"    info (a) precision check {mode}: PESQ mean {r['pesq_vs_fp32_mean']}, "
                  f"min {r['pesq_vs_fp32_min']} against the gate {gate} "
                  f"({'above' if r['pesq_vs_fp32_mean'] >= gate else 'below'}); relative RMS "
                  f"{r['rel_rms']}", flush=True)
        check(launched(got, "shaw_attention_fwd_tensor_core", "shaw_attention_fwd_tf32",
                       "stft_compress", "uncompress_istft", "int8_conv2d")
              and all(math.isfinite(v) for r in results.values() for v in r.values()),
              f"(a) precision check, 8 x 2 s, five modes in {secs:.1f} s: finite scores; "
              f"launches {got}")

        # (b) the GAN proxy: corpus digest, one epoch, the sweep
        root = os.path.join(tmp.name, "gan")
        n_train, n_test, seconds = QUALITY_CORPUS
        rc, got, secs = counted("gan proxy", lambda: train_quality_proxy.main([
            "--root", root, "--train-pairs", str(n_train), "--test-pairs", str(n_test),
            "--seconds", str(seconds), "--epochs", "1", "--corpus", "rich", "--precision",
            "bf16", "--fused-attention", "--step-mode", "async"]))
        digest = train_quality_proxy.corpus_digest(root)
        check(digest == QUALITY_CORPUS_SHA256,
              f"(b) the rich corpus ({n_train} + {n_test} pairs of {seconds} s, rng 7) written "
              f"on this host: SHA-256 {digest[:16]}... equal to the JAX script's "
              f"{QUALITY_CORPUS_SHA256[:16]}...")
        ok, summary = proxy_outputs(os.path.join(root, "quality_proxy_run.md"),
                                    os.path.join(root, "ab_scp_async_rich.json"), "per_epoch")
        check(ok and launched(got, "shaw_attention_fwd_tensor_core",
                              "shaw_attention_bwd_tensor_core", "shaw_attention_fwd_tf32",
                              "stft_compress", "uncompress_istft"),
              f"(b) train_quality_proxy, scp one epoch bf16 --fused-attention async and the "
              f"sweep in {secs:.1f} s, exit code {rc}: report and record written, finite "
              f"metrics; {summary}; launches {got}")

        # (c) the diffusion proxy
        root = os.path.join(tmp.name, "diffusion")
        rc, got, secs = counted("diffusion proxy", lambda: train_diffusion_proxy.main([
            "--root", root, "--train-pairs", "16", "--test-pairs", "4", "--epochs", "1",
            "--eval-every", "1", "--fast"]))
        ok, summary = proxy_outputs(os.path.join(root, "diffusion_proxy_run.md"),
                                    os.path.join(root, "diffusion_tsc-diffuse_fast.json"),
                                    "per_epoch")
        check(ok and launched(got, "stft_compress", "uncompress_istft"),
              f"(c) train_diffusion_proxy, tsc-diffuse one epoch of 2 steps and a --fast sweep "
              f"on 4 pairs in {secs:.1f} s, exit code {rc}: report and record written, finite "
              f"metrics; {summary}; launches {got}")

        # (d) the CDiffuSE proxy
        root = os.path.join(tmp.name, "cdiffuse")
        rc, got, secs = counted("cdiffuse proxy", lambda: train_cdiffuse_proxy.main([
            "--root", root, "--train-pairs", "16", "--test-pairs", "4", "--max-steps", "20",
            "--eval-every", "20", "--fast"]))
        ok, summary = proxy_outputs(os.path.join(root, "cdiffuse_proxy_run.md"),
                                    os.path.join(root, "cdiffuse_fast.json"), "per_step")
        check(ok and launched(got, "stft_compress"),
              f"(d) train_cdiffuse_proxy, 20 learner steps and a --fast sweep on 4 pairs in "
              f"{secs:.1f} s, exit code {rc}: report and record written, finite metrics; "
              f"{summary}; launches {got}")
    tmp.cleanup()
    timings["launches"] = launches
    timings["phase s"] = time.perf_counter() - t_phase
    print(f"    phase 13 in {timings['phase s']:.1f} s; launches of (a)-(d) {launches} "
          f"({card})", flush=True)
    return timings


# --------------------------------------------------------------------------
# phase 14: the long-run and runbook scripts, cut in length

# the code each counted child runs first: at exit it writes the one launch
# count (``ops._native.launches``) to ``<dir>/<pid>.json``; a SIGKILLed
# child writes none
COUNTING_PROLOGUE = """\
import atexit as _atexit
def _write_launch_counts(out_dir={out_dir!r}):
    import json, os
    from speech_enhancement_tpu_torch.ops import _native
    with open(os.path.join(out_dir, f"{{os.getpid()}}.json"), "w") as f:
        json.dump(_native.launches, f)
_atexit.register(_write_launch_counts)
"""


class CountedChildren:
    """Stands in for the module ``subprocess`` of a script: each Python
    child it starts (``-c code`` or ``-m module``) runs
    :data:`COUNTING_PROLOGUE` first, from the repository root, so that its
    launches can be summed after it exits."""

    def __init__(self, out_dir: str):
        import os

        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def _wrap(self, cmd: list) -> list:
        exe, flag, *rest = cmd
        prologue = COUNTING_PROLOGUE.format(out_dir=self.out_dir)
        if flag == "-c":
            return [exe, "-c", prologue + rest[0]]
        assert flag == "-m", cmd
        module, *argv = rest
        return [exe, "-c", prologue + (
            f"import runpy, sys\nsys.argv = [{module!r}, *{argv!r}]\n"
            f"runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n")]

    def run(self, cmd, **kw):
        return subprocess.run(self._wrap(cmd), **kw)

    def Popen(self, cmd, **kw):  # noqa: N802 (the name it stands in for)
        return subprocess.Popen(self._wrap(cmd), **kw)

    def launches(self) -> dict:
        """The launches of every child that has exited, summed."""
        import glob
        import os

        total = dict.fromkeys(kernel_counts(), 0)
        for path in glob.glob(os.path.join(self.out_dir, "*.json")):
            with open(path) as f:
                for k, v in json.load(f).items():
                    total[k] += v
        return total


@contextlib.contextmanager
def children_counted(module, out_dir: str):
    """``module.subprocess`` replaced by a :class:`CountedChildren`."""
    real = module.subprocess
    module.subprocess = CountedChildren(out_dir)
    try:
        yield module.subprocess
    finally:
        module.subprocess = real


class Tee:
    """A text stream that writes to the real stdout and keeps a copy."""

    def __init__(self):
        self.parts: list[str] = []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return sys.__stdout__.write(text)

    def flush(self) -> None:
        sys.__stdout__.flush()

    def text(self) -> str:
        return "".join(self.parts)


# (b): the drill's corpus and schedule, cut in length (cycles at epochs
# 2/4/6, the gen-first flip at 2); the JAX run's noisy row is of the
# script's default corpus (320 + 24 pairs of 2 s, rng 7)
DRILL_FLAGS = ("--train-pairs", "32", "--test-pairs", "8", "--epochs", "8",
               "--kill-after-epoch", "1")
FULL_RECIPE_CORPUS = (320, 24, 2.0)
# (a): JAX's test bound on each committed MOS (tests/test_pesq.py)
CONFORMANCE_ATOL = 1e-4


def long_run_phase(card: str, user_precision: tuple) -> dict:
    """Phase 14: the long-run and runbook scripts
    (``speech_enhancement_tpu_torch/scripts``) at full width, cut in
    length: (a) the PESQ engine's conformance sweep against the committed
    fixture; (b) the full-recipe drill, 8 epochs on 32 + 8 pairs with the
    SIGKILL after epoch 1, and the sweep of every checkpoint; (c) the
    label-bias study's control and bias-0.3 arms side by side, one epoch
    on 16 + 8 pairs; (d) the parity runbook on (b)'s corpus, one epoch.
    (a) and the noisy row of the recipe's default corpus run on threads
    beside (b), (d) beside (c).
    Each script runs at torch's flags as the process started, with every
    launch counter zeroed before it; the children's launches are their own
    counters at exit.  Returns the launches per kernel summed over (b)-(d)
    and the timings."""
    import gc
    import os
    import re
    import tempfile
    from contextlib import redirect_stdout

    from speech_enhancement_tpu_torch.metrics.pesq import pesq
    from speech_enhancement_tpu_torch.scripts import (
        label_bias_study,
        make_pesq_validation_set,
        run_full_recipe_proxy,
        run_quality_parity,
        train_quality_proxy,
    )
    from speech_enhancement_tpu_torch.utils import load_checkpoint, load_variables

    t_phase = time.perf_counter()
    timings: dict = {}
    launches = {k: 0 for k in kernel_counts()}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_long_run_")

    lock = threading.Lock()

    def counted(label: str, module, fn, children_only: bool = False):
        """``fn()`` with the counters zeroed before it and the module's
        children counted; its launches (this process's and its
        children's), added to the phase's, and its seconds.  With
        ``children_only`` (a script that launches nothing in this process,
        run beside another) this process's counters are left alone."""
        if not children_only:
            _native.clear_launches()
        t0 = time.perf_counter()
        with children_counted(module, os.path.join(tmp.name, "counts", label)) as children:
            out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        kids = children.launches()
        here = dict.fromkeys(kids, 0) if children_only else kernel_counts()
        got = {k: here[k] + kids[k] for k in here}
        with lock:
            for k, v in got.items():
                launches[k] += v
            timings[f"{label} s"] = secs
            timings[f"{label} launches"] = got
            timings[f"{label} child launches"] = kids
        return out, got, kids, secs

    print(f"[14 long-run] the long-run and runbook scripts at full width, cut in length, at "
          f"torch's flags as the process started; card {card}", flush=True)
    # the children need the card's memory more than this process's cache
    gc.collect()
    torch.cuda.empty_cache()

    def conformance():
        t0 = time.perf_counter()
        return make_pesq_validation_set.build_conformance(pesq), time.perf_counter() - t0

    def default_corpus_noisy_row():
        root = os.path.join(tmp.name, "full_recipe_default_corpus")
        n_train, n_test, seconds = FULL_RECIPE_CORPUS
        train_quality_proxy.make_corpus(root, n_train, n_test, seconds,
                                        np.random.default_rng(7))
        return train_quality_proxy.noisy_baseline(root)[1]

    with fp32_precision(*user_precision), ThreadPoolExecutor(max_workers=2) as pool:
        sweep_job = pool.submit(conformance)
        noisy_job = pool.submit(default_corpus_noisy_row)

        # (b) the full-recipe drill
        root_b = os.path.join(tmp.name, "full_recipe")
        tee = Tee()

        def drill():
            with redirect_stdout(tee):
                return run_full_recipe_proxy.main(["--root", root_b, *DRILL_FLAGS])

        rc, got, kids, secs = counted("full recipe drill", run_full_recipe_proxy, drill)
        printed = tee.text()
        record_path = os.path.join(root_b, "full_recipe_run.json")
        ok, summary = proxy_outputs(os.path.join(root_b, "full_recipe_run.md"), record_path,
                                    "per_epoch")
        with open(record_path) as f:
            record = json.load(f)
        ckpt_dir = os.path.join(root_b, "run", "scp", "default")
        with open(os.path.join(ckpt_dir, "log_rank0.txt")) as f:
            log = f.read()
        before_resume = log[:log.find("=> resumed from")]
        killed = re.search(r"killed trainer \d+s in, after checkpoint_0001", printed)
        check(killed is not None and "=> saved checkpoint_0001 " in before_resume
              and "=> saved checkpoint_0002 " not in before_resume,
              f"(b) the drill's trainer was SIGKILLed after checkpoint_0001 "
              f"({killed.group(0) if killed else 'no kill line'}; its log saved no later "
              f"checkpoint before the resume)")
        loaded = []
        for epoch in range(8):
            path = os.path.join(ckpt_dir, f"checkpoint_{epoch:04d}")
            state, variables = load_checkpoint(path), load_variables(path)
            loaded.append(state["epoch"] == epoch + 1 and set(variables) == {"gen", "disc"})
        per_epoch = record["per_epoch"]
        check(ok and record["resume_epoch"] == 2 and all(loaded) and sorted(per_epoch, key=int)
              == [str(e) for e in range(8)]
              and launched(kids, "shaw_attention_fwd_tensor_core", "shaw_attention_bwd_tensor_core")
              and got["shaw_attention_fwd_tensor_core"] > kids["shaw_attention_fwd_tensor_core"]
              and launched(got, "stft_compress", "uncompress_istft"),
              f"(b) run_full_recipe_proxy {' '.join(DRILL_FLAGS)} (bf16, fused attention) in "
              f"{secs:.1f} s, exit code {rc}: resume epoch {record['resume_epoch']} (want 2), "
              f"best epochs {record['best_epochs']}, {sum(loaded)} of 8 checkpoints load, "
              f"{len(per_epoch)} finite swept rows; {summary}; launches {got} (the resumed "
              f"trainer's {kids}; the killed one's are not counted)")
        print("    info (b) swept PESQ by epoch: " + ", ".join(
            f"{e} {per_epoch[str(e)][0]:.3f}" for e in range(8))
            + f"; the drill corpus's noisy row {[round(v, 3) for v in record['noisy']]}",
            flush=True)

        # (b) the noisy row of the recipe's default corpus, against JAX's
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                               "full_recipe_run.json")) as f:
            jax_noisy = json.load(f)["noisy"]
        noisy = noisy_job.result()
        check(all(abs(a - b) <= 5e-4 for a, b in zip(noisy, jax_noisy)),
              f"(b) the full recipe's default corpus ({FULL_RECIPE_CORPUS[0]} + "
              f"{FULL_RECIPE_CORPUS[1]} pairs of {FULL_RECIPE_CORPUS[2]} s, rng 7) written "
              f"and scored on this host: noisy row "
              f"{', '.join(f'{v:.4f}' for v in noisy)} equal to docs/full_recipe_run.json's "
              f"{', '.join(f'{v:.4f}' for v in jax_noisy)} to three decimals")

        # (a) the conformance sweep, against the committed fixture
        sweep, sweep_s = sweep_job.result()
        timings["conformance sweep s"] = sweep_s
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                               "fixtures", "pesq_engine_conformance.json")) as f:
            fixture = json.load(f)
        dists = {}
        for key, value in (("mnru", "mos"), ("level_offsets", "delta_mos"),
                           ("delay_offsets", "delta_mos")):
            mine, theirs = sweep[key], fixture[key]
            same = [{k: v for k, v in r.items() if k != value} for r in mine] == \
                [{k: v for k, v in r.items() if k != value} for r in theirs]
            dists[key] = max(abs(a[value] - b[value]) for a, b in zip(mine, theirs)) \
                if same else math.inf
        summ = sweep["summary"]
        timings["conformance max distance"] = dists
        check(max(dists.values()) <= CONFORMANCE_ATOL and summ["monotone_violations"] == 0
              and summ["max_abs_level_delta_mos"] <= 0.02
              and summ["max_abs_delay_delta_mos"] <= 0.05,
              f"(a) the PESQ engine's conformance sweep ({len(sweep['mnru'])} MNRU, "
              f"{len(sweep['level_offsets'])} level and {len(sweep['delay_offsets'])} delay "
              f"scores, this host's g++ -march=native build) in {sweep_s:.1f} s against "
              f"tests/fixtures/pesq_engine_conformance.json: largest distance MNRU "
              f"{dists['mnru']:.2e}, level {dists['level_offsets']:.2e}, delay "
              f"{dists['delay_offsets']:.2e} (atol {CONFORMANCE_ATOL}); {summ} (bounds 0, "
              f"0.02, 0.05)")

    # (c) two label-bias arms and (d) the parity runbook on (b)'s corpus,
    # side by side: every launch of theirs is a child's
    root_c = os.path.join(tmp.name, "label_bias")
    arms = [a for a in label_bias_study.ARMS if a[0] in ("control", "bias-0.3")]
    out_d = os.path.join(tmp.name, "parity")

    def study_arms():
        """The two arms side by side, each a child of its own."""
        with ThreadPoolExecutor(max_workers=len(arms)) as pool:
            jobs = [pool.submit(label_bias_study.run_arm, name, bias, noise, root_c, 1,
                                extra=("--train-pairs", "16", "--test-pairs", "8"))
                    for name, bias, noise in arms]
            return [job.result() for job in jobs]

    def runbook():
        return run_quality_parity.main([
            "--train-clean", f"{root_b}/train/clean", "--train-noisy", f"{root_b}/train/noisy",
            "--test-clean", f"{root_b}/test/clean", "--test-noisy", f"{root_b}/test/noisy",
            "--arch", "scp", "--epochs", "1", "--sweep-last", "1", "-o", out_d])

    with fp32_precision(*user_precision), ThreadPoolExecutor(max_workers=2) as pool:
        arms_job = pool.submit(counted, "label-bias arms", label_bias_study, study_arms, True)
        runbook_job = pool.submit(counted, "parity runbook", run_quality_parity, runbook, True)
        records, got, kids, secs = arms_job.result()
        rows_ok = all(len(r) == 6 and all(math.isfinite(v) for v in r)
                      for rec in records for r in [rec["noisy"], *rec["per_epoch"].values()])
        bests = [max(v[0] for v in rec["per_epoch"].values()) for rec in records]
        check(rows_ok and records[0]["noisy"] == records[1]["noisy"]
              and launched(kids, "shaw_attention_fwd_tensor_core", "shaw_attention_bwd_tensor_core",
                           "stft_compress", "uncompress_istft"),
              f"(c) label_bias_study arms control and bias-0.3 side by side, one epoch on "
              f"16 + 8 pairs in {secs:.1f} s: records written, finite rows, noisy rows "
              f"bit-equal (evaluation unperturbed); best PESQ {bests[0]:.3f} and "
              f"{bests[1]:.3f}; launches {got}")

        results, got, kids, secs = runbook_job.result()
        report = os.path.join(out_d, "quality_parity_results.md")
        text = open(report).read() if os.path.exists(report) else ""
        scp = results.get("scp") or {}
        row = scp.get("metrics") or ()
        check(scp.get("best_epoch") == 0 and len(row) == 6
              and all(math.isfinite(v) for v in row) and "| scp (epoch 0) | PESQ |" in text
              and launched(kids, "shaw_attention_fwd_tensor_core", "stft_compress",
                           "uncompress_istft"),
              f"(d) run_quality_parity --arch scp --epochs 1 --sweep-last 1 on (b)'s corpus, "
              f"beside (c), in {secs:.1f} s: report with the scp row, best epoch "
              f"{scp.get('best_epoch')}; launches {got}")
        print(f"    info (d) these are synthetic-corpus numbers after one epoch, not parity: "
              f"scp PESQ {row[0] if row else float('nan'):.3f} against the reference's "
              f"{run_quality_parity.REFERENCE_ROWS['scp'][0]} on VoiceBank-DEMAND", flush=True)
    tmp.cleanup()
    timings["launches"] = launches
    timings["phase s"] = time.perf_counter() - t_phase
    print(f"    phase 14 in {timings['phase s']:.1f} s; launches of (b)-(d) {launches} "
          f"({card})", flush=True)
    return timings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    started = time.perf_counter()
    from speech_enhancement_tpu_torch.enhance import Enhancer
    from speech_enhancement_tpu_torch.metrics import pesq
    from speech_enhancement_tpu_torch.models import TSCNet
    from speech_enhancement_tpu_torch.ops import fused_attention as fa
    from speech_enhancement_tpu_torch.ops import fused_conv_module as fcm
    from speech_enhancement_tpu_torch.ops import fused_norm as fnorm
    from speech_enhancement_tpu_torch.ops import fused_relayout as fr
    from speech_enhancement_tpu_torch.ops import fused_stft as fs

    # torch's precision flags as a user's process starts with them, for the
    # entry points' timed runs
    user_precision = (torch.backends.cuda.matmul.fp32_precision,
                      torch.backends.cudnn.conv.fp32_precision)
    full_fp32()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    try:  # host data (wav IO, resampling) would lean on it
        import scipy
        scipy_note = f"scipy {scipy.__version__} imports"
    except ImportError as exc:
        scipy_note = f"scipy does not import ({exc})"
    print(f"[1 device] {kind}, {count} visible; nvidia-smi name,power.limit: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for "
          f"matmuls and cuDNN outside the Enhancers; {scipy_note}", flush=True)

    # 2. build: one compiler per source, all at once
    t0 = time.perf_counter()
    builds = (fs.build, fa.build, fa.build_mma, fa.build_tf32, fa.build_bwd, fa.build_bwd_mma,
              fa.build_bwd_tf32, fr.build, fnorm.build, fcm.build, pesq.build)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for build in [pool.submit(b) for b in builds]:
            build.result()
    built = ", ".join(f"{name} {sec:.1f} s" for name, sec in _native.build_seconds.items())
    print(f"[2 build] {built}; wall {time.perf_counter() - t0:.1f} s (nvcc sm_90a and g++, "
          f"in parallel)", flush=True)
    for library, kernels, what in (
            ("shaw_attention_mma", ["shaw_attention_mma_kernelILi16", "shaw_attention_mma_kernelILi32"],
             "K1 tensor-core instance"),
            ("shaw_attention_tf32", ["shaw_attention_tf32_kernelILi16",
                                     "shaw_attention_tf32_kernelILi32"],
             "K1 fp32 tensor-core instance"),
            ("shaw_attention_bwd_mma", ["bwd_query_mma_kernelILi16", "bwd_key_mma_kernelILi16",
                                        "bwd_query_mma_kernelILi32", "bwd_key_mma_kernelILi32"],
             "K2 tensor-core instance"),
            ("shaw_attention_bwd_tf32", ["bwd_query_tf32_kernelILi16", "bwd_key_tf32_kernelILi16",
                                         "bwd_query_tf32_kernelILi32", "bwd_key_tf32_kernelILi32"],
             "K2 fp32 tensor-core instance"),
            ("stft", ["11stft_kernel", "12istft_kernel"], "K4 and K5"),  # mangled lengths
            ("add_layer_norm", ["add_layer_norm_c64_kernel", "add_layer_norm_any_kernel"],
             "add-and-norm"),
            ("conv_module", ["glu_conv_swish_kernel"], "conv-module")):
        report = ptxas_report(_native.build_logs.get(library, ""))
        for name, lines in sorted(report.items()):
            short = next((k.lstrip("0123456789") for k in kernels if k in name), name)
            print(f"    info ptxas -v, {what} {short}: {'; '.join(lines)}", flush=True)
        found = [k for k in kernels if any(k in name for name in report)]
        check(found == kernels and all(" 0 bytes spill stores, 0 bytes spill loads" in line
                                       for lines in report.values() for line in lines
                                       if "spill" in line),
              f"{what}: ptxas reports no spills in {', '.join(kernels)}")
    for d in (16, 32):
        warps = 4 * fa.mma_occupancy(d)
        check(warps >= 8, f"K1 tensor-core instance d={d}: {warps} resident warps per SM "
                          f"(at least 8)")
        warps = 4 * fa.tf32_occupancy(d)
        check(warps >= 8, f"K1 fp32 tensor-core instance d={d}: {warps} resident warps per SM "
                          f"(at least 8)")
    for n_fft, hop in ((400, 100), (300, 75)):
        frames, smem, blocks = fs.istft_occupancy(n_fft, hop)
        warps = blocks * frames // 8  # two warps per 16 frames
        check(warps >= 8, f"K5 n_fft {n_fft} hop {hop}: {frames} frames per block, {smem} bytes "
                          f"of shared memory, {warps} resident warps per SM (at least 8)")
    for d in (16, 32):
        for n in (161, 321, 1281):
            blocks_a, blocks_b = fa.bwd_mma_occupancy(d, n)
            line = (f"K2 tensor-core instance d={d} n={n}: {4 * blocks_a} resident warps per SM "
                    f"in pass A (its table band grows with n), {4 * blocks_b} in pass B")
            if n == 1281:  # the long bucket: the band of 1025 clipped rows fills shared memory
                print(f"    info {line}", flush=True)
            else:
                check(min(blocks_a, blocks_b) >= 2, line + " (at least 8)")
            # the fp32 instance stages fp32 rows: at least 8 warps at the
            # training shape (d 16, n 161), the others as they come
            blocks_a, blocks_b = fa.bwd_tf32_occupancy(d, n)
            line = (f"K2 fp32 tensor-core instance d={d} n={n}: {4 * blocks_a} resident warps per "
                    f"SM in pass A, {4 * blocks_b} in pass B")
            if (d, n) == (16, 161):
                check(min(blocks_a, blocks_b) >= 2, line + " (at least 8)")
            else:
                print(f"    info {line}", flush=True)

    # 3. the serving path's kernels against their plain versions, then timed
    checked = kernel_phase(3, card)

    # 4. the main path, through the entry points a user calls
    model = TSCNet(64, 201, fused_attention=True, device="cuda",
                   generator=torch.Generator().manual_seed(SEED))
    plain_model = TSCNet(64, 201, fused_attention=False, device="cuda")
    plain_model.load_state_dict(model.state_dict())
    rng = np.random.default_rng(SEED)
    lengths = [int(n) for n in rng.integers(16000, 64001, size=12)]
    utts = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]
    # matmul_precision=None (full fp32) wherever the kernel path is held to
    # the plain path; the fp32 default, "bfloat16", runs TF32 matmuls and
    # convolutions on the card
    kernel_bf16 = Enhancer(model, compute_dtype=torch.bfloat16, matmul_precision=None,
                           fused_stft=True, device="cuda")
    kernel_fp32 = Enhancer(model, matmul_precision=None, fused_stft=True, device="cuda")
    kernel_tf32 = Enhancer(model, fused_stft=True, device="cuda")
    plain_bf16 = Enhancer(plain_model, compute_dtype=torch.bfloat16, matmul_precision=None,
                          device="cuda")
    plain_fp32 = Enhancer(plain_model, matmul_precision=None, device="cuda")

    _native.clear_launches()
    t0 = time.perf_counter()
    out = {"kernel bf16": kernel_bf16.enhance(utts, batch_size=8),
           "kernel fp32": kernel_fp32.enhance(utts, batch_size=8),
           "kernel fp32 default (TF32)": kernel_tf32.enhance(utts, batch_size=8)}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    serving = kernel_counts()
    print(f"[4 main path] 12 utterances {min(lengths)}-{max(lengths)} samples, batch 8, "
          f"bf16 + fp32 (matmul_precision None and the default) kernel path in {main_s:.2f} s "
          f"(first calls included); launches {serving} (no main path has d 4 or 8)",
          flush=True)
    for name in ("shaw_attention_fwd_tensor_core", "shaw_attention_fwd_tf32", "stft_compress",
                 "uncompress_istft", "add_layer_norm", "glu_conv_swish"):
        check(serving[name] > 0, f"{name} launched {serving[name]} times by the main path")
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
    # TF32 keeps 10 mantissa bits where bf16 keeps 7: the bf16 bound holds it
    for name, limit in (("kernel fp32", 1e-3), ("kernel bf16", 0.35), ("plain bf16", 0.35),
                        ("kernel fp32 default (TF32)", 0.35)):
        err = rel_rms(np.concatenate(out[name]), ref)
        check(err < limit, f"{name} vs plain fp32: relative RMS {err:.3e} (bound {limit}; "
              f"bf16 bound as tests/test_enhance.py)")
    err = rel_rms(np.concatenate(out["kernel bf16"]), np.concatenate(out["plain bf16"]))
    print(f"    info kernel bf16 vs plain bf16: relative RMS {err:.3e} (the plain "
          f"attention takes its softmax in bf16, the kernel in fp32)", flush=True)
    del out

    # 5. timings (the fp32 kernel path's are cmgan-serve-batch's, in sebench/)
    print(f"[5 timings] per call: CUDA events around one call, median of 10 after "
          f"warm-up; card {card}", flush=True)
    batch = (0.1 * rng.standard_normal((32, 32000))).astype(np.float32)
    kernel_ms, plain_ms = time_pair(lambda: kernel_bf16.enhance_batch(batch),
                                    lambda: plain_bf16.enhance_batch(batch), reps=10)
    print(f"    enhance_batch [32, 32000] bf16: kernel path {kernel_ms:.3f} ms, plain path "
          f"{plain_ms:.3f} ms ({card})", flush=True)
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
    print("    info busiest kernels: " + "; ".join(
        f"{us / 1e3:.3f} ms {key[:60]}" for key, us in sorted(kernel_us, key=lambda e: -e[1])[:6]),
        flush=True)
    del kernel_bf16, kernel_fp32, kernel_tf32, plain_bf16, plain_fp32, prof
    torch.cuda.empty_cache()

    # 6. the training path's kernels against their plain versions, then timed
    checked.update(kernel_phase(6, card))
    # 7-8. the training path
    train = training_phases(card)
    # 9. the entry points a user runs
    entry = entry_point_phase(card, user_precision)
    # 10. the diffusion families
    diffusion = diffusion_phase(card, user_precision)
    # 11. standalone CDiffuSE
    cdiffuse = cdiffuse_phase(card, user_precision)
    # 12. int8 serving convolutions; data parallelism on the one card
    int8_t = int8_phase(card)
    parallel_t = parallel_phase(card, user_precision)
    # 13. the quality scripts
    quality_t = quality_phase(card, user_precision)
    # 14. the long-run and runbook scripts
    long_run_t = long_run_phase(card, user_precision)
    print(f"[done] {time.perf_counter() - started:.1f} s, build included", flush=True)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        for what in FAILURES:
            print(f"    FAIL {what}", file=sys.stderr)
        return 1
    kernels = kernels_line(checked, {
        "serving (phase 4)": serving, "training (phase 7)": train["launches"],
        "fused_relayout step (phase 7)": train["relayout_launches"],
        "entry points (phase 9)": entry["launches"], "diffusion (phase 10)": diffusion["launches"],
        "cdiffuse (phase 11)": cdiffuse["launches"], "int8 serving (phase 12)": int8_t["launches"],
        "data parallel (phase 12)": parallel_t["launches"],
        "quality scripts (phase 13)": quality_t["launches"],
        "long-run scripts (phase 14)": long_run_t["launches"]})
    print(json.dumps({"entry_point_timings": entry["timings"]}))
    print(json.dumps({"diffusion_timings": diffusion["timings"]}))
    print(json.dumps({"cdiffuse_timings": cdiffuse["timings"]}))
    print(json.dumps({"int8_timings": int8_t}))
    print(json.dumps({"parallel_timings": parallel_t}))
    print(json.dumps({"quality_timings": quality_t}))
    print(json.dumps({"long_run_timings": long_run_t}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
