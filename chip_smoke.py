#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speech_enhancement_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with a CUDA card, nvcc
(PATH, $CUDA_HOME or /usr/local/cuda), g++ and no JAX needed.  Phases, one
line each (timings beside the card's name and power limit):

1. the device, and ``nvidia-smi --query-gpu=name,power.limit``; whether
   scipy imports;
2. build the nine native sources of ``csrc/`` (eight CUDA sources and the
   PESQ engine), one compiler each, all started together (seconds);
   ptxas's registers and spills of the tensor-core instances of K1 and K2
   (bf16 and fp32 each) and of K4 and K5 (no spills allowed), and their
   resident warps per SM;
3. K1 (all three instances: bf16 and fp32 on tensor cores at d 16 and 32,
   B'=3232 n=321 and n=1281 included, CUDA cores at d 4 and 8), K4 and K5
   (each at n_fft 400 / hop 100 and 300 / 75) against their plain PyTorch
   versions on the card, at the shapes of the serving path, with the
   tolerance stated beside each; K1's row log-sum-exp against the plain
   one;
4. the serving path itself: ``Enhancer(fused_stft=True)`` on a full-width
   ``TSCNet(64, 201, fused_attention=True)`` (seeded random weights)
   enhances 12 utterances of 1-4 s at batch 8, in bf16 and fp32 (at
   ``matmul_precision=None``, full fp32, and at the default
   ``"bfloat16"``, TF32 on the card); the outputs must be finite, in
   order, cut to length, and agree with the same weights run through the
   plain path; the launch count of every kernel of the path over that run
   must be > 0 (the CUDA-core K1 is on no main path: it takes head dims 4
   and 8 only);
5. kernel path against plain path for ``enhance_batch`` on [32, 32000]
   (per call, bf16 and fp32 at ``matmul_precision=None``; the fp32 kernel
   path also at the default, TF32), K1's device time per batch from
   ``torch.profiler`` (bf16 and fp32), and the kernel rows of K1 (each
   instance), K4 and K5: device time, per-call time, plain time, bound and
   library time (K1 at n = 1281 against SDPA over 8 batch chunks; K4 and
   K5 against their library calls in 5 alternating rounds, medians and
   per-round ratios printed);
6. K2 (the Shaw-attention backward, through the autograd route whose
   forward is K1; all three instances, B'=3232 n=321 included) and K6 (the
   axis swap, forward and backward) against their plain versions at
   training shapes;
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
   busy share (``torch.profiler``); the kernel rows of K1 (both
   tensor-core instances at B'=808 n=161), K2 (both tensor-core instances
   at B'=808 n=161 and B'=3232 n=321, CUDA-core fp32 at d=8, each against
   the autograd backward of the SDPA yardstick) and K6; peak device memory
   of a step with and without rematerialization;
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
   at fp32 and lr 1e-3, with the same labels (losses rtol 1e-4, or 3x what
   three runs of the step part by, the larger); ``--resume auto`` at lr
   1e-3 from the epoch-1 checkpoint of a run of two epochs, against that
   run's epoch 2 (the first epoch-2 loss bit for bit; epoch-2 losses 1e-3,
   all weights and their epoch-2 change 1e-3, and per entry of both models
   its weights 1e-3 and its epoch-2 change 1e-2);
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
   ``cli.inference_gan --n-devices 1`` and ``2`` on the checkpoint.

Timing: a kernel's device time is CUDA events around N back-to-back calls
(N >= 20, and enough calls for >= 2 ms), queued behind a spin kernel so
that the host's per-call cost leaves no gap between them, divided by N;
its per-call time is CUDA events around one call, host included (median).
A row says whether its working set fits the 50 MB L2 (then the repeated
calls find their inputs there).  Bounds are the larger of the operations
over the card's peak rate for their type and the bytes (each input read
once, each output written once) over 3.35 TB/s; a 3xTF32 kernel's fp32
products count three TF32 products each.  ``library_ms`` is one
PyTorch call computing the same function, timed here and used nowhere in
the port.

The line before the last is the kernels' JSON record (``launches``: the
main paths' counts: phases 4 and 7, each zeroed before its path, phase
9's CLI calls, each counted from before to after it, phase 10's
kernel-route sampler runs and ``inference_diffuse`` calls, and phase 11's
``cdiffuse_inference`` calls with the |STFT| conditioner, phase 12's int8
batches, each zeroed before, and its two ranks' steps (each rank counts
from zero in its own process) and two-replica ``Enhancer``; with
``launches_by_path``), after phase 9's, 10's and 11's timings and phase
12's ``int8_timings`` and ``parallel_timings`` as JSON; the last is
``{"ok": true, "device": {...}}``.  Any failed check exits 1 without that
last line; with no CUDA device it exits 1 at once.

fp32 comparisons run with TF32 off for matmuls and cuDNN convolutions
(torch's ``fp32_precision`` flags, ``"ieee"``), so that the plain path is
full fp32; phase 9's timed runs restore the flags a process starts with.
"""

from __future__ import annotations

import contextlib
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


# peak rates of one H100 SXM (NVIDIA's data sheet, dense, 700 W): bf16 on
# tensor cores, fp32 on CUDA cores; TF32 495 TFLOP/s on tensor cores (the
# same data sheet's dense TF32 rate), which a 3xTF32 kernel spends three
# times per fp32-accurate product
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
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


def bound(flops: float, nbytes: float, dtype=torch.bfloat16,
          tf32x3: bool = False) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes"); with
    ``tf32x3`` the fp32 products run as three TF32 products each on tensor
    cores (3 x flops at ``PEAK_TF32``)."""
    t_ops = (3 * flops / PEAK_TF32 if tf32x3 else flops / PEAK_FLOPS[dtype]) * 1e3
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
            "l2_warm": nbytes < L2_BYTES, "shape": shape,
            "dtype": {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]}


def attention_bound(b, n, dtype, h=4, d=16, tf32x3=False):
    """K1: three n x n x d contractions per (sequence, head); q, k, v, out."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * n * h * d * elem
    return bound(6.0 * b * h * n * n * d, nbytes, dtype, tf32x3), nbytes


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

    errs = {"K2": 0.0, "K2mma": 0.0, "K2tf32": 0.0, "K6": 0.0}
    rows = {}

    # 6. K2 and K6 against their plain versions, at training shapes
    print("[6 training kernels vs plain] K2 fp32: dq, dk, dv within rtol 1e-4 + atol 1e-5 "
          "(summation order), dtable relative RMS < 1e-5 (fp32 atomics); bf16: relative "
          "RMS < 1e-2 for each (roundings of P and dS*scale may flip); d 16 and 32 take "
          "the tensor-core instances (bf16, and fp32 in 3xTF32), d 4 and 8 the CUDA-core "
          "one; K6 exact", flush=True)
    both = (torch.float32, torch.bfloat16)
    names = ("dq", "dk", "dv", "dtable")

    def bwd_reference(q, k, v, table, g, max_pos, chunk=404):
        """shaw_attention_bwd_reference over batch chunks (its fp32 logits
        of B'=3232 n=321 would take 5 GB a tensor); the table in fp32 (its
        values are the table's), so that the chunks' dtable sum in fp32."""
        parts = [fa.shaw_attention_bwd_reference(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk],
                                                 table.float(), g[i:i + chunk], max_pos)
                 for i in range(0, q.shape[0], chunk)]
        return (*(torch.cat([p[j] for p in parts]) for j in range(3)),
                sum(p[3] for p in parts).to(table.dtype))

    # B' = 808 n = 161: the time conformer of batch 8 x 1 s; B' = 3232
    # n = 321: 2 s at batch 32; n = 1281: the length at which the
    # JAX package took K3; max_pos_emb 8: clipped table rows; then the
    # other head dims K2 is built for, d=32 at n = 161 and at n = 1281
    # unclipped (the tensor-core pass A's largest band) included
    cuda_core_bwd_launches = fa.bwd_launches
    for b, n, max_pos, d, dtypes in ((808, 161, 512, 16, both),
                                     (3232, 321, 512, 16, both),
                                     (8, 1281, 512, 16, both), (3, 100, 8, 16, both),
                                     (8, 1281, 8, 16, both), (8, 1281, 8, 32, both),
                                     (6, 70, 512, 4, both), (6, 70, 512, 8, both),
                                     (6, 70, 512, 32, both), (3, 100, 8, 32, both),
                                     (6, 321, 512, 32, both), (808, 161, 512, 32, both),
                                     (8, 1281, 512, 32, both)):
        for dtype in dtypes:
            q, k, v, table = attention_operands(b, n, dtype, gen, d=d, max_pos=max_pos)
            g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, table)]
            out = fa.fused_shaw_attention(*leaves, max_pos)
            instance = fa.kernel_instance(dtype, d, "backward")
            counter = {"tensor_core": "bwd_mma_launches", "tensor_core_tf32": "bwd_tf32_launches",
                       "cuda_core": "bwd_launches"}[instance]
            launched = getattr(fa, counter)
            got = torch.autograd.grad(out, leaves, g)
            launched = getattr(fa, counter) - launched
            del leaves, out
            want = bwd_reference(q, k, v, table, g, max_pos)
            torch.cuda.synchronize()
            key = {"tensor_core": "K2mma", "tensor_core_tf32": "K2tf32", "cuda_core": "K2"}[instance]
            report = []
            ok = all(a.dtype == dtype and a.shape == w.shape for a, w in zip(got, want))
            for name, a, w in zip(names, got, want):
                err = float((a.float() - w.float()).abs().max())
                errs[key] = max(errs[key], err)
                rr = rel_rms_t(a, w)
                if dtype == torch.bfloat16:
                    ok = ok and rr < 1e-2
                elif name == "dtable":
                    ok = ok and rr < 1e-5
                else:
                    ok = ok and within(a, w, 1e-4, 1e-5)[1]
                report.append(f"{name} {err:.2e}/{rr:.1e}")
            check(ok and launched == 1,
                  f"K2 ({instance}) B'={b} n={n} h=4 d={d} max_pos_emb={max_pos} {dtype}: max "
                  f"abs err/relative RMS {', '.join(report)}")
            del q, k, v, table, g, got, want
        torch.cuda.empty_cache()
    cuda_core_bwd_launches = fa.bwd_launches - cuda_core_bwd_launches
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
    # each step's gradient norms (the generator's by leaf), losses and
    # self-correcting weights, so that a loss that does not fall shows
    # which step, leaf and weight took the large update
    seen = {dtype: read_grads(states[dtype].gen_opt, states[dtype].gen) for dtype in both}
    disc_seen = {dtype: read_grads(states[dtype].disc_opt, states[dtype].disc) for dtype in both}
    leaf_norms = {dtype: [] for dtype in both}
    disc_norms = {dtype: [] for dtype in both}
    weights = {dtype: [] for dtype in both}
    fa.launches = fa.mma_launches = fa.tf32_launches = 0
    fa.bwd_launches = fa.bwd_mma_launches = fa.bwd_tf32_launches = 0
    fr.launches = 0
    t0 = time.perf_counter()
    history = {dtype: [] for dtype in both}
    with sc_weight_trace() as sc:
        for dtype in both:
            for i, (clean, noisy) in enumerate((batches[0],) * 3 + (batches[1],)):
                # steps 0-2 on one repeated batch
                history[dtype].append(steps[dtype](states[dtype], clean, noisy, i))
                leaf_norms[dtype].append({n: g.double().norm() for n, g in seen[dtype].items()})
                disc_norms[dtype].append(torch.stack([g.double().norm()
                                                      for g in disc_seen[dtype].values()]).norm())
                weights[dtype].append(sc[-1])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"K1 tensor-core": fa.mma_launches, "K1 fp32 tensor-core": fa.tf32_launches,
                "K2 tensor-core": fa.bwd_mma_launches, "K2 fp32 tensor-core": fa.bwd_tf32_launches}
    cuda_core_fwd_launches, cuda_core_bwd_train = fa.launches, fa.bwd_launches
    print(f"[7 training path] make_fused_gan_train_step, TSCNet(64, 201, fused_attention=True) "
          f"+ Discriminator(16), scp, batch 8 x 16000, 4 steps each fp32 and bf16 in "
          f"{train_s:.2f} s (first calls included); launches {launches}; CUDA-core K1 "
          f"{cuda_core_fwd_launches}, CUDA-core K2 {cuda_core_bwd_train} (no training path has "
          f"d 4 or 8)", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} launched {n} times by the training path")
    for dtype in both:
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

    whole_step = {}  # (dtype, path): median whole-step ms
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

    # K1 at the training shape: both tensor-core instances (32 launches a
    # run), against SDPA with the bias as mask, as phase 5 at n = 321
    for dtype, key, label in ((torch.bfloat16, "K1mma", "K1 tensor-core"),
                              (torch.float32, "K1tf32", "K1 fp32 tensor-core (3xTF32)")):
        q, k, v, table = attention_operands(808, 161, dtype, gen)
        call, plain = time_pair(lambda: fa.fused_shaw_attention(q, k, v, table),
                                lambda: fa.shaw_attention_reference(q, k, v, table))
        bnd, nbytes = attention_bound(808, 161, dtype, tf32x3=dtype == torch.float32)
        dev = device_ms(lambda: fa.fused_shaw_attention(q, k, v, table))
        alone, chain = sdpa_yardstick(q, k, v, table)
        rows[key + "_n161"] = row(
            f"{label} B'=808 n=161 {dtype} (the training shape)", dev, call, plain, bnd, nbytes,
            alone, card, f"; SDPA with the bias built beforehand "
            f"{'n/a' if chain is None else f'{chain:.4f} ms'}",
            shape="B'=808 n=161 h=4 d=16", dtype=dtype)
        del q, k, v, table
        torch.cuda.empty_cache()

    # K2: both tensor-core instances at the training shape and at 2 s x
    # batch 32; the CUDA-core instance at d = 8, the head dim it keeps
    for b, n, dtype, d in ((808, 161, torch.bfloat16, 16), (3232, 321, torch.bfloat16, 16),
                           (808, 161, torch.float32, 16), (3232, 321, torch.float32, 16),
                           (808, 161, torch.float32, 8)):
        q, k, v, table = attention_operands(b, n, dtype, gen, d=d)
        g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        scale = d ** -0.5
        out, lse = fa.fused_shaw_attention_fwd(q, k, v, table, 512, scale, with_lse=True)
        kernel = lambda: fa.fused_shaw_attention_bwd(q, k, v, table, out, lse, g)  # noqa: E731
        call, plain = time_pair(kernel, lambda: fa.shaw_attention_bwd_reference(q, k, v, table, g),
                                warmup=1, reps=6)
        # eight n x n x d contractions (s, the bias, dP, dV, dQ and its
        # bias term, dK, dtable); q, k, v, out, g, lse in, dq, dk, dv out
        elem = torch.finfo(dtype).bits // 8
        nbytes = 8 * q.numel() * elem + lse.numel() * 4 + table.numel() * elem
        flops = 16.0 * b * 4 * n * n * d
        instance = fa.kernel_instance(dtype, d, "backward")
        # fp32: the 3xTF32 bound for the tensor-core instance, beside it the
        # 67 TFLOP/s CUDA-core one (and the other way round for CUDA cores)
        tf32_bnd = bound(flops, nbytes, dtype, tf32x3=True)
        fp32_bnd = bound(flops, nbytes, dtype)
        bnd = tf32_bnd if instance == "tensor_core_tf32" else fp32_bnd
        dev = device_ms(kernel)
        # the yardstick's backward: autograd through the Shaw-bias build and
        # scaled_dot_product_attention (K1's library call)
        import torch.nn.functional as F
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, table)]
        qt, kt, vt = (t.transpose(1, 2) for t in leaves[:3])
        bias = torch.einsum("bhid,ijd->bhij", qt,
                            leaves[3][fa.relative_index(n, 512, q.device)]) * scale
        y = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias).transpose(1, 2)
        lib = library(lambda: torch.autograd.grad(y, leaves, g, retain_graph=True))
        del leaves, qt, kt, vt, bias, y
        if dtype == torch.float32:
            other, other_name = ((fp32_bnd, "67 TFLOP/s fp32") if instance == "tensor_core_tf32"
                                 else (tf32_bnd, "3xTF32"))
            extra = (f"; {other_name} bound {other[0]:.4f} ms ({other[1]}; "
                     f"{100 * other[0] / dev:.1f}%)")
        else:
            extra = ""
        r = row(f"K2 {instance.replace('_', '-')} B'={b} n={n} d={d} {dtype}", dev, call, plain,
                bnd, nbytes, lib, card, "; library: autograd backward of the bias build and SDPA"
                + extra, shape=f"B'={b} n={n} h=4 d={d}", dtype=dtype)
        if dtype == torch.float32:
            r["bound_3xtf32_ms" if instance == "cuda_core" else "bound_fp32_cuda_core_ms"] = \
                other[0]
        key = {"tensor_core": "K2mma", "tensor_core_tf32": "K2tf32", "cuda_core": "K2"}[instance]
        if n == 321:
            rows[key]["n321"] = r
        else:
            rows[key] = r
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
                f"transpose().contiguous() {host['torch']:.1f} us; aim: {target}",
                shape=f"[B, F, T, C]={list(shape)}", dtype=torch.bfloat16)
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
    return {"launches": {**launches, "K6": k6_launches}, "errs": errs, "rows": rows,
            "cuda_core_fwd_launches": cuda_core_fwd_launches,
            "cuda_core_bwd_launches": cuda_core_bwd_train,
            "cuda_core_bwd_check_launches": cuda_core_bwd_launches}


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
    from speech_enhancement_tpu_torch.ops import fused_attention as fa
    from speech_enhancement_tpu_torch.ops import fused_stft as fs
    from speech_enhancement_tpu_torch.train import (
        create_gan_state,
        gan,
        l2_loss,
        make_fused_gan_train_step,
        run_gan_epoch,
    )
    from speech_enhancement_tpu_torch.train.loop import step_seed
    from speech_enhancement_tpu_torch.utils import load_variables

    t_phase = time.perf_counter()
    counters = {"K1 tensor-core": (fa, "mma_launches"), "K1 fp32 tensor-core": (fa, "tf32_launches"),
                "K2 tensor-core": (fa, "bwd_mma_launches"),
                "K2 fp32 tensor-core": (fa, "bwd_tf32_launches"), "K4": (fs, "stft_launches"),
                "K5": (fs, "istft_launches")}
    launches = dict.fromkeys(counters, 0)  # the CLI calls' own, summed
    last: dict = {}  # the latest CLI call's

    def run_cli(entry, args):
        """``entry(args)``; its launches, also when it raises, are put in
        ``last`` and added to ``launches``."""
        before = {k: getattr(module, name) for k, (module, name) in counters.items()}
        try:
            return entry(args)
        finally:
            for k, (module, name) in counters.items():
                last[k] = getattr(module, name) - before[k]
                launches[k] += last[k]

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_")
    root = tmp.name
    overlay = write_corpus(root, np.random.default_rng(SEED))
    print(f"[9 entry points] synthetic corpus of 48 + 6 pairs, 1.5-4 s, 0-15 dB SNR, batch 8 "
          f"x 1 s crops (6 steps an epoch); os.cpu_count() {os.cpu_count()}; timed runs and "
          f"inference at torch's fp32 flags as found (matmul {user_precision[0]!r}, cuDNN conv "
          f"{user_precision[1]!r}), the comparisons at 'ieee'; card {card}", flush=True)

    def cli_args(out, *extra):
        return ["-a", "scp", "--cfg", overlay, "--output", os.path.join(root, out), "--seed",
                "0", "--fused-attention", *extra]

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
            kernels = (("K1 tensor-core", "K2 tensor-core") if precision == "bf16"
                       else ("K1 fp32 tensor-core", "K2 fp32 tensor-core"))
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

    # the two-phase loop against make_fused_gan_train_step, fp32, step for
    # step, at lr 1e-3 (the CPU tests' rate).  The step labels its estimate
    # against the normalized audio, the loop against the batch's audio, as
    # in the JAX package (PESQ level-aligns both, up to rounding): here the
    # step's estimate is labelled against the batch's audio too, so that
    # both sides get the same labels.  Three runs of the step give the
    # card's own spread (K2's fp32 atomics, cuDNN's algorithm choice), the
    # largest gap between two of them.
    looped = run_gan_epoch(new_state(1e-3), batches, epoch=0, seed=0, criterion=l2_loss,
                           step_mode="two-phase")
    engine_labels = gan.host_pesq_labels

    def stepped_run():
        state, step, out = new_state(1e-3), make_fused_gan_train_step(criterion=l2_loss), []
        for i, batch in enumerate(batches):
            clean, noisy, q_clean, q_noisy = (torch.from_numpy(a).cuda() for a in batch)
            gan.host_pesq_labels = lambda ref, est, sr=SR: engine_labels(
                torch.from_numpy(batch.audio[:, :est.shape[1]]), est, sr)
            try:
                metrics = step(state, clean, noisy, step_seed(0, 0, i), q_clean, q_noisy)
            finally:
                gan.host_pesq_labels = engine_labels
            out.append({k: float(v) for k, v in metrics.items()})
        return out

    stepped = [stepped_run() for _ in range(3)]

    def worst(got, want):
        return max(abs(a / b - 1) for a, b in zip(got, want))

    for name, key, got in (("generator", "loss", looped.gen_losses),
                           ("discriminator", "disc_loss", looped.disc_losses)):
        runs = [[m[key] for m in run] for run in stepped]
        gap = worst(got, runs[0])
        spread = max(worst(runs[i], runs[j]) for i, j in ((1, 0), (2, 0), (2, 1)))
        bound = max(1e-4, 3 * spread)
        print(f"    info {name} losses by step, the loop / the step's second and third runs "
              f"against its first: "
              + ", ".join(f"{abs(a / w - 1):.1e}/{abs(b / w - 1):.1e}/{abs(c / w - 1):.1e}"
                          for a, w, b, c in zip(got, *runs)), flush=True)
        check(len(got) == 6 and gap <= bound,
              f"fp32 two-phase loop vs make_fused_gan_train_step, 6 steps at lr 1e-3, same "
              f"batches, weights and labels: {name} losses within rtol {gap:.2e} (bound "
              f"{bound:.2e}: 1e-4, or 3x the {spread:.2e} that three runs of the step part "
              f"by, the larger)")
    torch.cuda.empty_cache()

    # resume: 2 epochs straight through, then that run's epoch-1 checkpoint
    # alone in a new output directory, resumed with --resume auto for epoch
    # 2 (as a run killed after its first epoch is; fp32, pipelined, lr 1e-3
    # as above).  Both epoch 2s start from the same bits, so the first
    # epoch-2 loss (a forward pass: no atomics) must be equal; what follows
    # parts only by the card's nondeterminism within epoch 2 (K2's fp32
    # atomics, cuDNN's algorithm choice; the CPU test holds resume
    # bit-exact).
    _, straight = run_cli(main_gan.main, cli_args("straight", "--epochs", "2", "--lr", "1e-3"))
    first_epoch = os.path.join("scp", "default", "checkpoint_0000")
    shutil.copytree(os.path.join(root, "straight", first_epoch),
                    os.path.join(root, "resumed", first_epoch))
    (resumed,) = run_cli(main_gan.main, cli_args("resumed", "--epochs", "2", "--lr", "1e-3",
                                                 "--resume", "auto"))
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
          f"1e-3): epoch-2 generator losses within rtol {max(by_step):.2e} (bound 1e-3; by "
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
            k1 = last["K1 tensor-core"] if "bf16" in extra else last["K1 fp32 tensor-core"]
            check(all(np.isfinite(m).all() and len(m) == 6 for _, m in results) and k1 > 0
                  and last["K4"] > 0 and last["K5"] > 0 and len(results) == (2 if sweep else 1),
                  f"cli.inference_gan {' '.join(extra)}: six finite metrics "
                  f"{'; '.join(', '.join(f'{x:.3f}' for x in m) for _, m in results)}; "
                  f"launches K1 {k1}, K4 {last['K4']}, K5 {last['K5']}")

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
    path_launches = {"K4": 0, "K5": 0}

    def sampler(kind, schedule, plain):
        g = torch.Generator(device="cuda").manual_seed(SEED + 15)
        fn = sample_tsc if kind == "tsc-diffuse" else sample_waveform
        k4, k5 = fs.stft_launches, fs.istft_launches
        out, ms = event_ms(lambda: fn(models[kind], noisy2s, schedule, g, plain=plain))
        used = (fs.stft_launches - k4, fs.istft_launches - k5)
        if not plain:
            path_launches["K4"] += used[0]
            path_launches["K5"] += used[1]
        return out, ms, used

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
            k4, k5 = fs.stft_launches, fs.istft_launches
            t0 = time.perf_counter()
            results = inference_diffuse.main(["-a", arch, "--cfg", overlay, "--fast", "-m",
                                              os.path.join(out, arch, "default"), "-o",
                                              os.path.join(root, f"enhanced_{arch}"),
                                              "--validate-epochs"])
            infer_s = time.perf_counter() - t0
            used = (fs.stft_launches - k4, fs.istft_launches - k5)
            path_launches["K4"] += used[0]
            path_launches["K5"] += used[1]
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
    k4_path = 0  # K4 launches of the cdiffuse_inference CLI calls
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

    def infer(model_dir, *extra):
        """cdiffuse_inference.main on the test wavs: (results, seconds, K4
        launches of the call)."""
        k4 = fs.stft_launches
        t0 = time.perf_counter()
        out = cdiffuse_inference.main(["--model-dir", model_dir, "--noisy", test_dir, "-o",
                                       os.path.join(root, "enhanced"), *extra])
        return out, time.perf_counter() - t0, fs.stft_launches - k4

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
            k4_path += k4
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
            k4 = fs.stft_launches
            outs.append(cdiffuse_inference.predict(x, weights_dir, fast=True, noises=noises,
                                                   plain=plain))
            used[plain].append(fs.stft_launches - k4)
        errs.append(rel_rms(*outs))
    n = len(noisy_test)
    check(max(errs) <= 1e-4 and used == {False: [1] * n, True: [0] * n},
          f"cdiffuse_inference.predict, kernel route (K4) vs plain route (ops/stft.py), fast "
          f"schedule, the same draws, {n} utterances: relative RMS at most {max(errs):.2e} "
          f"(bound 1e-4); K4 launches {used[False]} and {used[True]} (plain)")
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
        k4_before = fs.stft_launches
        torch.cuda.synchronize()
        with trace(os.path.join(root, "trace_reverse")) as prof:
            t0 = time.perf_counter()
            cdiffuse_inference.predict(x4, weights_dir, fast=True)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        k4_launched = fs.stft_launches - k4_before
    kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    device = sum(kernels.values())
    k4_profiled = sum(v for k, v in kernels.items()
                      if "stft_kernel" in k and "istft_kernel" not in k)
    # K4 at this call's shape by CUDA events (device_ms): in this process
    # the profiler has listed no K4 entry though K4 launched (PERF.md §7)
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
                results, secs, k4 = infer(out, "--fast", "--conditioner", mode)
                stft_route = route.startswith("stft")
                if mode == "auto":
                    k4_path += k4
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
          f"CLI calls {k4_path}", flush=True)
    return {"launches": {"K4": k4_path}, "timings": timings}


# --------------------------------------------------------------------------
# phase 12: int8 serving convolutions and data parallelism on the one card

DP_ROWS = 8  # the global batch of the data-parallel checks: 8 x 1 s


def kernel_counts() -> dict:
    """The launch counters of K1, K2, K4 and K5 and of the int8 GEMMs."""
    from speech_enhancement_tpu_torch.ops import fused_attention as fa
    from speech_enhancement_tpu_torch.ops import fused_stft as fs
    from speech_enhancement_tpu_torch.ops import int8

    return {"K1 tensor-core": fa.mma_launches, "K1 fp32 tensor-core": fa.tf32_launches,
            "K2 tensor-core": fa.bwd_mma_launches, "K2 fp32 tensor-core": fa.bwd_tf32_launches,
            "K4": fs.stft_launches, "K5": fs.istft_launches,
            "int8 GEMM": int8.LAUNCHES["int8_conv2d"]}


def counts_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernel_counts().items()}


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
    for name in ("K1 tensor-core", "K1 fp32 tensor-core", "K4", "K5", "int8 GEMM"):
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
    for name in ("K1 fp32 tensor-core", "K2 fp32 tensor-core"):
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
        for name in ("K1 fp32 tensor-core", "K4", "K5"):
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
              fa.build_bwd_tf32, fr.build, pesq.build)
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
            ("stft", ["11stft_kernel", "12istft_kernel"], "K4 and K5")):  # mangled lengths
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

    # 3. kernels against their plain versions, main-path shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"K1": 0.0, "K1mma": 0.0, "K1tf32": 0.0, "K4": 0.0, "K5": 0.0}
    print("[3 kernels vs plain] tolerance |kernel - plain| <= atol + rtol |plain|", flush=True)
    # K1: fp32 differs in summation order only (rtol 1e-4, atol 1e-5, as
    # tests/test_pallas_attention.py); bf16 may flip a rounding of P or of
    # the output, one bf16 step of order-1 values (rtol 2e-2, atol 2e-2)
    tols = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
    # main-path shapes (2 s at batch 32 is B' = 3232 n = 321, whole; 8 s a
    # slice of B' = 3232 n = 1281, clipping on), then short, full-tile and
    # clipped edge cases (max_pos_emb 8) and the other head dims; d 16 and
    # 32 take the tensor-core instances (bf16 and fp32 in 3xTF32), d 4 and
    # 8 the CUDA-core one (B' = 3232 n = 321 d = 8 fp32: its timed shape)
    both, fp32 = (torch.float32, torch.bfloat16), (torch.float32,)
    cuda_core_launches = fa.launches
    for b, n, max_pos, d, dtypes in ((3232, 321, 512, 16, both), (3232, 321, 512, 32, fp32),
                                     (8, 1281, 512, 16, both), (5, 7, 512, 16, both),
                                     (3, 100, 8, 16, both), (2, 64, 512, 16, both),
                                     (8, 1281, 8, 16, both), (6, 321, 512, 32, both),
                                     (4, 1281, 512, 32, both), (5, 7, 512, 32, both),
                                     (3, 100, 8, 32, both), (6, 70, 512, 4, both),
                                     (6, 70, 512, 8, both), (3232, 321, 512, 8, fp32)):
        for dtype in dtypes:
            q, k, v, table = attention_operands(b, n, dtype, gen, d=d, max_pos=max_pos)
            instance = fa.kernel_instance(dtype, d)
            got, lse = fa.fused_shaw_attention_fwd(q, k, v, table, max_pos, d ** -0.5,
                                                   with_lse=True)
            # the row log-sum-exp K2 reads: fp32 sums of the same logits in
            # another order (atol 1e-4 on values of order 10)
            want, lse_want = attention_reference(q, k, v, table, max_pos)
            lse_err = float((lse - lse_want).abs().max())
            torch.cuda.synchronize()
            err, ok = within(got, want, *tols[dtype])
            key = {"tensor_core": "K1mma", "tensor_core_tf32": "K1tf32",
                   "cuda_core": "K1"}[instance]
            errs[key] = max(errs[key], err)
            check(ok and lse_err < 1e-4 and got.dtype == dtype and got.shape == want.shape,
                  f"K1 ({instance}) B'={b} n={n} h=4 d={d} max_pos_emb={max_pos} {dtype}: "
                  f"max abs err {err:.3e} (rtol {tols[dtype][0]}, atol {tols[dtype][1]}); "
                  f"lse max abs err {lse_err:.2e} (atol 1e-4)")
            del q, k, v, table, got, lse, want, lse_want
        torch.cuda.empty_cache()
    cuda_core_launches = fa.launches - cuda_core_launches
    # K4: 3xTF32 sums (about fp32) in another order; compression amplifies
    # the error of near-empty bins (rtol 1e-4, atol 2e-4, as
    # tests/test_pallas_stft.py); the main path's geometry, then n_fft 300,
    # hop 75 (K padded 151 -> 152, a ragged last frame tile)
    for shape, n_fft, hop in (((32, 32000), 400, 100), ((8, 24037), 300, 75)):
        x = torch.randn(*shape, device="cuda", generator=gen)  # RMS 1, as normalized audio
        spec = fs.fused_stft(x, n_fft, hop)
        spec_ref = fs.stft_reference(x, n_fft, hop)
        torch.cuda.synchronize()
        err, ok = within(torch.view_as_real(spec), torch.view_as_real(spec_ref), 1e-4, 2e-4)
        errs["K4"] = max(errs["K4"], err)
        check(ok and spec.shape == spec_ref.shape == (shape[0], 1 + shape[1] // hop,
                                                      n_fft // 2 + 1),
              f"K4 stft+compress {list(shape)} n_fft {n_fft} hop {hop} fp32: max abs err "
              f"{err:.3e} (rtol 1e-4, atol 2e-4)")
    # K5: 3xTF32 sums (about fp32) of 201 products of order-1 values in
    # another order; the main path's geometry, then n_fft 300, hop 75 (K
    # padded 151 -> 152, 151 of 208 n columns); 31963 and 23911 cut inside
    # a hop block
    for shape, n_fft, hop, lengths in (((32, 32000), 400, 100, (32000, 31963)),
                                       ((8, 24037), 300, 75, (24000, 23911))):
        x = torch.randn(*shape, device="cuda", generator=gen)
        spec_ref = fs.stft_reference(x, n_fft, hop)
        for length in lengths:
            wav = fs.fused_istft(spec_ref, n_fft, hop, length=length)
            wav_ref = fs.istft_reference(spec_ref, n_fft, hop, length=length)
            torch.cuda.synchronize()
            err, ok = within(wav, wav_ref, 1e-4, 1e-4)
            errs["K5"] = max(errs["K5"], err)
            check(ok and wav.shape == wav_ref.shape == (shape[0], length),
                  f"K5 uncompress+istft {list(spec_ref.shape)} n_fft {n_fft} hop {hop} length "
                  f"{length} fp32: max abs err {err:.3e} (rtol 1e-4, atol 1e-4)")
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

    fa.launches = fa.mma_launches = fa.tf32_launches = fs.stft_launches = fs.istft_launches = 0
    t0 = time.perf_counter()
    out = {"kernel bf16": kernel_bf16.enhance(utts, batch_size=8),
           "kernel fp32": kernel_fp32.enhance(utts, batch_size=8),
           "kernel fp32 default (TF32)": kernel_tf32.enhance(utts, batch_size=8)}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"K1 tensor-core": fa.mma_launches, "K1 fp32 tensor-core": fa.tf32_launches,
                "K4": fs.stft_launches, "K5": fs.istft_launches}
    main_cuda_core = fa.launches
    print(f"[4 main path] 12 utterances {min(lengths)}-{max(lengths)} samples, batch 8, "
          f"bf16 + fp32 (matmul_precision None and the default) kernel path in {main_s:.2f} s "
          f"(first calls included); launches {launches}; CUDA-core K1 {fa.launches} (no main "
          f"path has d 4 or 8)", flush=True)
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
    print(f"    enhance_batch [32, 32000] fp32, matmul_precision=None: kernel path "
          f"{kernel_ms32:.3f} ms, plain path {plain_ms32:.3f} ms ({card})", flush=True)
    tf32_ms, ieee_ms = time_pair(lambda: kernel_tf32.enhance_batch(batch),
                                 lambda: kernel_fp32.enhance_batch(batch), reps=6)
    print(f"    enhance_batch [32, 32000] fp32 kernel path, in turns: matmul_precision "
          f"\"bfloat16\" (the default; TF32 matmuls and convolutions) {tf32_ms:.3f} ms, None "
          f"(full fp32) {ieee_ms:.3f} ms ({card})", flush=True)
    from torch.profiler import ProfilerActivity, profile
    for label, enhancer in (("bf16", kernel_bf16), ("fp32", kernel_fp32),
                            ("fp32 default (TF32)", kernel_tf32)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            enhancer.enhance_batch(batch)
        kernel_us = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        total_ms = sum(us for _, us in kernel_us) / 1e3
        k1_ms = sum(us for key, us in kernel_us if "shaw_attention" in key) / 1e3
        print(f"    torch.profiler, one enhance_batch [32, 32000] {label}, kernel path: "
              f"{total_ms:.3f} ms of device kernel time, K1 {k1_ms:.3f} ms "
              f"({100 * k1_ms / total_ms:.1f}%) ({card})", flush=True)
        busiest = sorted(kernel_us, key=lambda e: -e[1])[:6]
        print("    info busiest kernels: " + "; ".join(f"{us / 1e3:.3f} ms {key[:60]}"
                                                   for key, us in busiest), flush=True)
    del kernel_bf16, kernel_fp32, kernel_tf32, plain_bf16, plain_fp32, prof
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
                        f"{'n/a' if chain is None else f'{chain:.4f} ms'}",
                        shape="B'=3232 n=321 h=4 d=16", dtype=torch.bfloat16)
    rows["K1mma"]["library_chain_ms"] = chain
    del q, k, v, table
    torch.cuda.empty_cache()
    q, k, v, table = attention_operands(3232, 1281, torch.bfloat16, gen)
    call, plain = time_pair(lambda: fa.fused_shaw_attention(q, k, v, table),
                            lambda: chunked(fa.shaw_attention_reference, 202, q, k, v, table),
                            warmup=1, reps=2)
    bnd, nbytes = attention_bound(3232, 1281, torch.bfloat16)
    dev = device_ms(lambda: fa.fused_shaw_attention(q, k, v, table))
    # SDPA's bias would take 26 GB whole: its yardstick is 8 chunks of
    # B' = 404 (a 5.3 GB bias each, built beforehand), one chunk timed, x 8
    chunk_ms, _ = sdpa_yardstick(q[:404], k[:404], v[:404], table)
    lib_long = None if chunk_ms is None else 8 * chunk_ms
    long = row("K1 tensor-core B'=3232 n=1281 bf16 (8 s at batch 32)", dev, call,
               plain, bnd, nbytes, lib_long, card, "; plain in 16 chunks of 202; library: "
               "SDPA with the bias, 8 chunks of B'=404, one timed x 8",
               shape="B'=3232 n=1281 h=4 d=16", dtype=torch.bfloat16)
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
    # fp32: the 3xTF32 tensor-core instance at the serving shape, held to
    # three TF32 products per fp32 product (beside it the 67 TFLOP/s fp32
    # bound), and the CUDA-core instance at d = 8, the head dim it keeps
    for d, key, label in ((16, "K1tf32", "K1 fp32 tensor-core (3xTF32)"),
                          (8, "K1", "K1 CUDA-core")):
        q, k, v, table = attention_operands(3232, 321, torch.float32, gen, d=d)
        call, plain = time_pair(lambda: fa.fused_shaw_attention(q, k, v, table),
                                lambda: fa.shaw_attention_reference(q, k, v, table))
        fp32_bnd, nbytes = attention_bound(3232, 321, torch.float32, d=d)
        tf32_bnd, _ = attention_bound(3232, 321, torch.float32, d=d, tf32x3=True)
        bnd, other, other_name = ((tf32_bnd, fp32_bnd, "67 TFLOP/s fp32") if key == "K1tf32"
                                  else (fp32_bnd, tf32_bnd, "3xTF32"))
        dev = device_ms(lambda: fa.fused_shaw_attention(q, k, v, table))
        rows[key] = row(f"{label} B'=3232 n=321 d={d} fp32", dev, call, plain, bnd, nbytes,
                        sdpa_yardstick(q, k, v, table)[0], card,
                        f"; {other_name} bound {other[0]:.4f} ms ({other[1]}; "
                        f"{100 * other[0] / dev:.1f}%)",
                        shape=f"B'=3232 n=321 h=4 d={d}", dtype=torch.float32)
        rows[key]["bound_3xtf32_ms" if key == "K1" else "bound_fp32_cuda_core_ms"] = other[0]
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
    # K4 and K5 against their library calls in turns (5 rounds of kernel
    # then library, or library then kernel, device_ms each); the rows carry
    # the medians
    pairs = {
        "K4": (lambda: fs.fused_stft(x), lambda: fs._gated_rescale(torch.stft(
            x, 400, 100, window=window, return_complex=True).transpose(1, 2), -0.35),
            lambda: fs.stft_reference(x), "K4 stft+compress [32, 32000] fp32",
            "torch.stft, then the compression", "[32, 32000] n_fft=400 hop=100"),
        "K5": (lambda: fs.fused_istft(spec, length=32000), lambda: torch.istft(
            fs._gated_rescale(spec, (1.0 / 0.3 - 1.0) / 2.0).transpose(1, 2), 400, 100,
            window=window, length=32000), lambda: fs.istft_reference(spec, length=32000),
            "K5 uncompress+istft [32, 321, 201] fp32", "the uncompression, then torch.istft",
            "[32, 321, 201] n_fft=400 hop=100"),
    }
    for key, (kernel_fn, library_fn, plain_fn, label, lib_label, shape) in pairs.items():
        call, plain = time_pair(kernel_fn, plain_fn)
        kern, lib, ratios = in_turns(kernel_fn, library_fn)
        kern_med, lib_med = statistics.median(kern), statistics.median(lib)
        verdict = "wins" if kern_med < lib_med else "loses"
        rows[key] = row(label, kern_med, call, plain, bound(fft_flops, stft_bytes, torch.float32),
                        stft_bytes, lib_med, card,
                        f"; library: {lib_label}; in turns, 5 rounds: kernel "
                        f"{', '.join(f'{m:.4f}' for m in kern)} ms, library "
                        f"{', '.join(f'{m:.4f}' for m in lib)} ms, library/kernel "
                        f"{', '.join(f'{r:.2f}' for r in ratios)}: the kernel {verdict}",
                        shape=shape, dtype=torch.float32)
        rows[key]["in_turns"] = {"kernel_ms": kern, "library_ms": lib}
        if key == "K4":
            check(kern_med <= lib_med, f"K4 device time {kern_med:.4f} ms no higher than "
                                       f"{lib_label} {lib_med:.4f} ms (medians in turns)")
    del x, spec
    torch.cuda.empty_cache()

    # 6-8. the training path
    train = training_phases(card, gen)
    # 9. the entry points a user runs
    entry = entry_point_phase(card, user_precision)
    # 10. the diffusion families
    diffusion = diffusion_phase(card, user_precision)
    # 11. standalone CDiffuSE
    cdiffuse = cdiffuse_phase(card, user_precision)
    # 12. int8 serving convolutions; data parallelism on the one card
    int8_t = int8_phase(card)
    parallel_t = parallel_phase(card, user_precision)
    print(f"[done] {time.perf_counter() - started:.1f} s, build included", flush=True)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    pkg = "speech_enhancement_tpu_torch"
    tl, el = train["launches"], entry["launches"]

    def by_path(serving, training, entry_points, diffusion=None, cdiffuse=None, name=None):
        paths = {"serving (phase 4)": serving, "training (phase 7)": training,
                 "entry points (phase 9)": entry_points}
        if diffusion is not None:
            paths["diffusion (phase 10)"] = diffusion
        if cdiffuse is not None:
            paths["cdiffuse (phase 11)"] = cdiffuse
        if name is not None:  # phase 12's paths
            paths["int8 serving (phase 12)"] = int8_t["launches"][name]
            paths["data parallel (phase 12)"] = parallel_t["launches"][name]
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    rows["K1mma"]["n161"] = train["rows"]["K1mma_n161"]
    rows["K1tf32"]["n161"] = train["rows"]["K1tf32_n161"]
    kernels = [
        {"name": "shaw_attention_fwd_tensor_core", "route": "cuda",
         "source": f"{pkg}/csrc/shaw_attention_mma.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_attention.py:201",
         **by_path(launches["K1 tensor-core"], tl["K1 tensor-core"], el["K1 tensor-core"],
                   name="K1 tensor-core"),
         "max_abs_err": errs["K1mma"], **rows["K1mma"]},
        {"name": "shaw_attention_fwd_tf32", "route": "cuda",
         "source": f"{pkg}/csrc/shaw_attention_tf32.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_attention.py:201",
         **by_path(launches["K1 fp32 tensor-core"], tl["K1 fp32 tensor-core"],
                   el["K1 fp32 tensor-core"], name="K1 fp32 tensor-core"),
         "max_abs_err": errs["K1tf32"], **rows["K1tf32"]},
        {"name": "shaw_attention_fwd_cuda_core", "route": "cuda",
         "source": f"{pkg}/csrc/shaw_attention.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_attention.py:201",
         "launches": main_cuda_core + train["cuda_core_fwd_launches"],
         "check_launches": cuda_core_launches,
         "check_launches_from": "phase-3 checks at head dims 4 and 8: no main path reaches it",
         "max_abs_err": errs["K1"], **rows["K1"]},
        {"name": "shaw_attention_bwd_tensor_core", "route": "cuda",
         "source": f"{pkg}/csrc/shaw_attention_bwd_mma.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_attention.py:533 and :616",
         **by_path(0, tl["K2 tensor-core"], el["K2 tensor-core"], name="K2 tensor-core"),
         "max_abs_err": train["errs"]["K2mma"],
         **train["rows"]["K2mma"]},
        {"name": "shaw_attention_bwd_tf32", "route": "cuda",
         "source": f"{pkg}/csrc/shaw_attention_bwd_tf32.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_attention.py:533 and :616",
         **by_path(0, tl["K2 fp32 tensor-core"], el["K2 fp32 tensor-core"],
                   name="K2 fp32 tensor-core"),
         "max_abs_err": train["errs"]["K2tf32"],
         **train["rows"]["K2tf32"]},
        {"name": "shaw_attention_bwd_cuda_core", "route": "cuda",
         "source": f"{pkg}/csrc/shaw_attention_bwd.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_attention.py:533 and :616",
         "launches": train["cuda_core_bwd_launches"],
         "check_launches": train["cuda_core_bwd_check_launches"],
         "check_launches_from": "phase-6 checks at head dims 4 and 8: no main path reaches it",
         "max_abs_err": train["errs"]["K2"], **train["rows"]["K2"]},
        {"name": "stft_compress", "route": "cuda", "source": f"{pkg}/csrc/stft.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_stft.py:74",
         **by_path(launches["K4"], 0, el["K4"], diffusion["launches"]["K4"],
                   cdiffuse["launches"]["K4"], name="K4"),
         "max_abs_err": errs["K4"], **rows["K4"]},
        {"name": "uncompress_istft", "route": "cuda", "source": f"{pkg}/csrc/stft.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_stft.py:157",
         **by_path(launches["K5"], 0, el["K5"], diffusion["launches"]["K5"], name="K5"),
         "max_abs_err": errs["K5"], **rows["K5"]},
        {"name": "swap_seq_axes", "route": "cuda", "source": f"{pkg}/csrc/relayout.cu",
         "replaces": "speech_enhancement_tpu/ops/pallas_relayout.py:48",
         "launches": tl["K6"], "max_abs_err": train["errs"]["K6"], **train["rows"]["K6"]},
    ]
    print(json.dumps({"entry_point_timings": entry["timings"]}))
    print(json.dumps({"diffusion_timings": diffusion["timings"]}))
    print(json.dumps({"cdiffuse_timings": cdiffuse["timings"]}))
    print(json.dumps({"int8_timings": int8_t}))
    print(json.dumps({"parallel_timings": parallel_t}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
