"""The SCP-GAN / CMGAN training epoch with its four step modes (the body of
speech_enhancement_tpu/cli/main_gan.py:348-460 as a library function).

:func:`run_gan_epoch` takes any iterable of host batches (``audio``,
``noisy``, ``pesq_clean``, ``pesq_noisy``: ``data.Collator(...,
precompute_labels=True)`` makes them), so that it needs neither the data
pipeline nor a CLI.  A step computes the PESQ label of its estimate only;
the clean and noisy labels come with the batch.  The step modes:

* ``two-phase``: generator step, the estimate's labels on the host, then
  the discriminator step, one after the other (discriminator lag 0);
* ``async`` / ``pipelined``: the labels are computed on a thread of
  ``label_pool`` while the loop goes on, and each discriminator update is
  deferred by 1 / 2 steps (the lag): it runs on the *current* state with
  the generator outputs (``GenAux``) and labels of the step 1 / 2 earlier.
  The queue is flushed at the end of the epoch, so every batch's update is
  applied exactly once;
* ``fused``: ``make_fused_gan_train_step`` (generator step, labels,
  discriminator step in one call; lag 0).

The estimate leaves the card by a copy into pinned host memory queued
right after its generator step, behind a CUDA event; the label thread
waits on that event alone, not on the steps queued after it, and the
labels go back to the card when their update is applied.  Step ``idx`` of
epoch ``epoch`` takes its dropout seeds from ``(seed, epoch, idx)`` only,
so that a resumed run replays the stream of a run straight through.

Data parallel: every rank runs this loop over its own shard of the
batches, in lockstep.  The deferred updates keep their fixed lag, so that
every rank issues its collectives in the same order; a batch whose rows
differ between the ranks is skipped by all of them, and a stop that
``on_step`` asks for on any rank stops every rank at the same step.  Each
step reads its generator loss back to the host (the per-step meter
update), as the JAX loop does.

Under a profiler session (``utils.profiling``) each step's body is a span
``se.train.step`` (its id ``(epoch, idx)``, ending before ``on_step``),
holding ``se.train.h2d`` (the batch to the card), ``se.train.label_wait``
(its length is what ``EpochStats.label_wait`` adds), ``se.train.disc_step``
(one discriminator update) and ``se.train.sync`` (each loss read back to
the host); a label job is a span ``se.train.labels`` on its thread, its
id the step whose estimate it scores.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from concurrent.futures import Executor, ThreadPoolExecutor
from typing import Callable, Iterable

import numpy as np
import torch

from speech_enhancement_tpu_torch.metrics.pesq import batch_pesq_raw
from speech_enhancement_tpu_torch.parallel.mesh import any_rank, same_on_all_ranks
from speech_enhancement_tpu_torch.train.gan import (
    LOSS_WEIGHTS,
    gan_discriminator_step,
    gan_generator_step,
    make_fused_gan_train_step,
    phase_seeds,
)
from speech_enhancement_tpu_torch.train.state import GanTrainState
from speech_enhancement_tpu_torch.utils.logging import AverageMeter
from speech_enhancement_tpu_torch.utils.profiling import span, timed_span

# step mode -> discriminator lag (steps by which its update is deferred)
DISC_LAG = {"two-phase": 0, "async": 1, "pipelined": 2, "fused": 0}


@dataclasses.dataclass
class EpochStats:
    """What one epoch did: the meters, each generator step's loss, each
    applied discriminator update's loss (in the order applied), the number
    of generator steps with the GAN term (each owes one discriminator
    update), and the seconds the loop waited for estimate labels (at lag
    0 that includes the wait for the estimate to reach the host)."""

    gen: AverageMeter = dataclasses.field(default_factory=AverageMeter)
    disc: AverageMeter = dataclasses.field(default_factory=AverageMeter)
    batch_time: AverageMeter = dataclasses.field(default_factory=AverageMeter)
    gen_losses: list = dataclasses.field(default_factory=list)
    disc_losses: list = dataclasses.field(default_factory=list)
    gan_steps: int = 0
    label_wait: float = 0.0
    stopped: bool = False


def step_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of step ``index`` of ``epoch``: a function of the three."""
    return int(np.random.SeedSequence((seed, epoch, index)).generate_state(1)[0])


def queue_host_copy(est: torch.Tensor):
    """``(host, done)``: for a CUDA tensor, a pinned host tensor that a copy
    queued now (behind the work queued so far) fills, and a CUDA event
    recorded after the copy; for a CPU tensor, ``(est, None)``."""
    est = est.detach()
    if est.device.type != "cuda":
        return est, None
    host = torch.empty(est.shape, dtype=est.dtype, pin_memory=True)
    host.copy_(est, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def estimate_labels(clean: np.ndarray, est_host: torch.Tensor, done=None,
                    sample_rate: int = 16000, step=None) -> torch.Tensor:
    """Normalized PESQ labels ``(pesq(clean, est) - 1) / 3.5`` (CPU float32)
    of a :func:`queue_host_copy` result, once its event ``done`` has
    passed; ``clean`` is cut to the estimate's length.  ``step`` is the id
    of its span ``se.train.labels``."""
    with span("se.train.labels", step):
        if done is not None:
            done.synchronize()
        est = est_host.float().numpy()
        scores = batch_pesq_raw(clean[:, :est.shape[1]], est, sample_rate)
        return torch.from_numpy(((scores - 1.0) / 3.5).astype(np.float32))


def _synced(loss: torch.Tensor) -> float:
    """``float(loss)``: the host waits for the device (span
    ``se.train.sync``)."""
    with span("se.train.sync"):
        return float(loss)


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def run_gan_epoch(state: GanTrainState, batches: Iterable, *, epoch: int, seed: int,
                  criterion: Callable, step_mode: str = "pipelined", arch: str = "scp",
                  comp_type: str = "pow", n_fft: int = 400, hop: int = 100,
                  gan_active: bool = True, loss_weights: tuple = LOSS_WEIGHTS,
                  compute_dtype: torch.dtype | None = None, sample_rate: int = 16000,
                  label_pool: Executor | None = None,
                  on_step: Callable[[int, EpochStats], bool] | None = None) -> EpochStats:
    """One training epoch over ``batches`` on the device of ``state``'s
    generator, in ``step_mode`` (:data:`DISC_LAG`).  Empty batches are
    skipped.  ``label_pool`` runs the deferred modes' label jobs (one of
    ``DISC_LAG[step_mode]`` threads is made for the epoch when None).
    ``on_step(idx, stats)`` is called after each step; when it returns
    True the epoch stops at once (``stats.stopped``), the deferred updates
    left unapplied, as the JAX loop returns on preemption."""
    if step_mode not in DISC_LAG:
        raise ValueError(f"step_mode {step_mode!r} is not one of {list(DISC_LAG)}")
    lag = DISC_LAG[step_mode]
    device = next(state.gen.parameters()).device
    step_kw = dict(criterion=criterion, arch=arch, comp_type=comp_type, n_fft=n_fft, hop=hop,
                   gan_active=gan_active, loss_weights=loss_weights,
                   compute_dtype=compute_dtype)
    fused = make_fused_gan_train_step(sample_rate=sample_rate, **step_kw)
    stats = EpochStats()
    # deferred updates: (aux, label future, q_clean, q_noisy, disc seed, rows)
    pending: deque = deque()
    own_pool = label_pool is None and lag > 0
    pool = ThreadPoolExecutor(max_workers=lag) if own_pool else label_pool

    def discriminator_update(aux, q_est, q_clean, q_noisy, disc_seed, b):
        with span("se.train.disc_step"):
            loss = gan_discriminator_step(state, aux, q_est.to(device), q_clean, q_noisy,
                                          disc_seed, criterion=criterion, arch=arch)
            stats.disc_losses.append(_synced(loss))
            stats.disc.update(stats.disc_losses[-1], b)

    def wait_for_labels(job):
        with timed_span("se.train.label_wait") as waited:
            q_est = job()
        stats.label_wait += waited.seconds
        return q_est

    def apply_oldest():
        aux, future, q_clean, q_noisy, disc_seed, b = pending.popleft()
        q_est = wait_for_labels(future.result)
        discriminator_update(aux, q_est, q_clean, q_noisy, disc_seed, b)

    try:
        t_end = time.perf_counter()
        for idx, batch in enumerate(batches):
            b = batch.audio.shape[0]
            # a batch whose rows differ between the ranks (a ragged tail) is
            # skipped by every rank, as the JAX loop skips a batch that does
            # not divide over its mesh
            if not same_on_all_ranks(b) or b == 0:
                continue
            if batch.pesq_clean is None or batch.pesq_noisy is None:
                raise ValueError("a batch without precomputed clean and noisy PESQ labels "
                                 "(Collator(precompute_labels=True) makes them)")
            with span("se.train.step", (epoch, idx)):
                with span("se.train.h2d"):
                    clean, noisy, q_clean, q_noisy = (_to_device(a, device) for a in batch)
                seed_step = step_seed(seed, epoch, idx)
                # the oldest deferred update, once the queue is full: its
                # labels were computed while newer generator steps ran
                if len(pending) >= lag > 0:
                    apply_oldest()
                if step_mode == "fused":
                    metrics = fused(state, clean, noisy, seed_step, q_clean, q_noisy)
                    loss = _synced(metrics["loss"])
                    if gan_active:
                        stats.gan_steps += 1
                        stats.disc_losses.append(_synced(metrics["disc_loss"]))
                        stats.disc.update(stats.disc_losses[-1], b)
                else:
                    seed_gen, seed_disc = phase_seeds(seed_step)
                    aux = gan_generator_step(state, clean, noisy, seed_gen, **step_kw)
                    if gan_active:
                        stats.gan_steps += 1
                        job = functools.partial(estimate_labels, batch.audio,
                                                *queue_host_copy(aux.est_audio), sample_rate,
                                                step=(epoch, idx))
                        if lag:
                            future = pool.submit(job)
                            pending.append((aux, future, q_clean, q_noisy, seed_disc, b))
                        else:
                            q_est = wait_for_labels(job)
                            discriminator_update(aux, q_est, q_clean, q_noisy, seed_disc, b)
                    loss = _synced(aux.metrics["loss"])
                stats.gen_losses.append(loss)
                stats.gen.update(loss, b)
                stats.batch_time.update(time.perf_counter() - t_end)
            t_end = time.perf_counter()
            # one decision for every rank: a rank that stopped alone would
            # leave the others waiting in a collective
            if on_step is not None and any_rank(on_step(idx, stats)):
                stats.stopped = True
                return stats
        # the trailing deferred updates: every batch's applied exactly once
        while pending:
            apply_oldest()
        return stats
    finally:
        if own_pool:
            pool.shutdown(wait=True, cancel_futures=True)
