"""The port's training epoch (speech_enhancement_tpu_torch/train/loop.py) on
the CPU, at the JAX training tests' sizes (TSCNet(8, 201),
Discriminator(ndf=4), batches of 2 x 4000; tests/torch_train_common.py):

* at discriminator lag 0 (two-phase) the loop equals
  ``make_fused_gan_train_step`` step for step, given each step's seed and
  the batch's labels, and the loop's ``fused`` mode equals both;
* at lags 1 and 2 (async, pipelined) each discriminator update runs on the
  current state with the ``GenAux`` of 1 or 2 steps earlier: against a
  replay of the JAX CLI's queue in tests/test_torch_loop_jax.py;
* the end-of-epoch flush applies every deferred update exactly once, and
  an ``on_step`` that stops the epoch leaves the queue unapplied;
* the pinned-copy label path (``queue_host_copy``, ``estimate_labels``)
  gives the labels of ``host_pesq_labels``.
"""

import numpy as np
import pytest
import torch
from torch_train_common import B, L

from speech_enhancement_tpu_torch.data import Batch
from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
from speech_enhancement_tpu_torch.train import (
    create_gan_state,
    l2_loss,
    make_fused_gan_train_step,
    run_gan_epoch,
)
from speech_enhancement_tpu_torch.train import gan as gan_module
from speech_enhancement_tpu_torch.train import loop as port_loop
from speech_enhancement_tpu_torch.train.gan import host_pesq_labels

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

STEPS = 4


def tone_batches(n=STEPS, seed=0):
    """Tone-plus-noise batches (voiced energy for PESQ), one pitch per step,
    with stand-in clean and noisy labels."""
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    out = []
    for i in range(n):
        envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)
        tone = 0.3 * np.sin(2 * np.pi * (180 + 25 * i) * t) * envelope
        clean = np.stack([tone * (1.0 + 0.1 * j) for j in range(B)]).astype(np.float32)
        noisy = (clean + 0.03 * rng.standard_normal((B, L))).astype(np.float32)
        out.append(Batch(clean, noisy, np.full(B, 1.04, np.float32),
                         rng.uniform(0.2, 0.6, B).astype(np.float32)))
    return out


def small_state(seed=0):
    gen = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(seed))
    disc = Discriminator(4, device="cpu", generator=torch.Generator().manual_seed(seed + 1))
    return create_gan_state(gen, disc, "sgd", 1e-3)


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _est_only_scores(clean, est, fs=16000, **kw):
    """Stand-in PESQ scores that depend on the estimate only."""
    return 2.0 + np.tanh(np.abs(np.asarray(est, np.float64)).mean(axis=1))


@pytest.mark.parametrize("labels", ["engine", "estimate-only"])
def test_lag0_loop_equals_fused_step_step_for_step(monkeypatch, labels):
    """Two-phase and fused loop against the fused step called by hand.  The
    loop labels the estimate against the batch's audio, as the JAX CLI
    does, the fused step against the RMS-normalized audio (PESQ
    level-aligns both, up to rounding): with the engine the losses and
    parameters agree to rtol 1e-5; with labels of the estimate alone
    everything is equal, bit for bit."""
    if labels == "estimate-only":
        monkeypatch.setattr(port_loop, "batch_pesq_raw", _est_only_scores)
        monkeypatch.setattr(gan_module, "batch_pesq_raw", _est_only_scores)
    exact = labels == "estimate-only"
    batches = tone_batches()
    looped = small_state()
    stats = run_gan_epoch(looped, batches, epoch=3, seed=5, criterion=l2_loss,
                          step_mode="two-phase")
    stepped = small_state()
    step = make_fused_gan_train_step(criterion=l2_loss)
    want = []
    for i, bt in enumerate(batches):
        clean, noisy, q_clean, q_noisy = (torch.from_numpy(a) for a in bt)
        want.append(_metrics(step(stepped, clean, noisy, port_loop.step_seed(5, 3, i),
                                  q_clean, q_noisy)))
    fused = small_state()
    fused_stats = run_gan_epoch(fused, batches, epoch=3, seed=5, criterion=l2_loss,
                                step_mode="fused")
    assert stats.gan_steps == fused_stats.gan_steps == len(stats.disc_losses) == STEPS
    assert fused_stats.gen_losses == [m["loss"] for m in want]
    assert fused_stats.disc_losses == [m["disc_loss"] for m in want]
    rtol = 0.0 if exact else 1e-5
    np.testing.assert_allclose(stats.gen_losses, [m["loss"] for m in want], rtol=rtol)
    np.testing.assert_allclose(stats.disc_losses, [m["disc_loss"] for m in want], rtol=rtol)
    assert stats.gen_losses[0] == want[0]["loss"]  # before any label matters
    for a, b in ((looped.gen, stepped.gen), (looped.disc, stepped.disc)):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            if exact:
                assert torch.equal(x, y), key
            else:
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7, msg=key)


@pytest.mark.parametrize("step_mode", ["async", "pipelined"])
def test_flush_applies_every_update_once(monkeypatch, step_mode):
    """Each deferred update runs once, in step order, on the GenAux of its
    own step: the queue at each update is read off the calls."""
    applied = []
    real = port_loop.gan_discriminator_step

    def spy(state, aux, q_est, q_clean, q_noisy, seed, **kw):
        applied.append((state.gen_step, float(aux.metrics["loss"])))
        return real(state, aux, q_est, q_clean, q_noisy, seed, **kw)

    monkeypatch.setattr(port_loop, "gan_discriminator_step", spy)
    state = small_state()
    stats = run_gan_epoch(state, tone_batches(5), epoch=0, seed=1, criterion=l2_loss,
                          step_mode=step_mode)
    lag = port_loop.DISC_LAG[step_mode]
    assert [loss for _, loss in applied] == stats.gen_losses
    # update i runs after generator step min(i + lag, 5): the lag, then the flush
    assert [g for g, _ in applied] == [min(i + lag, 5) for i in range(5)]
    assert state.disc_step == stats.gan_steps == len(stats.disc_losses) == 5


def test_stop_leaves_the_queue_unapplied():
    state = small_state()
    stats = run_gan_epoch(state, tone_batches(3), epoch=0, seed=1, criterion=l2_loss,
                          step_mode="pipelined", on_step=lambda idx, stats: idx == 2)
    assert stats.stopped and len(stats.gen_losses) == 3
    assert state.disc_step == len(stats.disc_losses) == 1  # step 0's; 1 and 2 pending


def test_gen_first_and_empty_batches():
    """A batch with no rows is skipped; without the GAN term no label is
    computed and no discriminator update is applied."""
    batches = tone_batches(2)
    empty = Batch(*(np.zeros((0, L), np.float32),) * 2, np.zeros(0, np.float32),
                  np.zeros(0, np.float32))
    state = small_state()
    stats = run_gan_epoch(state, [empty] + batches, epoch=0, seed=1, criterion=l2_loss,
                          step_mode="pipelined", gan_active=False)
    assert len(stats.gen_losses) == 2 and stats.gan_steps == 0
    assert stats.disc_losses == [] and state.disc_step == 0 and stats.label_wait == 0.0


def test_pinned_copy_labels_equal_host_pesq_labels():
    batch = tone_batches(1)[0]
    est = torch.from_numpy(batch.noisy[:, :3900].copy())
    host, done = port_loop.queue_host_copy(est)
    got = port_loop.estimate_labels(batch.audio, host, done)
    want = host_pesq_labels(torch.from_numpy(batch.audio[:, :3900]), est)
    assert done is None and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_unknown_step_mode_and_missing_labels_raise():
    state = small_state()
    with pytest.raises(ValueError, match="step_mode"):
        run_gan_epoch(state, [], epoch=0, seed=0, criterion=l2_loss, step_mode="eager")
    batch = tone_batches(1)[0]._replace(pesq_clean=None)
    with pytest.raises(ValueError, match="precomputed"):
        run_gan_epoch(state, [batch], epoch=0, seed=0, criterion=l2_loss,
                      step_mode="two-phase")
