"""The port's training epoch at discriminator lags 1 and 2 (async,
pipelined) against a replay of the JAX CLI's deferred-update queue
(speech_enhancement_tpu/cli/main_gan.py:365-460), written here with the
JAX ``gan_generator_step`` and ``gan_discriminator_step``: over 4 steps,
each discriminator update runs on the current state with the ``GenAux``
of 1 or 2 steps earlier, and the queue is flushed at the end of the epoch.

Converted weights at the JAX training tests' sizes
(tests/torch_train_common.py), dropout off on both sides
(``no_flax_dropout``), SGD-Nesterov lr 1e-3 (discriminator 2e-3, the JAX
training tests' rates) without weight decay (the JAX package's no-decay
mask decays the scanned TSCB stack's 1-D parameters, the port does not:
tests/test_torch_gan_step.py).  Both sides get the labels of one engine,
the JAX engine's scores of the JAX estimates: the two estimates differ by
fp32 rounding, and the port's engine scored them 2.7e-8 apart (1.7e-5 at
lr 0.01).

Bounds, those of tests/test_torch_gan_step.py in fp32: every generator and
discriminator loss rtol 1e-5 (measured at most 7.2e-6); the parameters'
total change over the 4 steps relative RMS < 1e-3 over all parameters of
each model (measured 1.3e-4) and < 1e-2 per parameter (measured at most
6.1e-3), the latter where the change is at least 100 fp32 steps of the
parameter's values: the Shaw tables move by 0.7-5 steps, which is
rounding (they are held under that floor on both sides).  At lr 0.01 the
losses of later steps part by up to 1.4e-4: fp32's gradient floor,
carried by larger updates.
"""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop import STEPS, tone_batches
from torch_train_common import jax_setup, no_flax_dropout, port_state, rel_rms  # noqa: F401

from speech_enhancement_tpu.metrics.pesq import batch_pesq_raw as jax_batch_pesq_raw
from speech_enhancement_tpu.train import build_optimizer as jax_build_optimizer
from speech_enhancement_tpu.train import gan_discriminator_step as jax_gan_discriminator_step
from speech_enhancement_tpu.train import gan_generator_step as jax_gan_generator_step
from speech_enhancement_tpu.train import l2_loss as jax_l2_loss
from speech_enhancement_tpu_torch.train import build_optimizer, l2_loss, run_gan_epoch
from speech_enhancement_tpu_torch.train import loop as port_loop
from speech_enhancement_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax,
    state_dict_from_flax,
)

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


def jax_queue_replay(lag, batches, gen, disc, gen_tx, disc_tx, state):
    """The JAX CLI's step loop with its deferred-update queue; returns the
    final state, the generator and discriminator losses, and the raw PESQ
    scores of each step's estimate (keyed by the batch's first row)."""
    kw = dict(gen_model=gen, disc_model=disc, arch="scp", criterion=jax_l2_loss,
              gen_tx=gen_tx, gan_active=True)
    dkw = dict(disc_model=disc, arch="scp", criterion=jax_l2_loss, disc_tx=disc_tx)
    rng = jax.random.PRNGKey(9)
    pending, gen_losses, disc_losses, scores = deque(), [], [], {}
    for batch in batches:
        rng, step_rng, disc_rng = jax.random.split(rng, 3)
        if len(pending) >= lag:
            p_aux, q_est, q_c, q_n, p_rng = pending.popleft()
            state, loss = jax_gan_discriminator_step(state, p_aux, q_est, q_c, q_n, p_rng, **dkw)
            disc_losses.append(float(loss))
        state, aux = jax_gan_generator_step(state, jnp.asarray(batch.audio),
                                            jnp.asarray(batch.noisy), step_rng, **kw)
        est = np.asarray(aux.est_audio)
        raw = jax_batch_pesq_raw(batch.audio[:, :est.shape[1]], est)
        scores[batch.audio[0].tobytes()] = raw
        pending.append((aux, jnp.asarray((raw - 1.0) / 3.5, jnp.float32),
                        jnp.asarray(batch.pesq_clean), jnp.asarray(batch.pesq_noisy),
                        disc_rng))
        gen_losses.append(float(aux.metrics["loss"]))
    while pending:
        p_aux, q_est, q_c, q_n, p_rng = pending.popleft()
        state, loss = jax_gan_discriminator_step(state, p_aux, q_est, q_c, q_n, p_rng, **dkw)
        disc_losses.append(float(loss))
    return state, gen_losses, disc_losses, scores


def _changes_agree(module, start: dict, want: dict, want_start: dict, what: str):
    """The change of ``module``'s parameters since ``start`` against
    ``want_start`` to ``want``: relative RMS over all parameters < 1e-3;
    per parameter < 1e-2 where the change is at least 100 fp32 steps of
    the parameter's values (RMS), and under that on both sides elsewhere."""
    got = dict(module.named_parameters())
    delta = {k: got[k].detach().double() - start[k].double() for k in got}
    want_delta = {k: want[k].double() - want_start[k].double() for k in got}
    rms_ = lambda t: float(t.pow(2).mean().sqrt())  # noqa: E731
    for key, d in want_delta.items():
        floor = 100 * float(np.finfo(np.float32).eps) * rms_(want[key].double())
        if rms_(d) < floor:
            assert rms_(delta[key]) < floor, (what, key)
        else:
            assert rel_rms(delta[key], d) < 1e-2, (what, key, rel_rms(delta[key], d))
    flat = [torch.cat([d[k].reshape(-1) for k in got]) for d in (delta, want_delta)]
    assert rel_rms(*flat) < 1e-3, (what, rel_rms(*flat))


@pytest.mark.parametrize("step_mode, lag", [("async", 1), ("pipelined", 2)])
def test_deferred_updates_match_jax_queue_replay(no_flax_dropout, monkeypatch,  # noqa: F811
                                                 step_mode, lag):
    gen, disc, _, _, probe = jax_setup()
    gen_tx = jax_build_optimizer("sgd", 1e-3, probe.gen.params, weight_decay=0.0)
    disc_tx = jax_build_optimizer("sgd", 2e-3, probe.disc.params, weight_decay=0.0)
    gen, disc, gen_tx, disc_tx, jstate = jax_setup(gen_tx=gen_tx, disc_tx=disc_tx)
    state = port_state(jstate)
    state.gen_opt = build_optimizer("sgd", 1e-3, state.gen, weight_decay=0.0)
    state.disc_opt = build_optimizer("sgd", 2e-3, state.disc, weight_decay=0.0)
    gen_start = {k: v.clone() for k, v in state.gen.state_dict().items()}
    disc_start = {k: v.clone() for k, v in state.disc.state_dict().items()}
    batches = tone_batches()

    jstate_end, gen_losses, disc_losses, scores = jax_queue_replay(
        lag, batches, gen, disc, gen_tx, disc_tx, jstate)
    assert len(disc_losses) == STEPS
    # both sides' labels from the JAX engine's scores of the JAX estimates
    monkeypatch.setattr(port_loop, "batch_pesq_raw",
                        lambda clean, est, fs=16000: scores[clean[0].tobytes()])
    stats = run_gan_epoch(state, batches, epoch=0, seed=0, criterion=l2_loss,
                          step_mode=step_mode)
    np.testing.assert_allclose(stats.gen_losses, gen_losses, rtol=1e-5)
    np.testing.assert_allclose(stats.disc_losses, disc_losses, rtol=1e-5)
    assert stats.gan_steps == len(stats.disc_losses) == STEPS

    host = jax.tree_util.tree_map(np.asarray, jstate_end)
    start = jax.tree_util.tree_map(np.asarray, jstate)
    _changes_agree(state.gen, gen_start,
                   state_dict_from_flax(host.gen.params, host.gen.extra["batch_stats"]),
                   state_dict_from_flax(start.gen.params, start.gen.extra["batch_stats"]),
                   "generator")
    _changes_agree(state.disc, disc_start,
                   discriminator_state_dict_from_flax(host.disc.params,
                                                      host.disc.extra["spectral"]),
                   discriminator_state_dict_from_flax(start.disc.params,
                                                      start.disc.extra["spectral"]),
                   "discriminator")
