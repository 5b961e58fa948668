"""Shared set-up of the port-against-JAX GAN step tests: the JAX training
tests' sizes (TSCNet(8, 201), Discriminator(ndf=4), B, L = 2, 4000), the
flax GAN state, and the port's GAN state on the same weights."""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_enhancement_tpu.models import Discriminator as FlaxDiscriminator
from speech_enhancement_tpu.models import TSCNet as FlaxTSCNet
from speech_enhancement_tpu.train import build_optimizer as jax_build_optimizer
from speech_enhancement_tpu.train import create_gan_state as jax_create_gan_state
from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
from speech_enhancement_tpu_torch.train import create_gan_state
from speech_enhancement_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax,
    state_dict_from_flax,
)

B, L = 2, 4000
LOSSES = ("loss_ri", "loss_mag", "time_loss", "gan_loss", "loss")

# an optax transformation that keeps the gradient as its state and leaves
# the parameters as they are
KEEP_GRADS = optax.GradientTransformation(
    lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
    lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Flax dropout returns its input.  The JAX steps are module-level
    ``jax.jit``s, so the caches are cleared before and after: neither a
    trace with dropout nor the patched one leaks into another test."""
    jax.clear_caches()
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    yield
    jax.clear_caches()


def rms(t) -> float:
    return float(np.sqrt(np.mean(np.asarray(t, np.float64) ** 2)))


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def batch(seed=0):
    """Clean noise-like audio and a noisier copy, [B, L] fp32."""
    rng = np.random.default_rng(seed)
    clean = (0.1 * rng.standard_normal((B, L))).astype(np.float32)
    noisy = (clean + 0.02 * rng.standard_normal((B, L))).astype(np.float32)
    return clean, noisy


def jax_setup(fused=False, gen_tx=None, disc_tx=None):
    """Flax models and GAN state, built as tests/test_train_gan.py builds
    them (SGD lr 1e-3, disc 2e-3) unless a transformation is given."""
    gen = FlaxTSCNet(num_channel=8, num_features=201, fused_attention=fused)
    disc = FlaxDiscriminator(ndf=4, dropout=0.0)
    probe = jax_create_gan_state(jax.random.PRNGKey(0), gen, disc, optax.sgd(1e-3),
                                 optax.sgd(1e-3), length=L)
    gen_tx = gen_tx or jax_build_optimizer("sgd", 1e-3, probe.gen.params)
    disc_tx = disc_tx or jax_build_optimizer("sgd", 2e-3, probe.disc.params)
    state = jax_create_gan_state(jax.random.PRNGKey(0), gen, disc, gen_tx, disc_tx, length=L)
    return gen, disc, gen_tx, disc_tx, state


def port_state(jax_state, fused=False, dtype=torch.float32):
    """The port's GAN state (SGD lr 1e-3, disc 2e-3) on the JAX state's
    weights, in ``dtype``, with every dropout rate 0."""
    host = jax.tree_util.tree_map(np.asarray, jax_state)
    gen = TSCNet(8, 201, fused_attention=fused, device="cpu")
    gen.load_state_dict(state_dict_from_flax(host.gen.params, host.gen.extra["batch_stats"]),
                        strict=True)
    for m in gen.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    disc = Discriminator(ndf=4, dropout=0.0, device="cpu")
    disc.load_state_dict(discriminator_state_dict_from_flax(host.disc.params,
                                                            host.disc.extra["spectral"]),
                         strict=True)
    return create_gan_state(gen.to(dtype), disc.to(dtype), "sgd", 1e-3)


def float64_state(jax_state):
    """The JAX GAN state with every floating leaf cast to float64 (needs
    ``jax.enable_x64``)."""
    def cast(x):
        floating = jnp.issubdtype(jnp.result_type(x), jnp.floating)
        return x.astype(jnp.float64) if floating else x

    return jax_state.replace(gen=jax.tree_util.tree_map(cast, jax_state.gen),
                             disc=jax.tree_util.tree_map(cast, jax_state.disc))


def read_grads(opt, module):
    """Wrap ``opt.step`` so that it first copies each parameter's gradient
    into the returned dict (by parameter name)."""
    names = [n for n, _ in module.named_parameters()]
    grads = {}
    step = opt.step

    def step_reading_grads():
        grads.update((n, p.grad.clone()) for n, p in zip(names, opt.params))
        step()

    opt.step = step_reading_grads
    return grads
