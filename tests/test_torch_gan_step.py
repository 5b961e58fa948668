"""One generator step of the port against the JAX gan_generator_step, per
arch, from converted weights (CPU), at the JAX training tests' sizes
(tests/torch_train_common.py), eager attention: in fp32, and in float64
(both sides' weights, batch and network; ``jax.enable_x64``) for scp and
cmgan.  The fp32 step with ``fused_attention=True`` is in
tests/test_torch_gan_step_fused.py.

Dropout is off on both sides, so that neither draws random bits: flax's
``Dropout.__call__`` is patched to return its input (asserted: two
dropout keys give one JAX loss) and the port's dropout rates are 0 (the
step puts the model in train mode itself).

The gradients are compared, not SGD-updated parameters: an update of lr
1e-3 times a gradient of order 1e-2 is a few hundred fp32 steps of a
parameter of order 1.  The JAX step runs with a transformation that keeps
the gradient as its optimizer state; the port's step runs its SGD (lr
1e-3) with the gradients read as the optimizer takes them.  (The JAX
package's SGD would also decay the 1-D parameters of its scanned TSCB
stack, whose leading depth axis makes them 2-D to its no-decay mask; the
port keeps the rule as written.)

Bounds: the losses rtol 1e-5; est_audio relative RMS < 1e-4 (the bound
tests/test_torch_models.py holds the forward to); the new BatchNorm
running statistics rtol 1e-5; in float64 every gradient leaf relative
RMS < 1e-4 (measured at most 7e-6: both steps still take the generator's
output, and the iSTFT and losses after it, in fp32).  In fp32 the
gradients are held to relative RMS < 1e-3 over all leaves together and
< 1e-2 per leaf: fp32's bound, not the algorithm's.  At this random init
the network amplifies rounding (its LayerNorms normalize rows of 8
channels), and the JAX step's own fp32 gradients differ from a float64
run of the port by a median 8.7e-4 and up to 4.4e-3 per leaf (arch sc,
measured on the CPU), while one ConformerBlock's gradients agree to 1e-5
(tests/test_torch_train.py).  Leaves whose gradient is an exact zero
(conv biases in front of an InstanceNorm or a train-mode BatchNorm) are
held below 1e-6 of the largest leaf's RMS on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_train_common import (
    KEEP_GRADS,
    LOSSES,
    batch,
    float64_state,
    jax_setup,
    no_flax_dropout,  # noqa: F401 (fixture)
    port_state,
    read_grads,
    rel_rms,
    rms,
)

from speech_enhancement_tpu.train import gan_generator_step as jax_gan_generator_step
from speech_enhancement_tpu.train import l2_loss as jax_l2_loss
from speech_enhancement_tpu_torch.train import gan_generator_step, l2_loss
from speech_enhancement_tpu_torch.utils.convert import state_dict_from_flax

# one intra-op thread: the pytest-xdist workers share the cores, and with
# torch's default of a thread per core in each, these tests took 3.5x as long
torch.set_num_threads(1)


def check_generator_step(arch, fused, dtype=np.float32):
    x64 = dtype == np.float64
    with jax.enable_x64(x64):
        gen, disc, _, _, jstate = jax_setup(fused, KEEP_GRADS)
        state = port_state(jstate, fused, torch.float64 if x64 else torch.float32)
        if x64:
            jstate = float64_state(jstate)
        clean, noisy = (a.astype(dtype) for a in batch())
        kw = dict(gen_model=gen, disc_model=disc, arch=arch, criterion=jax_l2_loss,
                  gan_active=True, gen_tx=KEEP_GRADS)
        jstate1, jaux = jax_gan_generator_step(
            jstate, jnp.asarray(clean), jnp.asarray(noisy), jax.random.PRNGKey(1), **kw)
        _, jaux_other_key = jax_gan_generator_step(
            jstate, jnp.asarray(clean), jnp.asarray(noisy), jax.random.PRNGKey(2), **kw)
        assert float(jaux.metrics["loss"]) == float(jaux_other_key.metrics["loss"])
        host = jax.tree_util.tree_map(np.asarray, jstate1.gen)

    grads = read_grads(state.gen_opt, state.gen)
    aux = gan_generator_step(state, torch.from_numpy(clean), torch.from_numpy(noisy), 0,
                             criterion=l2_loss, arch=arch)
    for name in LOSSES:
        np.testing.assert_allclose(float(aux.metrics[name]), float(jaux.metrics[name]),
                                   rtol=1e-5, err_msg=name)
    assert rel_rms(aux.est_audio, jaux.est_audio) < 1e-4

    want = state_dict_from_flax(host.opt_state, host.extra["batch_stats"])
    leaf_bound = 1e-4 if x64 else 1e-2
    largest = max(rms(g) for g in grads.values())
    for key, got in grads.items():
        if rms(want[key]) < 1e-6 * largest:  # an exact zero, up to rounding
            assert rms(got) < 1e-6 * largest, key
        else:
            assert rel_rms(got, want[key]) < leaf_bound, key
    flat = [torch.cat([d[k].reshape(-1) for k in grads]) for d in (grads, want)]
    assert rel_rms(*flat) < (1e-4 if x64 else 1e-3)

    new = state.gen.state_dict()
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(new[key].numpy(), value.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=key)


@pytest.mark.parametrize("arch", ["scp", "cp", "sc", "cmgan"])
def test_generator_step_matches_jax(no_flax_dropout, arch):  # noqa: F811
    check_generator_step(arch, fused=False)
