"""The port's optimizers, schedule and loss criteria against the JAX
package's (optax chains; CPU, fp32).

Three updates of sgd (Nesterov), adamw, lars and lamb on a small tree
with a 2-D ``kernel`` and a 1-D ``bias`` (so the no-decay mask matters),
with and without global-norm clipping: parameters agree to rtol 1e-5
(the same fp32 arithmetic in another order), with atol 1e-6 for elements
near zero (1e-4 of one update, whose size is the learning rate, 1e-2 to
3e-2: Adam's normalized steps round differently there); the schedule
values to rtol 1e-5; the criteria to rtol 1e-6 (one mean of 60 values).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from speech_enhancement_tpu.train.criterion import build_criterion as jax_build_criterion
from speech_enhancement_tpu.train.optim import build_optimizer as jax_build_optimizer
from speech_enhancement_tpu.train.optim import cyclic_cosine_schedule as jax_schedule
from speech_enhancement_tpu_torch.train.criterion import build_criterion
from speech_enhancement_tpu_torch.train.optim import (
    build_optimizer,
    cyclic_cosine_schedule,
    decays,
)

# one intra-op thread: the pytest-xdist workers share the cores, and with
# torch's default of a thread per core in each, these tests took 3.5x as long
torch.set_num_threads(1)


@pytest.mark.parametrize("epochs,cycle_limit,warmup", [(100, 4, 4), (3, 4, 4), (8, 4, 5)])
def test_cyclic_cosine_schedule_matches_jax(epochs, cycle_limit, warmup):
    """Step 0, inside the warmup, the end of the warmup, mid-cycle, the
    cycle boundary and past it, including the guarded configurations
    (epochs < cycle_limit; warmup >= cycle).  The JAX schedule runs in
    fp32, so near the end of a cycle, where 1 + cos cancels, the bound
    is atol 1e-8 (1e-6 of the base rate)."""
    iters = 10
    got = cyclic_cosine_schedule(1e-2, epochs, iters, cycle_limit, warmup, scale=2.0)
    want = jax_schedule(1e-2, epochs, iters, cycle_limit, warmup, scale=2.0)
    cycle = max(epochs // cycle_limit, 1) * iters
    for step in (0, 7, warmup * iters, cycle // 2, cycle - 1, cycle, cycle + 13):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, atol=1e-8,
                                   err_msg=str(step))


class Tiny(nn.Module):
    def __init__(self, kernel, bias):
        super().__init__()
        self.kernel = nn.Parameter(torch.tensor(kernel))
        self.bias = nn.Parameter(torch.tensor(bias))


def test_no_decay_rule():
    assert decays("layers.0.weight_orig", torch.zeros(2, 3))
    assert not decays("layers.0.bias", torch.zeros(2, 3))
    assert not decays("prelu.weight", torch.zeros(4))


@pytest.mark.parametrize("max_norm", [0.0, 0.5])
@pytest.mark.parametrize("name", ["sgd", "adamw", "lars", "lamb"])
def test_three_updates_match_optax(name, max_norm):
    rng = np.random.default_rng(0)
    kernel = rng.standard_normal((5, 3)).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    grads = [(rng.standard_normal((5, 3)).astype(np.float32),
              rng.standard_normal(3).astype(np.float32)) for _ in range(3)]
    schedule = lambda step: 1e-2 * (step + 1)  # noqa: E731

    params = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    tx = jax_build_optimizer(name, schedule, params, momentum=0.9, weight_decay=0.1,
                             max_norm=max_norm)
    opt_state = tx.init(params)
    for gk, gb in grads:
        updates, opt_state = tx.update({"kernel": jnp.asarray(gk), "bias": jnp.asarray(gb)},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)

    module = Tiny(kernel, bias)
    opt = build_optimizer(name, schedule, module, momentum=0.9, weight_decay=0.1,
                          max_norm=max_norm)
    for gk, gb in grads:
        module.kernel.grad = torch.tensor(gk)
        module.bias.grad = torch.tensor(gb)
        opt.step()
    assert opt.count == 3
    for key in ("kernel", "bias"):
        np.testing.assert_allclose(getattr(module, key).detach().numpy(),
                                   np.asarray(params[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["mae", "L1", "mse", "l2"])
def test_criterion_matches_jax(name):
    rng = np.random.default_rng(1)
    pred, target = (rng.standard_normal((3, 20)).astype(np.float32) for _ in range(2))
    got = build_criterion(name)(torch.from_numpy(pred), torch.from_numpy(target))
    want = jax_build_criterion(name)(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_unknown_criterion_raises():
    with pytest.raises(ValueError, match="invalid criterion"):
        build_criterion("huber")
