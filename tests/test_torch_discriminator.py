"""The port's Discriminator against the flax Discriminator on converted
weights (CPU, fp32): forward, the numpy converter against
convert_torch.export_discriminator, and one spectral-norm refresh against
flax's update_stats=True.

Forward bound: relative RMS < 1e-4, as tests/test_torch_models.py (the
same fp32 convolutions in another summation order); the refreshed (u, v)
rtol 1e-5, atol 1e-6 (a few matrix-vector products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.models import Discriminator as FlaxDiscriminator
from speech_enhancement_tpu.utils.convert_torch import export_discriminator
from speech_enhancement_tpu_torch.models import Discriminator
from speech_enhancement_tpu_torch.utils.convert import discriminator_state_dict_from_flax

# one intra-op thread: the pytest-xdist workers share the cores, and with
# torch's default of a thread per core in each, these tests took 3.5x as long
torch.set_num_threads(1)

NDF = 4


def _mags(seed, b=2, t=41, f=201):
    rng = np.random.default_rng(seed)
    return tuple(np.abs(rng.standard_normal((b, t, f))).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def flax_disc():
    model = FlaxDiscriminator(ndf=NDF, dropout=0.0)
    x, y = _mags(0)
    variables = model.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                           jnp.asarray(x), jnp.asarray(y))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port(variables):
    disc = Discriminator(ndf=NDF, dropout=0.0, device="cpu")
    disc.load_state_dict(discriminator_state_dict_from_flax(variables["params"],
                                                            variables["spectral"]), strict=True)
    return disc


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def test_converter_matches_export_discriminator(flax_disc):
    _, variables = flax_disc
    want = export_discriminator(variables)
    got = discriminator_state_dict_from_flax(variables["params"], variables["spectral"])
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    port = Discriminator(ndf=NDF, device="cpu")
    assert set(port.state_dict()) == set(got)
    port.load_state_dict(got, strict=True)


@pytest.mark.parametrize("seed", [1, 2])
def test_forward_matches_flax(flax_disc, seed):
    model, variables = flax_disc
    x, y = _mags(seed)
    want = model.apply(variables, jnp.asarray(x), jnp.asarray(y), deterministic=True)
    disc = _port(variables).eval()
    with torch.no_grad():
        got = disc(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, 1)
    assert _rel_rms(got, want) < 1e-4


def test_forward_reads_but_never_updates_spectral_state(flax_disc):
    _, variables = flax_disc
    disc = _port(variables).train()
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    disc(*(torch.from_numpy(a) for a in _mags(5))).sum().backward()
    for key, value in disc.state_dict().items():
        assert torch.equal(value, before[key]), key
    assert disc.layers[0].weight_u.grad is None  # buffers, no gradient


def test_refresh_matches_flax_update_stats(flax_disc):
    model, variables = flax_disc
    x, y = _mags(6)
    _, updates = model.apply(variables, jnp.asarray(x), jnp.asarray(y), deterministic=True,
                             update_stats=True, mutable=["spectral"])
    want = discriminator_state_dict_from_flax(variables["params"],
                                              jax.tree_util.tree_map(np.asarray,
                                                                     updates["spectral"]))
    disc = _port(variables)
    disc.refresh_()
    got = disc.state_dict()
    for key, value in want.items():
        if key.endswith(("weight_u", "weight_v")):
            torch.testing.assert_close(got[key], value, rtol=1e-5, atol=1e-6, msg=key)
            assert not torch.equal(value, torch.tensor(
                np.asarray(export_discriminator(variables)[key]))), key
