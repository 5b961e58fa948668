"""Port models against the flax models on converted weights (CPU, fp32).

The bound is relative RMS < 1e-4, the one tests/test_torch_parity.py
holds the JAX TSCNet to against the original torch model: both sides run
the same fp32 math in another summation order, so the measured gap is
about 1e-6.  Batch statistics are perturbed away from their init so the
BatchNorm running-stat mapping is exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.models import TSCNet as FlaxTSCNet
from speech_enhancement_tpu.models.conformer import ConformerBlock as FlaxConformerBlock
from speech_enhancement_tpu.ops import compressed_stft
from speech_enhancement_tpu.utils.convert_torch import export_tscnet
from speech_enhancement_tpu_torch.models import ConformerBlock, TSCNet
from speech_enhancement_tpu_torch.utils.convert import (
    conformer_state_dict,
    state_dict_from_flax,
)

# one intra-op thread: the pytest-xdist workers share the cores, and with
# torch's default of a thread per core in each, these tests took 3.5x as long
torch.set_num_threads(1)

BOUND = 1e-4


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def _numpy_variables(variables, seed):
    """Host copies of flax variables with perturbed (positive) batch stats."""
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _spec(seed, shape):
    x = 0.3 * np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return compressed_stft(jnp.asarray(x), 400, 100)


@pytest.fixture(scope="module")
def flax_tscnet8():
    model = FlaxTSCNet(num_channel=8, num_features=201)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "dropout": jax.random.PRNGKey(1)},
                           _spec(0, (1, 2000)), deterministic=True)
    return _numpy_variables(variables, 0)


def test_state_dict_from_flax_matches_export(flax_tscnet8):
    want = export_tscnet(flax_tscnet8)
    got = state_dict_from_flax(flax_tscnet8["params"], flax_tscnet8["batch_stats"])
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].shape == np.asarray(value).shape, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    port = TSCNet(num_channel=8, num_features=201, device="cpu")
    assert set(port.state_dict()) == set(got)
    port.load_state_dict(got, strict=True)


@pytest.mark.parametrize("fused", [False, True])
def test_conformer_block_matches_flax(fused):
    x = np.random.default_rng(1).standard_normal((3, 33, 16)).astype(np.float32)
    flax_block = FlaxConformerBlock(dim=16, dim_head=4, heads=4, fused_attention=fused)
    variables = _numpy_variables(
        flax_block.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x)), 1)
    want = flax_block.apply(variables, jnp.asarray(x))
    block = ConformerBlock(16, dim_head=4, heads=4, fused_attention=fused).eval()
    block.load_state_dict(conformer_state_dict(variables["params"],
                                               variables["batch_stats"]), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert _rel_rms(got, want) < BOUND


@pytest.mark.parametrize("fused", [False, True])
def test_tscnet_matches_flax(fused):
    spec = _spec(2, (2, 4000))
    flax_model = FlaxTSCNet(num_channel=16, num_features=201, fused_attention=fused)
    variables = _numpy_variables(
        flax_model.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                        spec, deterministic=True), 2)
    want_re, want_im = flax_model.apply(variables, spec, deterministic=True)
    model = TSCNet(16, 201, fused_attention=fused, device="cpu").eval()
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]), strict=True)
    with torch.no_grad():
        got_re, got_im = model(torch.tensor(np.asarray(spec)))
    assert got_re.shape == got_im.shape == (2, 41, 201)
    assert got_re.dtype == torch.float32
    assert _rel_rms(got_re, want_re) < BOUND
    assert _rel_rms(got_im, want_im) < BOUND


def test_tscnet_accepts_pair_and_complex():
    model = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(5)).eval()
    spec = torch.tensor(np.asarray(_spec(3, (1, 2000))))
    with torch.no_grad():
        a = model(spec)
        b = model((spec.real, spec.imag))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_init_is_seeded_and_follows_the_jax_initializers():
    a = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(7))
    b = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    sd = a.state_dict()
    assert torch.all(sd["TSCB_1.time_conformer.attn.fn.to_out.bias"] == 0.01)
    assert torch.all(sd["mask_decoder.prelu_out.weight"] == -0.25)
    w = sd["TSCB_1.time_conformer.ff1.fn.fn.net.0.weight"]  # fan_in 8: std 0.5
    assert 0.35 < float(w.std()) < 0.65


def test_cuda_device_absent_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError):
        TSCNet(8, 201, device="cuda")
