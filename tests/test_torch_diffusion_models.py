"""The port's diffusion models (speech_enhancement_tpu_torch/models/diffuse.py
and tsc_diffusion.py) against the flax models on converted weights (CPU,
fp32), and the two converters against the JAX package's.

Bound: relative RMS < 1e-5 for every module: both sides run the same
fp32 math in another summation order.  The embedding table is held bit
for bit.  DiffuSE's output conv and the upsampler's biases are zero at
init, so the flax weights are perturbed first (and the TSCNet's batch
statistics moved away from init), so that every mapped leaf matters.
Widths: DiffuSE 16 channels (GroupNorm's c // 16 groups need c >= 16), 4
layers, dilation cycle 2; DiffusionTSCNet 8 channels; L = 4000.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.models import DiffuSE as FlaxDiffuSE
from speech_enhancement_tpu.models import DiffusionTSCNet as FlaxDiffusionTSCNet
from speech_enhancement_tpu.models.diffuse import DiffusionEmbedding as FlaxEmbedding
from speech_enhancement_tpu.models.diffuse import ResidualBlock as FlaxResidualBlock
from speech_enhancement_tpu.models.diffuse import SpectrogramUpsampler as FlaxUpsampler
from speech_enhancement_tpu.models.diffuse import _build_embedding_table
from speech_enhancement_tpu.ops import compressed_stft
from speech_enhancement_tpu.utils.convert_torch import convert_diffuse, convert_tsc_diffusion
from speech_enhancement_tpu_torch.models import (
    DiffuSE,
    DiffusionEmbedding,
    DiffusionTSCNet,
    ResidualBlock,
    SpectrogramUpsampler,
)
from speech_enhancement_tpu_torch.models.diffuse import build_embedding_table
from speech_enhancement_tpu_torch.utils.convert import (
    diffuse_state_dict_from_flax,
    residual_block_state_dict,
    tsc_diffusion_state_dict_from_flax,
)

torch.set_num_threads(1)

BOUND = 1e-5
B, L = 2, 4000


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def perturbed(tree, seed, scale=0.05):
    """Host copy of a flax tree with every leaf moved by seeded noise."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def audio(seed, shape=(B, L)):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def conditioner(seed, frames=L // 100, bins=201):
    return np.abs(np.random.default_rng(seed).standard_normal((B, frames, bins))).astype(
        np.float32)


def test_embedding_table_is_the_jax_table_bit_for_bit():
    for steps in (6, 50, 200):
        np.testing.assert_array_equal(build_embedding_table(steps),
                                      _build_embedding_table(steps))


@pytest.mark.parametrize("t", [np.array([3, 7, 49]), np.array([0.0, 3.5, 48.25]),
                               np.array([2.9999998, 17.0, 0.125], np.float32)])
def test_diffusion_embedding_matches_jax(t):
    emb = FlaxEmbedding(max_steps=50)
    variables = emb.init(jax.random.PRNGKey(0), jnp.array([0, 1]))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    port = DiffusionEmbedding(50)
    sd = {}
    for name in ("projection1", "projection2"):
        sd[f"{name}.weight"] = torch.from_numpy(params[name]["kernel"].T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(params[name]["bias"])
    port.load_state_dict(sd)
    want = np.asarray(emb.apply(variables, jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(t)).numpy()
    assert got.shape == (3, 512)
    assert rel_rms(got, want) < BOUND


def upsampler_state_dict(params):
    """The upsampler's entries of ``diffuse_state_dict_from_flax`` (the
    rest of the tree is a placeholder of one block-free DiffuSE)."""
    zeros = {"kernel": np.zeros((1, 1, 1), np.float32), "bias": np.zeros(1, np.float32)}
    tree = {"input_projection": zeros, "skip_projection": zeros, "output_projection": zeros,
            "diffusion_embedding": {"projection1": zeros, "projection2": zeros},
            "spectrogram_upsampler": params}
    prefix = "spectrogram_upsampler."
    return {k[len(prefix):]: v for k, v in diffuse_state_dict_from_flax(tree).items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("hop", [100, 16, 9])
def test_spectrogram_upsampler_matches_jax(hop):
    up = FlaxUpsampler(hop_length=hop)
    x = conditioner(1, frames=12, bins=33)
    variables = up.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = perturbed(variables["params"], 2)
    want = np.asarray(up.apply({"params": params}, jnp.asarray(x)))  # [B, T', F]
    port = SpectrogramUpsampler(hop)
    port.load_state_dict(upsampler_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).transpose(1, 2).numpy()
    # 12 frames stretched by L twice; an odd L (3) adds a sample per stage
    assert got.shape == want.shape and 12 * hop <= got.shape[1] <= 12 * hop + 4
    assert rel_rms(got, want) < BOUND


def test_upsampler_needs_a_square_hop():
    with pytest.raises(ValueError, match="perfect square"):
        SpectrogramUpsampler(200)


@pytest.mark.parametrize("use_groupnorm", [True, False])
def test_residual_block_matches_jax(use_groupnorm):
    block = FlaxResidualBlock(16, 2, use_groupnorm)
    x = audio(3, (B, 400, 16))
    cond = conditioner(4, frames=400, bins=24)
    step = audio(5, (B, 512))
    variables = block.init(jax.random.PRNGKey(0), x, cond, step)
    params = perturbed(variables["params"], 6)
    want = block.apply({"params": params}, x, cond, step)
    port = ResidualBlock(24, 16, 2, use_groupnorm)
    port.load_state_dict(residual_block_state_dict(params, use_groupnorm))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (x.transpose(0, 2, 1).copy(),
                                                   cond.transpose(0, 2, 1).copy(), step)))
    for g, w in zip(got, want):
        assert rel_rms(g.transpose(1, 2).numpy(), w) < BOUND


def flax_diffuse(use_groupnorm):
    model = FlaxDiffuSE(dilation_cycle_length=2, residual_channels=16, residual_layers=4,
                        use_groupnorm=use_groupnorm)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(audio(0)),
                           jnp.asarray(conditioner(0)), jnp.array([0, 1]))
    return model, perturbed(variables["params"], 7)


def port_diffuse(params, use_groupnorm):
    model = DiffuSE(dilation_cycle_length=2, residual_channels=16, residual_layers=4,
                    use_groupnorm=use_groupnorm, device="cpu")
    model.load_state_dict(diffuse_state_dict_from_flax(params, use_groupnorm), strict=True)
    return model.eval()


@pytest.mark.parametrize("use_groupnorm", [True, False])
@pytest.mark.parametrize("t", [np.array([3, 41]), np.array([2.5, 48.75], np.float32)])
def test_diffuse_matches_jax(use_groupnorm, t):
    model, params = flax_diffuse(use_groupnorm)
    x, cond = audio(8), conditioner(9)
    want = np.asarray(model.apply({"params": params}, x, cond, jnp.asarray(t)))
    port = port_diffuse(params, use_groupnorm)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t)).numpy()
    assert got.shape == (B, L)
    assert rel_rms(got, want) < BOUND


def test_diffuse_output_conv_starts_at_zero():
    model = DiffuSE(residual_channels=16, residual_layers=2, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(audio(0)), torch.from_numpy(conditioner(0)),
                    torch.tensor([1, 2]))
    assert torch.count_nonzero(out) == 0


def test_diffuse_remat_gives_the_same_gradients():
    """Recomputing the blocks in the backward changes no gradient (the
    last block's residual conv feeds nothing: its gradient is zero)."""
    _, params = flax_diffuse(True)
    grads = []
    for remat in (True, False):
        port = port_diffuse(params, True).train()
        port.remat = remat
        out = port(torch.from_numpy(audio(10)), torch.from_numpy(conditioner(11)),
                   torch.tensor([4, 30]))
        grads.append(torch.autograd.grad(out.square().mean(), list(port.parameters()),
                                         allow_unused=True, materialize_grads=True))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def flax_tsc():
    model = FlaxDiffusionTSCNet(num_channel=8, num_features=201, num_steps=50)
    spec = compressed_stft(jnp.asarray(audio(12, (1, 2000))), 400, 100)
    variables = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                           spec, spec, jnp.array([0]))
    params = perturbed(variables["params"], 13, scale=0.01)
    rng = np.random.default_rng(14)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(
            np.float32), variables["batch_stats"])
    return model, {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("t", [np.array([5, 44]), np.array([0.5, 31.25], np.float32)])
def test_diffusion_tscnet_matches_jax(flax_tsc, t):
    model, variables = flax_tsc
    spec = compressed_stft(jnp.asarray(audio(15)), 400, 100)
    noisy_spec = compressed_stft(jnp.asarray(audio(16)), 400, 100)
    want = model.apply(variables, spec, noisy_spec, jnp.asarray(t), deterministic=True)
    port = DiffusionTSCNet(8, 201, 50, device="cpu")
    port.load_state_dict(tsc_diffusion_state_dict_from_flax(variables["params"],
                                                            variables["batch_stats"]),
                         strict=True)
    port.eval()
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.asarray(s)) for s in (spec, noisy_spec)),
                   torch.from_numpy(t))
    for g, w in zip(got, want):
        assert g.shape == (B, 41, 201)
        assert rel_rms(g.numpy(), w) < BOUND


def test_diffusion_tscnet_shares_one_merge_block():
    port = DiffusionTSCNet(8, 201, device="cpu")
    keys = [k for k in port.state_dict() if "merge" in k]
    assert keys and all(k.startswith("merge_block.") for k in keys)
    assert sorted({k.split(".")[0] for k in port.state_dict() if k.startswith("TSCB")}) == [
        "TSCB_1", "TSCB_2", "TSCB_3", "TSCB_4"]


def leaves_equal(a, b):
    flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert [k for k, _ in flat_a] == list(flat_b)
    for key, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[key]),
                                      err_msg=jax.tree_util.keystr(key))


@pytest.mark.parametrize("use_groupnorm", [True, False])
def test_diffuse_converter_round_trip_is_bit_exact(use_groupnorm):
    _, params = flax_diffuse(use_groupnorm)
    sd = diffuse_state_dict_from_flax(params, use_groupnorm)
    back = convert_diffuse({k: v.numpy() for k, v in sd.items()}, use_groupnorm=use_groupnorm)
    leaves_equal(back["params"], params)


def test_tsc_diffusion_converter_round_trip_is_bit_exact(flax_tsc):
    _, variables = flax_tsc
    sd = tsc_diffusion_state_dict_from_flax(variables["params"], variables["batch_stats"])
    back = convert_tsc_diffusion({k: v.numpy() for k, v in sd.items()})
    leaves_equal(back["params"], variables["params"])
    leaves_equal(back["batch_stats"], variables["batch_stats"])
