"""The whole slice: the port's Enhancer against the JAX Enhancer, with both
kernel flags on (TSCNet(fused_attention=True), Enhancer(fused_stft=True))
and both off, on the same weights and utterances (CPU: the port's
wrappers take their plain versions, the JAX kernels run in Pallas
interpret mode).

fp32 bound: relative RMS < 1e-4 per utterance, as for TSCNet alone
(tests/test_torch_models.py); the JAX side runs with
matmul_precision=None so that its matmuls are full fp32 too, except where a
test holds the two packages' default (matmul_precision="bfloat16"), which
CPU matmuls of both ignore.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu import enhance as jax_enhance
from speech_enhancement_tpu.models import TSCNet as FlaxTSCNet
from speech_enhancement_tpu.ops import compressed_stft
from speech_enhancement_tpu_torch import enhance
from speech_enhancement_tpu_torch.models import TSCNet
from speech_enhancement_tpu_torch.utils.convert import state_dict_from_flax

# one intra-op thread: the pytest-xdist workers share the cores, and with
# torch's default of a thread per core in each, these tests took 3.5x as long
torch.set_num_threads(1)

BOUND = 1e-4
LENGTHS = [3000, 7900, 5000, 2000, 6150]


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


@pytest.fixture(scope="module")
def models():
    flax_model = FlaxTSCNet(num_channel=16, num_features=201, fused_attention=True)
    variables = flax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        compressed_stft(jnp.zeros((1, 4000)), 400, 100), deterministic=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = TSCNet(16, 201, fused_attention=True, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]), strict=True)
    return flax_model, variables, model


@pytest.fixture(scope="module")
def utterances():
    rng = np.random.default_rng(11)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in LENGTHS]


@pytest.mark.parametrize("fused", [True, False])
def test_enhancer_matches_jax(models, utterances, fused):
    """Both kernel flags on (the serving path), and both off (the plain
    path chip_smoke.py compares the kernels against)."""
    _, variables, port_fused = models
    flax_model = FlaxTSCNet(num_channel=16, num_features=201, fused_attention=fused)
    model = TSCNet(16, 201, fused_attention=fused, device="cpu")
    model.load_state_dict(port_fused.state_dict())
    want = jax_enhance.Enhancer(flax_model, variables, quantum=4000, fused_stft=fused,
                                matmul_precision=None).enhance(utterances, batch_size=2)
    got = enhance.Enhancer(model, quantum=4000, fused_stft=fused, device="cpu").enhance(utterances,
                                                                         batch_size=2)
    assert [len(g) for g in got] == LENGTHS
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.all(np.isfinite(g))
        assert _rel_rms(g, w) < BOUND


def test_bf16_close_to_fp32(models, utterances):
    """Port bf16 against port fp32, bounded as tests/test_enhance.py bounds
    the JAX bf16 mode: a random-init 8-conformer stack drifts 10-25% RMS in
    bf16, so this is a sanity bound, not a parity claim."""
    _, _, model = models
    x = np.stack([u[:2000] for u in utterances[:2]])
    full = enhance.Enhancer(model, fused_stft=True, device="cpu").enhance_batch(x)
    half = enhance.Enhancer(model, fused_stft=True, device="cpu",
                            compute_dtype=torch.bfloat16).enhance_batch(x)
    assert half.dtype == np.float32 and half.shape == full.shape
    assert next(model.parameters()).dtype == torch.float32  # the caller's model is kept
    assert _rel_rms(half, full) < 0.35


def test_predict_one_matches_jax(models, utterances):
    flax_model, variables, model = models
    noisy = utterances[4][:3050]  # not a hop multiple: wrap-padded to 3100
    want = jax_enhance.predict_one(flax_model, variables, noisy)
    got = enhance.predict_one(model, noisy, device="cpu")
    assert got.shape == want.shape == (3050,)
    assert _rel_rms(got, want) < BOUND


@pytest.mark.parametrize("length,quantum", [(1, 8000), (8000, 8000), (8001, 8000),
                                            (4100, 4000)])
def test_buckets_and_wrap_pad_match_jax(length, quantum):
    assert enhance.round_to_bucket(length, quantum) == jax_enhance.round_to_bucket(length,
                                                                                   quantum)
    x = np.arange(37, dtype=np.float32)
    np.testing.assert_array_equal(enhance.wrap_pad(x, length % 97),
                                  jax_enhance.wrap_pad(x, length % 97))


def test_default_precision_matches_jax_default(models, utterances):
    """The port's default Enhancer (matmul_precision="bfloat16") against the
    JAX default (the same value).  On the CPU both packages leave their
    matmuls at fp32 under that setting, so this holds the plumbing to the
    fp32 bound; the card measures the TF32 numerics (chip_smoke.py phase 5)."""
    flax_model, variables, model = models
    want = jax_enhance.Enhancer(flax_model, variables, quantum=4000,
                                fused_stft=True).enhance(utterances, batch_size=2)
    port = enhance.Enhancer(model, quantum=4000, fused_stft=True, device="cpu")
    assert port.matmul_precision == "bfloat16"
    got = port.enhance(utterances, batch_size=2)
    for g, w in zip(got, want):
        assert _rel_rms(g, w) < BOUND


def _flags():
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.cudnn.conv.fp32_precision)


@pytest.mark.parametrize("precision,mode", [("bfloat16", "tf32"), ("tensorfloat32", "tf32"),
                                            ("float32", "ieee"), ("highest", "ieee"),
                                            (None, "ieee")])
def test_precision_applies_inside_the_step_and_is_restored(models, utterances, precision, mode):
    """Each JAX value maps to one torch fp32 precision for CUDA matmuls and
    cuDNN convolutions, set inside the step and restored after it."""
    enhancer = enhance.Enhancer(models[2], quantum=4000, matmul_precision=precision,
                                device="cpu")
    seen = []
    step = enhancer._enhance

    def watched(noisy):
        seen.append(_flags())
        return step(noisy)

    enhancer._enhance = watched
    before = _flags()
    out = enhancer.enhance(utterances[:2], batch_size=2)
    assert seen == [(mode, mode)]
    assert _flags() == before
    assert [len(o) for o in out] == LENGTHS[:2]


def test_precision_is_restored_when_the_step_raises(models):
    enhancer = enhance.Enhancer(models[2], quantum=4000, device="cpu")

    def fails(noisy):
        assert _flags() == ("tf32", "tf32")
        raise RuntimeError("step failed")

    enhancer._enhance = fails
    before = _flags()
    with pytest.raises(RuntimeError, match="step failed"):
        enhancer.enhance_batch(np.zeros((1, 4000), np.float32))
    assert _flags() == before


@pytest.mark.parametrize("precision", ["bf16", "fastest", "BFLOAT16"])
def test_unknown_precision_raises(models, precision):
    with pytest.raises(ValueError):
        enhance.Enhancer(models[2], matmul_precision=precision, device="cpu")


def test_enhancer_cuda_absent_raises(models):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError):
        enhance.Enhancer(models[2], device="cuda")
