"""The port's int8 serving convolutions (speech_enhancement_tpu_torch/ops/int8.py)
against the JAX package's (speech_enhancement_tpu/ops/int8.py), on the CPU,
where the port multiplies the int8 values as fp32 (exact: a tap sums at most
256 products of at most 127^2, under 2^24).

* ``quantize_symmetric``: the same int8 values and the same scales, per
  tensor and per output channel;
* ``int8_conv2d`` over strides (1, 2) and dilations (1, 2, 4, 8): relative
  1e-6 (measured: bitwise equal), and within 0.02 of the float conv, as
  tests/test_int8.py holds JAX's;
* ``TSCNet(16, 201, quantized_convs=True)``: 15 int8 convs, the float
  model's state_dict keys and shapes, the float model's weights loading
  into it; from the JAX quantized model's converted weights its output
  against the JAX quantized output: its first int8 conv on JAX's input to
  1e-6, the whole output to 0.05 (int8 rounding flips; see the test);
* the ``Enhancer`` serves the quantized model on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_enhancement_tpu.models import TSCNet as FlaxTSCNet
from speech_enhancement_tpu.ops import compressed_stft as jax_compressed_stft
from speech_enhancement_tpu.ops.int8 import int8_conv2d as jax_int8_conv2d
from speech_enhancement_tpu.ops.int8 import quantize_symmetric as jax_quantize_symmetric
from speech_enhancement_tpu_torch.enhance import Enhancer
from speech_enhancement_tpu_torch.models import TSCNet
from speech_enhancement_tpu_torch.ops import int8
from speech_enhancement_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def test_quantize_symmetric_matches_jax(rng):
    x = rng.standard_normal((2, 12, 10, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal((2, 3, 16, 8))).astype(np.float32)
    jq, js = jax_quantize_symmetric(jnp.asarray(x))
    q, s = int8.quantize_symmetric(nchw(x))
    assert q.dtype == torch.int8
    assert torch.equal(q, nchw(jq))
    assert float(s) == float(js)
    jq, js = jax_quantize_symmetric(jnp.asarray(w), axis=(0, 1, 2))
    q, s = int8.quantize_symmetric(oihw(w), dim=(1, 2, 3))
    assert torch.equal(q, oihw(jq))
    assert torch.equal(s.reshape(-1), torch.from_numpy(np.asarray(js).reshape(-1)))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_int8_conv2d_matches_jax(rng, stride, dilation):
    x = rng.standard_normal((2, 20, 11, 16)).astype(np.float32)
    w = rng.standard_normal((2, 3, 16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    for strides, dilations in (((stride, 1), (dilation, 1)), ((1, stride), (1, 1))):
        want = jax_int8_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               strides=strides, dilation=dilations)
        got = int8.int8_conv2d(nchw(x), oihw(w), torch.from_numpy(b), stride=strides,
                               dilation=dilations)
        want = nchw(want)
        assert got.shape == want.shape
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


def test_int8_conv2d_close_to_float_conv(rng):
    x = torch.from_numpy(rng.standard_normal((2, 32, 12, 10)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((16, 32, 2, 3))).astype(np.float32))
    got = int8.int8_conv2d(x, w)
    want = F.conv2d(x, w)
    rel = float(torch.sqrt(torch.mean((got - want) ** 2) / torch.mean(want ** 2)))
    assert rel < 0.02, rel  # about 8-bit quantization noise


def test_quant_conv_pads_as_the_float_conv(rng):
    conv = torch.nn.Conv2d(8, 8, (1, 3), (1, 2), (0, 1))
    quant = int8.QuantConv2d(8, 8, (1, 3), (1, 2), (0, 1))
    quant.load_state_dict(conv.state_dict())
    x = torch.from_numpy(rng.standard_normal((2, 8, 5, 21)).astype(np.float32))
    got = quant(x)
    want = int8.int8_conv2d(F.pad(x, (1, 1, 0, 0)), conv.weight, conv.bias, stride=(1, 2))
    assert torch.equal(got, want)
    assert got.shape == conv(x).shape


def spec_input(seed=0, length=8000):
    x = 0.1 * np.random.default_rng(seed).standard_normal((1, length)).astype(np.float32)
    return jax_compressed_stft(jnp.asarray(x), 400, 100)


def test_quantized_tscnet_matches_jax_quantized_model():
    """The JAX quantized model's converted weights in the port's quantized
    model.  On JAX's input to it, the first int8 conv (the encoder's dense
    block's) gives JAX's output to a relative RMS < 1e-6.  The whole
    model's output is held to JAX's to < 0.05 (measured 2.05e-2; the float
    model agrees to 1.6e-6): the two sides' float layers round differently
    (6e-7 at the dense block's input; the rescale and the InstanceNorm
    after each int8 conv add theirs), an activation within that of a half
    step of its int8 grid takes the neighbouring value (the dense block
    alone, on JAX's input, already ends 4.3e-4 away), and every later int8
    conv re-quantizes, so that the distance grows to the int8 noise itself
    (tests/test_int8.py holds int8 against float to 0.25 at random
    init)."""
    spec = spec_input()
    flax_model = FlaxTSCNet(num_channel=16, num_features=201, quantized_convs=True)
    variables = flax_model.init({"params": jax.random.PRNGKey(0),
                                 "dropout": jax.random.PRNGKey(1)}, spec, deterministic=True)
    (want_re, want_im), captured = flax_model.apply(variables, spec, deterministic=True,
                                                    capture_intermediates=True)
    encoder = captured["intermediates"]["dense_encoder"]
    dense_in = nchw(encoder["prelu1"]["__call__"][0])
    conv1_out = nchw(encoder["dense"]["conv1"]["__call__"][0])
    host = jax.tree_util.tree_map(np.asarray, variables)
    float_model = TSCNet(16, 201, device="cpu")
    model = TSCNet(16, 201, quantized_convs=True, device="cpu")
    assert sum(isinstance(m, int8.QuantConv2d) for m in model.modules()) == 15
    float_keys = {k: v.shape for k, v in float_model.state_dict().items()}
    assert {k: v.shape for k, v in model.state_dict().items()} == float_keys
    for a, b in zip(float_model.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)  # the same initial values
    model.load_state_dict(state_dict_from_flax(host["params"], host["batch_stats"]),
                          strict=True)
    model.eval()
    sp = torch.from_numpy(np.asarray(spec))
    with torch.no_grad():
        re, im = model(sp)
        conv1 = model.dense_encoder.dilated_dense.conv1(F.pad(dense_in, (1, 1, 1, 0)))
    assert rel_rms(conv1, conv1_out) < 1e-6
    want = np.stack([np.asarray(want_re), np.asarray(want_im)])
    assert rel_rms(torch.stack([re, im]), want) < 0.05


def test_enhancer_serves_the_quantized_model():
    """On the CPU, close to the float model (tests/test_int8.py's random-init
    bound, 0.25), and the float model's weights load unchanged."""
    rng = np.random.default_rng(2)
    utts = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 4100)]
    float_model = TSCNet(16, 201, device="cpu", generator=torch.Generator().manual_seed(4))
    model = TSCNet(16, 201, quantized_convs=True, device="cpu")
    model.load_state_dict(float_model.state_dict())
    want = Enhancer(float_model, quantum=4000, device="cpu").enhance(utts)
    got = Enhancer(model, quantum=4000, device="cpu").enhance(utts)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2)) < 0.25
