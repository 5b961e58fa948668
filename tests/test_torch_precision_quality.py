"""The port's serving precision check (speech_enhancement_tpu_torch/scripts/
check_precision_quality.py) against scripts/check_precision_quality.py, on
the CPU.

* ``speechy_batch`` is bitwise the JAX script's;
* at ``TSCNet(16, 201)`` on weights carried across from flax
  (``utils/convert.py``), the port's reference (unfused, IEEE) and its
  ``fp32`` mode (fused route, the Enhancer's default precision; on the CPU
  the kernels' plain versions and fp32 matmuls) are within relative RMS
  1e-4 of the JAX Enhancer's fp32 mode, and the port's ``bf16`` and
  ``bf16_fused`` within 0.35 of the JAX ``bf16`` mode: the bounds of
  tests/test_torch_enhance.py (fp32 parity; bf16's sanity bound: a
  random-init stack of eight conformers drifts 10-25% in bf16);
* its JSON lines carry the JAX script's keys (the JAX script run at the
  same small width), with finite scores, and one weight set serves every
  mode.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu import enhance as jax_enhance
from speech_enhancement_tpu import models as jax_models
from speech_enhancement_tpu.models import TSCNet as FlaxTSCNet
from speech_enhancement_tpu.ops import compressed_stft
from speech_enhancement_tpu_torch.models import TSCNet
from speech_enhancement_tpu_torch.scripts import check_precision_quality as cpq
from speech_enhancement_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

FP32_BOUND = 1e-4
BF16_BOUND = 0.35


def jax_script():
    old_cache = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    module = importlib.import_module("scripts.check_precision_quality")
    jax.config.update("jax_compilation_cache_dir", old_cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)
    return module


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


@pytest.mark.parametrize("batch, length", [(8, 32000), (3, 4000), (11, 777)])
def test_speechy_batch_is_bitwise_jax(batch, length):
    want = jax_script().speechy_batch(batch, length)
    got = cpq.speechy_batch(batch, length)
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def carried():
    """flax TSCNet(16, 201) variables and the same weights as a port
    state_dict, and a noisy batch of 2 x 0.5 s as the script makes it."""
    flax_model = FlaxTSCNet(num_channel=16, num_features=201)
    variables = flax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        compressed_stft(jnp.zeros((1, 8000)), 400, 100), deterministic=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return variables, state_dict_from_flax(variables["params"], variables["batch_stats"]), \
        cpq.noisy_batch(2, 8000)


def jax_mode(variables, noisy, dtype):
    """The JAX script's ``fp32`` (dtype None) or ``bf16`` mode: unfused, the
    Enhancer's default precision."""
    model = FlaxTSCNet(num_channel=16, num_features=201)
    enh = jax_enhance.Enhancer(model, variables, 400, 100, compute_dtype=dtype)
    return np.stack(enh.enhance(list(noisy), batch_size=2))


def test_fp32_modes_match_jax(carried):
    variables, sd, noisy = carried
    want = jax_mode(variables, noisy, None)
    for mode in (cpq.REFERENCE, cpq.MODES["fp32"]):
        got = cpq.enhance(sd, noisy, mode, "cpu", 2, num_channel=16)
        assert got.shape == want.shape == (2, 8000) and np.isfinite(got).all()
        assert rel_rms(got, want) < FP32_BOUND


def test_bf16_modes_match_jax(carried):
    variables, sd, noisy = carried
    want = jax_mode(variables, noisy, jnp.bfloat16)
    for name in ("bf16", "bf16_fused"):
        got = cpq.enhance(sd, noisy, cpq.MODES[name], "cpu", 2, num_channel=16)
        assert got.dtype == np.float32 and np.isfinite(got).all()
        assert rel_rms(got, want) < BF16_BOUND, name


def test_json_lines_have_the_jax_keys(monkeypatch, capsys):
    monkeypatch.setattr(cpq, "TSCNet",
                        lambda num_channel, num_features, **kw: TSCNet(16, num_features, **kw))
    results = cpq.main(["--batch", "2", "--seconds", "0.5", "--modes", "bf16", "fp32",
                        "fp32_int8", "--device", "cpu"])
    port_lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                  if line.startswith("{")]
    monkeypatch.setattr(jax_models, "TSCNet",
                        lambda num_channel, num_features, **kw: FlaxTSCNet(
                            num_channel=16, num_features=num_features, **kw))
    monkeypatch.setattr("sys.argv", ["check_precision_quality.py", "--batch", "2",
                                     "--seconds", "0.5", "--modes", "bf16"])
    jax_script().main()
    jax_lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                 if line.startswith("{")]
    assert [sorted(line) for line in port_lines[:-1]] == [sorted(jax_lines[0])] * 3
    assert sorted(port_lines[-1]) == sorted(jax_lines[-1]) == ["all", "gate_pesq"]
    assert port_lines[-1]["gate_pesq"] == jax_lines[-1]["gate_pesq"] == 4.5
    assert [line["mode"] for line in port_lines[:-1]] == ["bf16", "fp32", "fp32_int8"]
    assert port_lines[-1]["all"] == results
    for scores in results.values():
        assert sorted(scores) == sorted(jax_lines[-1]["all"]["bf16"])
        assert all(np.isfinite(v) for v in scores.values())
    # on the CPU the fp32 mode's matmuls are fp32: transparent
    assert results["fp32"]["rel_rms"] < 1e-4 and results["fp32"]["pesq_vs_fp32_min"] > 4.5


def test_one_weight_set_serves_every_mode():
    sd = cpq.seeded_weights(16)
    for mode in cpq.MODES.values():
        model = TSCNet(16, 201, fused_attention=mode["fused"], quantized_convs=mode["quantized"],
                       device="cpu")
        model.load_state_dict(sd, strict=True)
    again = cpq.seeded_weights(16)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
