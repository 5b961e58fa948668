"""The port's standalone-CDiffuSE inference and conversion
(speech_enhancement_tpu_torch/cli/cdiffuse_inference.py and the
``weights.pt`` branch of cli/convert_checkpoint.py) against the JAX
package's, on the CPU, at small width (DiffuSE 8 channels, 4 layers, no
GroupNorm), on weights carried from the flax module
(``utils.convert.diffuse_state_dict_from_flax(use_groupnorm=False)``):

* ``predict`` equals JAX ``predict`` on the same weights and on JAX's
  per-step draws (replayed as ``noises``) over the fast schedule, within
  relative RMS 1e-4, for a checkpoint of the learner (hop 100, 201 bins:
  ``auto`` is the |STFT|, by the kernel route and the plain one; ``se``;
  ``mel``) and for a converted upstream-style ``weights.pt`` (hop 256, 80
  bins, a dilation cycle of 3 and a 6-step schedule from its ``params``:
  ``auto`` is ``mel``; ``se``), at an odd length (16037 samples);
* the converters of both packages turn one ``weights.pt`` into the same
  model (outputs within relative RMS 1e-5); the port's writes the weights
  bit for bit, the model's outputs equal the source's bit for bit, and
  ``params.json`` carries the dilation cycle and both schedules;
* which STFT route each geometry takes: K4's wrapper at n_fft 400 / hop
  100, ``ops/stft.py`` at hop 256 (``fused_stft.supports``) and with
  ``plain``; the host conditioners run no STFT on the device;
* ``cli.cdiffuse_inference`` on a learner checkpoint and a converted one:
  finite outputs in [-1, 1], cut to the input's length where the sampled
  buffer reaches it, one cached model per checkpoint, the route printed;
  without ``--device cpu`` it raises on a host without a card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_enhancement_tpu.cli.cdiffuse_inference as jax_ci
from speech_enhancement_tpu.cli.convert_checkpoint import _infer_diffuse_model
from speech_enhancement_tpu.models import DiffuSE as FlaxDiffuSE
from speech_enhancement_tpu.utils.convert_torch import convert_checkpoint as jax_convert
from speech_enhancement_tpu_torch.cli import cdiffuse_inference as ci
from speech_enhancement_tpu_torch.cli import convert_checkpoint
from speech_enhancement_tpu_torch.data import save_wav
from speech_enhancement_tpu_torch.models import DiffuSE
from speech_enhancement_tpu_torch.ops import fused_stft
from speech_enhancement_tpu_torch.ops.stft import compressed_stft
from speech_enhancement_tpu_torch.train import ModuleState
from speech_enhancement_tpu_torch.train import diffusion as diffusion_mod
from speech_enhancement_tpu_torch.train.learner import DiffuSELearner
from speech_enhancement_tpu_torch.utils import load_variables
from speech_enhancement_tpu_torch.utils.convert import diffuse_state_dict_from_flax

torch.set_num_threads(1)

FAST = [0.0001, 0.001, 0.01, 0.05, 0.2, 0.35]
UPSTREAM = dict(hop_length=256, n_specs=80, dilation_cycle_length=3, num_steps=6)
UPSTREAM_PARAMS = {"dilation_cycle_length": 3, "noise_schedule": FAST,
                   "inference_noise_schedule": FAST, "batch_size": 16}
LENGTH = 16037


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def flax_diffuse(seed, **kw):
    """A flax no-GroupNorm DiffuSE at width 8, 4 layers, its params perturbed
    (the output conv starts at zero), and the port's state_dict of them."""
    model = FlaxDiffuSE(residual_channels=8, residual_layers=4, use_groupnorm=False, **kw)
    hop, bins = kw.get("hop_length", 100), kw.get("n_specs", 201)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4 * hop)),
                           jnp.zeros((1, 4, bins)), jnp.array([0]))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32),
        variables["params"])
    return model, {"params": params}, diffuse_state_dict_from_flax(params, use_groupnorm=False)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A learner run's directory (hop 100, 201 bins, the learner's dilation
    cycle 10) and a converted upstream weights.pt (hop 256, 80 bins, cycle
    3, 6 steps), each with the flax model and variables JAX serves them
    with."""
    root = tmp_path_factory.mktemp("cdiffuse_ckpt")
    learner_flax, learner_vars, learner_sd = flax_diffuse(1)
    model = DiffuSE(residual_channels=8, residual_layers=4, use_groupnorm=False, device="cpu")
    model.load_state_dict(learner_sd)
    DiffuSELearner(str(root / "learner"), ModuleState(model, torch.optim.Adam(
        model.parameters(), lr=2e-4)), [], None, None).save_to_checkpoint()

    up_flax, _, up_sd = flax_diffuse(2, **UPSTREAM)
    weights = root / "weights.pt"
    torch.save({"step": 1234, "model": up_sd, "optimizer": {}, "params": UPSTREAM_PARAMS},
               weights)
    assert convert_checkpoint.main([str(weights), str(root / "converted")]) == 0
    jax_side = jax_convert(str(weights))
    assert jax_side["params"] == {k: UPSTREAM_PARAMS[k] for k in
                                  ("dilation_cycle_length", "noise_schedule",
                                   "inference_noise_schedule")}
    up_flax = _infer_diffuse_model(jax_side["model"], jax_side["params"])
    return {"learner": (str(root / "learner"), learner_flax, learner_vars, {}),
            "converted": (str(root / "converted"), up_flax, jax_side["model"],
                          jax_side["params"]),
            "weights": (weights, up_sd), "root": root}


def jax_step_noises(key, shape, n_steps):
    """The normals JAX's ``lax.scan`` sampler draws at each step from
    ``key`` (``step_rng, sub = split(step_rng)``), in the order run."""
    out, step_rng = [], key
    for _ in range(n_steps):
        step_rng, sub = jax.random.split(step_rng)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


@pytest.fixture
def jax_serves(monkeypatch):
    """JAX ``predict`` on given flax weights: its model caches, keyed by the
    directory's absolute path, filled (the JAX loader reads orbax
    checkpoints, which these directories are not)."""
    def serve(model_dir, flax_model, variables, saved):
        key = os.path.abspath(model_dir)
        monkeypatch.setitem(jax_ci._model_cache, key, (flax_model, variables))
        monkeypatch.setitem(jax_ci._saved_params_cache, key, saved)
    return serve


@pytest.mark.parametrize("which, mode, plain", [
    ("learner", "auto", False), ("learner", "auto", True), ("learner", "se", False),
    ("learner", "mel", False), ("converted", "auto", False), ("converted", "se", False)])
def test_predict_matches_jax(checkpoints, jax_serves, which, mode, plain):
    model_dir, flax_model, variables, saved = checkpoints[which]
    jax_serves(model_dir, flax_model, variables, saved)
    noisy = (0.3 * np.random.default_rng(3).standard_normal(LENGTH)).astype(np.float32)
    want = jax_ci.predict(noisy, model_dir, fast=True, seed=23, conditioner=mode)
    model, _ = ci.load_model(model_dir, "cpu")
    cond = ci._conditioner_for(model, noisy, mode)
    frames = cond.shape[1] if cond is not None else LENGTH // model.hop_length
    noises = jax_step_noises(jax.random.PRNGKey(23), (1, model.hop_length * frames), 6)
    got = ci.predict(noisy, model_dir, fast=True, conditioner=mode, noises=noises, plain=plain,
                     device="cpu")
    assert got.shape == want.shape == (min(LENGTH, model.hop_length * frames),)
    assert np.isfinite(got).all() and np.abs(got).max() <= 1.0
    assert rel_rms(got, want) < 1e-4


def test_converters_of_both_packages_agree(checkpoints):
    weights, source_sd = checkpoints["weights"]
    out = checkpoints["root"] / "converted"
    converted = load_variables(str(out))["model"]
    assert set(converted) == set(source_sd)
    for key, value in source_sd.items():
        assert torch.equal(converted[key], value), key
    params = json.loads((out / "params.json").read_text())
    assert params == {k: UPSTREAM_PARAMS[k] for k in
                      ("dilation_cycle_length", "noise_schedule", "inference_noise_schedule")}
    model = convert_checkpoint.diffuse_from_state_dict(converted, params)
    model.load_state_dict(converted)
    assert [b.dilated_conv.dilation[0] for b in model.residual_layers] == [1, 2, 4, 1]
    assert model.diffusion_embedding.embedding.shape[0] == 6 and model.hop_length == 256
    source = DiffuSE(residual_channels=8, residual_layers=4, use_groupnorm=False, device="cpu",
                     **UPSTREAM)
    source.load_state_dict(source_sd)
    rng = np.random.default_rng(4)
    audio = torch.from_numpy((0.3 * rng.standard_normal((2, 2560))).astype(np.float32))
    cond = torch.from_numpy(rng.random((2, 10, 80)).astype(np.float32))
    t = torch.tensor([1.5, 4.0])
    with torch.no_grad():
        got, want = model.eval()(audio, cond, t), source.eval()(audio, cond, t)
    assert torch.equal(got, want)
    _, flax_model, variables, saved = checkpoints["converted"]
    assert flax_model.dilation_cycle_length == 3 and flax_model.hop_length == 256
    jout = flax_model.apply(variables, audio.numpy(), cond.numpy(), t.numpy())
    assert rel_rms(got.numpy(), np.asarray(jout)) < 1e-5


def test_weights_pt_with_groupnorm_keys_does_not_fit(tmp_path):
    sd = DiffuSE(residual_channels=16, residual_layers=2, device="cpu").state_dict()
    torch.save({"step": 1, "model": sd}, tmp_path / "weights.pt")
    with pytest.raises(SystemExit, match="do not fit"):
        convert_checkpoint.main([str(tmp_path / "weights.pt"), str(tmp_path / "out")])


def test_stft_route_by_geometry(checkpoints, tmp_path, monkeypatch):
    """K4 where ``fused_stft.supports`` holds (n_fft 400, hop 100), else
    ``ops/stft.py`` (hop 256, and ``plain``): the route the geometry picks,
    not a fallback.  The se and mel conditioners run no STFT."""
    assert diffusion_mod._featurizers(400, 100, "none", False)[0] is fused_stft.fused_stft
    assert diffusion_mod._featurizers(400, 256, "none", False)[0] is compressed_stft
    assert diffusion_mod._featurizers(400, 100, "none", True)[0] is compressed_stft
    calls = {"fused": 0, "plain": 0}
    real_fused, real_plain = fused_stft.fused_stft, diffusion_mod.compressed_stft

    def fused(*a, **k):
        calls["fused"] += 1
        return real_fused(*a, **k)

    def plain(*a, **k):
        calls["plain"] += 1
        return real_plain(*a, **k)

    monkeypatch.setattr(fused_stft, "fused_stft", fused)
    monkeypatch.setattr(diffusion_mod, "compressed_stft", plain)
    wide = DiffuSE(residual_channels=8, residual_layers=2, hop_length=256, use_groupnorm=False,
                   device="cpu")
    (tmp_path / "wide").mkdir()
    torch.save({"model": wide.state_dict()}, tmp_path / "wide" / "variables.pt")
    noisy = (0.3 * np.random.default_rng(5).standard_normal(6000)).astype(np.float32)
    learner_dir = checkpoints["learner"][0]
    cases = [(learner_dir, "auto", False, (1, 0)), (learner_dir, "stft", True, (0, 1)),
             (learner_dir, "se", False, (0, 0)), (learner_dir, "mel", False, (0, 0)),
             (str(tmp_path / "wide"), "stft", False, (0, 1))]
    for model_dir, mode, use_plain, want in cases:
        calls.update(fused=0, plain=0)
        ci.predict(noisy, model_dir, fast=True, conditioner=mode, plain=use_plain, device="cpu")
        assert (calls["fused"], calls["plain"]) == want, (model_dir, mode, use_plain)
    model, _ = ci.load_model(learner_dir, "cpu")
    assert ci.conditioner_route(model, "auto").startswith("stft: |STFT| at n_fft 400, hop 100 "
                                                          "through K4's wrapper")
    wide_model, _ = ci.load_model(str(tmp_path / "wide"), "cpu")
    assert "ops/stft.py" in ci.conditioner_route(wide_model, "stft")
    assert ci.conditioner_route(wide_model, "auto").startswith("se: make_spectrum at n_fft 400")


@pytest.fixture(scope="module")
def noisy_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cdiffuse_noisy")
    rng = np.random.default_rng(6)
    for i, length in enumerate((16037, 4000)):
        t = np.arange(length) / 16000
        save_wav(root / f"p{i}.wav", (0.3 * np.sin(2 * np.pi * 220 * t)
                                      + 0.05 * rng.standard_normal(length)).astype(np.float32))
    return root


@pytest.mark.parametrize("which, mode, cut", [("learner", "auto", 100), ("learner", "se", 1),
                                              ("converted", "auto", 1)])
def test_inference_cli(checkpoints, noisy_dir, tmp_path, capsys, which, mode, cut):
    model_dir = checkpoints[which][0]
    ci._model_cache.clear()
    results = ci.main(["--model-dir", model_dir, "--noisy", str(noisy_dir), "-o",
                       str(tmp_path), "--fast", "--conditioner", mode, "--device", "cpu"])
    assert len(ci._model_cache) == 1
    assert [os.path.basename(p) for p, _ in results] == ["p0.wav", "p1.wav"]
    for (path, est), length in zip(results, (16037, 4000)):
        # the |STFT| conditioner spans hop * (L // hop) samples, the host
        # conditioners hop * (1 + L // hop)
        assert len(est) == length - length % cut and os.path.exists(path)
        assert np.isfinite(est).all() and np.abs(est).max() <= 1.0
    assert "conditioner " + mode.replace("auto", "stft" if which == "learner" else "mel") \
        in capsys.readouterr().out


def test_inference_cli_needs_a_card_unless_told_cpu(checkpoints, noisy_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ci.main(["--model-dir", checkpoints["learner"][0], "--noisy", str(noisy_dir), "-o",
                 str(tmp_path)])
