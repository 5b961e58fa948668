"""The port's standalone-CDiffuSE training (speech_enhancement_tpu_torch/
train/learner.py, cli/cdiffuse.py and ``diffuse_step(return_grad_norm=
True)``) against the JAX package's, on the CPU, at small width (DiffuSE 8
channels, 4 layers, no GroupNorm, hop 100; crops of 2000-4000 samples):

* ``diffuse_step(return_grad_norm=True)`` with Adam on JAX's draws: the
  loss within rtol 1e-5 of JAX's and the gradients' global norm within
  rtol 1e-4 (``optax.global_norm``, the last residual conv's zero gradient
  included); without the flag the step returns the loss alone;
* the learner's batches and step seeds over 2.5 passes, stopped at a
  mid-pass ``max_steps``, checkpointed and restored, equal an uninterrupted
  run's, and the weights after it equal the uninterrupted run's bit for
  bit; ``set_epoch`` runs on every pass;
* the batches equal the JAX learner's over the same corpus and seed, from
  the start and from a mid-pass resume (both learners' steps
  monkeypatched to record ``batch.audio``);
* the NaN guard raises; ``weights/`` is the latest checkpoint;
  ``summary.jsonl`` and the summary wav and spectrogram (``make_spectrum``
  of the audio, or a ``SpecBatch``'s own);
* ``load_pretrain_params`` keeps exactly the conditioner and input
  projections fresh, and a key whose shape differs;
* ``cli.cdiffuse``: a short run, its resume equal bit for bit to a straight
  run, and without ``--device cpu`` a ``RuntimeError`` on a host without a
  card.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import speech_enhancement_tpu.train.learner as jax_learner_mod
from speech_enhancement_tpu.data import Collator as JaxCollator
from speech_enhancement_tpu.data import DataLoader as JaxDataLoader
from speech_enhancement_tpu.data import VoicebankDataset as JaxVoicebankDataset
from speech_enhancement_tpu.models import DiffuSE as FlaxDiffuSE
from speech_enhancement_tpu.train import diffuse_step as jax_diffuse_step
from speech_enhancement_tpu.train import l1_loss as jax_l1_loss
from speech_enhancement_tpu.train.state import ModuleState as JaxModuleState
from speech_enhancement_tpu_torch.cli import cdiffuse
from speech_enhancement_tpu_torch.data import (
    Collator,
    DataLoader,
    SpecBatch,
    VoicebankDataset,
    save_wav,
)
from speech_enhancement_tpu_torch.data.preprocess import make_spectrum
from speech_enhancement_tpu_torch.models import DiffuSE
from speech_enhancement_tpu_torch.train import (
    ModuleState,
    diffuse_step,
    l1_loss,
    linear_noise_schedule,
)
from speech_enhancement_tpu_torch.train import learner as learner_mod
from speech_enhancement_tpu_torch.utils import load_checkpoint
from speech_enhancement_tpu_torch.utils.convert import diffuse_state_dict_from_flax

torch.set_num_threads(1)

SCHEDULE = linear_noise_schedule(50)
SMALL = dict(residual_channels=8, residual_layers=4, use_groupnorm=False)
CROP = 20  # frames of 100 samples


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five pairs of 0.4-0.6 s tone-plus-noise wavs: two batches of 2 a pass."""
    root = tmp_path_factory.mktemp("cdiffuse_corpus")
    clean_dir, noisy_dir = root / "clean", root / "noisy"
    clean_dir.mkdir()
    noisy_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        t = np.arange(int(rng.integers(6400, 9600))) / 16000
        clean = (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t)).astype(np.float32)
        save_wav(clean_dir / f"p{i}.wav", clean)
        save_wav(noisy_dir / f"p{i}.wav",
                 clean + 0.05 * rng.standard_normal(len(t)).astype(np.float32))
    return str(clean_dir), str(noisy_dir)


def port_loader(corpus, seed=3):
    return DataLoader(VoicebankDataset(*corpus, 100, CROP), 2,
                      Collator(100, CROP, rng=np.random.default_rng(seed), silence_check=False),
                      shuffle=True, seed=seed, num_workers=2)


def small_state(seed=0):
    model = DiffuSE(**SMALL, device="cpu", generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # the zero-initialized output conv moves
        model.output_projection.weight.normal_(0.0, 0.05,
                                               generator=torch.Generator().manual_seed(seed + 1))
    return ModuleState(model, torch.optim.Adam(model.parameters(), lr=2e-4))


def make_learner(model_dir, state, loader, **kw):
    return learner_mod.DiffuSELearner(str(model_dir), state, loader, SCHEDULE, l1_loss, **kw)


@pytest.fixture
def recorded(monkeypatch):
    """The real step, recording (step, seed, clean batch) of every call."""
    calls = []
    real = learner_mod.diffuse_step

    def step(state, clean, noisy, schedule, seed, **kw):
        calls.append((state.step, seed, clean.numpy().copy()))
        return real(state, clean, noisy, schedule, seed, **kw)

    monkeypatch.setattr(learner_mod, "diffuse_step", step)
    return calls


def test_diffuse_step_grad_norm_matches_jax():
    flax_model = FlaxDiffuSE(residual_channels=8, residual_layers=4, use_groupnorm=False)
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4000)),
                                jnp.zeros((1, 40, 201)), jnp.array([0]))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32),
        variables["params"])
    clean = (0.1 * rng.standard_normal((2, 4000))).astype(np.float32)
    noisy = (clean + 0.02 * rng.standard_normal((2, 4000))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    tx = optax.adam(2e-4)
    _, want_loss, want_norm = jax_diffuse_step(
        JaxModuleState(params=params, extra={}, opt_state=tx.init(params), step=0),
        jnp.asarray(clean), jnp.asarray(noisy), jnp.asarray(SCHEDULE, jnp.float32), key,
        model=flax_model, criterion=jax_l1_loss, tx=tx, return_grad_norm=True)

    rng_t, rng_n = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(rng_t, (2,), 0, 50)))
    noise = torch.from_numpy(np.array(jax.random.normal(rng_n, (2, 4000), jnp.float32)))
    port = DiffuSE(**SMALL, device="cpu")
    port.load_state_dict(diffuse_state_dict_from_flax(params, use_groupnorm=False))
    state = ModuleState(port, torch.optim.Adam(port.parameters(), lr=2e-4))
    loss, norm = diffuse_step(state, torch.from_numpy(clean), torch.from_numpy(noisy), SCHEDULE,
                              0, criterion=l1_loss, t=t, noise=noise, return_grad_norm=True)
    assert state.step == 1 and norm.ndim == 0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-4)
    # without the flag: the loss alone; without an update: a zero norm
    only = diffuse_step(state, torch.from_numpy(clean), torch.from_numpy(noisy), SCHEDULE, 0,
                        criterion=l1_loss, t=t, noise=noise)
    assert isinstance(only, torch.Tensor) and only.ndim == 0 and state.step == 2
    _, zero = diffuse_step(state, torch.from_numpy(clean), torch.from_numpy(noisy), SCHEDULE, 0,
                           criterion=l1_loss, train=False, return_grad_norm=True)
    assert float(zero) == 0.0 and state.step == 2


def test_resume_mid_pass_continues_the_straight_run(corpus, tmp_path, recorded):
    epochs = []
    straight = make_learner(tmp_path / "straight", small_state(), port_loader(corpus))
    real_set_epoch = straight.dataset.set_epoch
    straight.dataset.set_epoch = lambda e: (epochs.append(e), real_set_epoch(e))
    straight.train(max_steps=5, rng_seed=11)
    assert epochs == [0, 1, 2] and straight.step == 5
    want = list(recorded)
    recorded.clear()

    first = make_learner(tmp_path / "stopped", small_state(), port_loader(corpus))
    first.train(max_steps=3, rng_seed=11)  # stops at pass 1, batch 1
    first.save_to_checkpoint()
    resumed = make_learner(tmp_path / "stopped", small_state(seed=9), port_loader(corpus))
    assert resumed.restore_from_checkpoint() and resumed.step == 3
    resumed.train(max_steps=5, rng_seed=11)
    assert [c[:2] for c in recorded] == [c[:2] for c in want]
    assert [c[1] for c in want] == [learner_mod.step_seed(11, s) for s in range(5)]
    for (_, _, got), (_, _, exp) in zip(recorded, want):
        np.testing.assert_array_equal(got, exp)
    for key, value in straight.state.model.state_dict().items():
        assert torch.equal(resumed.state.model.state_dict()[key], value), key
    adam = resumed.state.opt.state_dict()["state"]
    assert all(float(s["step"]) == 5 for s in adam.values())


def test_batches_equal_the_jax_learner(corpus, tmp_path, monkeypatch):
    got, want = [], []
    monkeypatch.setattr(learner_mod, "diffuse_step", lambda state, clean, noisy, *a, **k: (
        got.append(clean.numpy().copy()), (torch.tensor(0.1), torch.tensor(0.0)))[1])
    monkeypatch.setattr(jax_learner_mod, "diffuse_step", lambda state, audio, *a, **k: (
        want.append(np.asarray(audio).copy()), (state, np.float32(0.1), np.float32(0.0)))[1])
    jax_loader = JaxDataLoader(JaxVoicebankDataset(*corpus, 100, CROP), 2,
                               JaxCollator(100, CROP, rng=np.random.default_rng(3),
                                           silence_check=False),
                               shuffle=True, seed=3, num_workers=2)
    for start in (0, 3):
        got.clear()
        want.clear()
        jax_side = jax_learner_mod.DiffuSELearner(
            str(tmp_path / "jax"), model=None, state=types.SimpleNamespace(step=start), tx=None,
            dataset=jax_loader, noise_schedule=None, criterion=None, summary_every=10_000)
        monkeypatch.setattr(jax_side, "save_to_checkpoint", lambda *a, **k: None)
        jax_side.train(max_steps=6)
        state = small_state()
        state.step = start
        port = make_learner(tmp_path / "port", state, port_loader(corpus), summary_every=10_000)
        monkeypatch.setattr(port, "save_to_checkpoint", lambda *a, **k: None)
        port.train(max_steps=6)
        assert len(got) == len(want) == 6 - start
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_nan_loss_raises(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(learner_mod, "diffuse_step",
                        lambda *a, **k: (torch.tensor(float("nan")), torch.tensor(0.0)))
    learner = make_learner(tmp_path, small_state(), port_loader(corpus))
    with pytest.raises(RuntimeError, match=r"^Detected NaN loss at step 0\.$"):
        learner.train(max_steps=2)


def test_checkpoints_and_summaries(corpus, tmp_path, recorded):
    learner = make_learner(tmp_path, small_state(), port_loader(corpus), summary_every=2)
    learner.train(max_steps=5, rng_seed=1)
    learner.save_to_checkpoint()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert {"checkpoint_0002", "checkpoint_0004", "checkpoint_0005", "weights",
            "summary.jsonl", "summaries"} <= set(names)
    for ckpt in ("checkpoint_0005", "weights"):
        saved = load_checkpoint(str(tmp_path / ckpt))
        assert saved["step"] == 5
        for key, value in learner.state.model.state_dict().items():
            assert torch.equal(saved["model"][key], value), key
    lines = [json.loads(x) for x in (tmp_path / "summary.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 2, 4]
    assert all(set(x) == {"step", "loss", "grad_norm", "step_time"} and x["grad_norm"] > 0
               and np.isfinite(x["loss"]) for x in lines)
    for step, _, clean in recorded[::2]:
        spec = np.load(tmp_path / "summaries" / f"step_{step:06d}_spectrogram.npy")
        want, _, _ = make_spectrum(y=clean[0], frame_length=400, shift=100)
        np.testing.assert_array_equal(spec, want)
        assert (tmp_path / "summaries" / f"step_{step:06d}_audio.wav").exists()


def test_spec_batch_summary_keeps_its_spectrogram(tmp_path, monkeypatch):
    monkeypatch.setattr(learner_mod, "diffuse_step",
                        lambda *a, **k: (torch.tensor(0.5), torch.tensor(0.25)))
    spec = np.random.default_rng(2).random((2, 20, 201)).astype(np.float32)
    audio = np.zeros((2, 2000), np.float32)
    learner = make_learner(tmp_path, small_state(), [SpecBatch(audio, audio, spec)])
    learner.train(max_steps=1)
    np.testing.assert_array_equal(np.load(tmp_path / "summaries" / "step_000000_spectrogram.npy"),
                                  spec[0])
    line = json.loads((tmp_path / "summary.jsonl").read_text())
    assert line["loss"] == 0.5 and line["grad_norm"] == 0.25


def test_load_pretrain_params_keeps_the_projections_fresh():
    fresh, pretrained = small_state(seed=0), small_state(seed=5)
    with torch.no_grad():  # every entry differs from the fresh model's (biases start at 0)
        for p in pretrained.model.parameters():
            p.add_(0.1)
    before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    out = learner_mod.load_pretrain_params(fresh, pretrained)
    assert out is fresh
    kept = []
    for key, value in fresh.model.state_dict().items():
        if torch.equal(value, before[key]):
            kept.append(key)
        else:
            assert torch.equal(value, pretrained.model.state_dict()[key]), key
    assert kept == [k for k in before
                    if "conditioner_projection" in k or "input_projection" in k]
    # another hop: the upsampler's shapes differ, and those keys stay fresh too
    other = DiffuSE(**SMALL, hop_length=256, device="cpu")
    learner_mod.load_pretrain_params(ModuleState(other), pretrained)
    assert other.spectrogram_upsampler.conv1.weight.shape[-1] == 32
    assert torch.equal(other.skip_projection.weight, pretrained.model.skip_projection.weight)


@pytest.fixture
def small_cli(monkeypatch):
    monkeypatch.setattr(cdiffuse, "PARAMS", dict(cdiffuse.PARAMS, residual_channels=8,
                                                 residual_layers=4, crop_mel_frames=CROP))


def run_cli(model_dir, corpus, *extra):
    return cdiffuse.main([str(model_dir), *corpus, "--batch-size", "2", "-j", "1", "--seed", "4",
                          "--device", "cpu", *extra])


def test_cdiffuse_cli_resume_is_bit_exact(corpus, tmp_path, small_cli):
    straight = run_cli(tmp_path / "straight", corpus, "--max-steps", "5")
    assert straight.step == 5 and (tmp_path / "straight" / "weights" / "state.pt").exists()
    assert (tmp_path / "straight" / "summary.jsonl").exists()
    run_cli(tmp_path / "resumed", corpus, "--max-steps", "3")
    resumed = run_cli(tmp_path / "resumed", corpus, "--max-steps", "5")
    assert resumed.step == 5
    for key, value in straight.state.model.state_dict().items():
        assert torch.equal(resumed.state.model.state_dict()[key], value), key
    model = straight.state.model
    assert not hasattr(model.residual_layers[0].dilated_conv, "__getitem__")  # no GroupNorm
    assert isinstance(straight.state.opt, torch.optim.Adam)
    assert straight.state.opt.defaults["lr"] == 2e-4


def test_cdiffuse_cli_needs_a_card_unless_told_cpu(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cdiffuse.main([str(tmp_path), *corpus, "--max-steps", "1"])
