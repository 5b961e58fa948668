"""The routing decision that puts the samplers' featurization on K4 and K5,
pinned on the CPU at each call site the quality scripts reach: standalone
CDiffuSE's |STFT| conditioner (``cli.cdiffuse_inference.predict`` at its
defaults on a learner-shaped checkpoint: n_fft 400, hop 100) and the
diffusion TSCNet's sampler (``cli.inference_diffuse.predict_batch``).

Each default call hands ``ops.fused_stft``'s wrappers, and no plain
featurization, the tensors their kernels take on a card (float32 or
complex64, contiguous, 2-D or 3-D: the wrapper raises on anything else
there), as many times as the sampler runs; ``plain=True`` takes
``ops/stft.py`` alone.  On the card, chip_smoke.py phase 11 checks the
same route by output: K4's 3xTF32 sums round otherwise than the plain
STFT's, so the two routes' samples differ, within 1e-4.
"""

import argparse

import numpy as np
import pytest
import torch

from speech_enhancement_tpu_torch.cli import cdiffuse_inference, inference_diffuse
from speech_enhancement_tpu_torch.config import load_config
from speech_enhancement_tpu_torch.models import DiffuSE, DiffusionTSCNet
from speech_enhancement_tpu_torch.ops import fused_stft
from speech_enhancement_tpu_torch.train import diffusion as diffusion_mod
from speech_enhancement_tpu_torch.train import inference_schedule, linear_noise_schedule

torch.set_num_threads(1)


@pytest.fixture
def recorded(monkeypatch):
    """Every call of the fused wrappers and of the plain featurization,
    with what it was given."""
    calls = {"stft": [], "istft": [], "plain": 0}
    real_stft, real_istft = fused_stft.fused_stft, fused_stft.fused_istft
    real_plain = diffusion_mod.compressed_stft

    def stft(x, n_fft=400, hop=100, comp_type="pow"):
        calls["stft"].append((x.dtype, x.ndim, x.is_contiguous(), n_fft, hop, comp_type))
        return real_stft(x, n_fft, hop, comp_type)

    def istft(spec, n_fft=400, hop=100, comp_type="pow", length=None):
        calls["istft"].append((spec.dtype, spec.ndim, spec.is_contiguous(), n_fft, hop,
                               comp_type))
        return real_istft(spec, n_fft, hop, comp_type, length)

    def plain(*a, **k):
        calls["plain"] += 1
        return real_plain(*a, **k)

    monkeypatch.setattr(fused_stft, "fused_stft", stft)
    monkeypatch.setattr(fused_stft, "fused_istft", istft)
    monkeypatch.setattr(diffusion_mod, "compressed_stft", plain)
    return calls


@pytest.fixture(scope="module")
def learner_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("k4_route")
    model = DiffuSE(residual_channels=8, residual_layers=2, use_groupnorm=False, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    torch.save({"model": model.state_dict()}, root / "variables.pt")
    return str(root)


def test_cdiffuse_conditioner_takes_k4_by_default(recorded, learner_dir):
    noisy = (0.3 * np.random.default_rng(0).standard_normal(6037)).astype(np.float32)
    for fast in (True, False):
        recorded["stft"].clear()
        out = cdiffuse_inference.predict(noisy, learner_dir, fast=fast, device="cpu")
        assert recorded["stft"] == [(torch.float32, 2, True, 400, 100, "none")]
        assert recorded["plain"] == 0 and out.shape == (6000,) and np.isfinite(out).all()
    cdiffuse_inference._model_cache.clear()


def test_cdiffuse_conditioner_plain_takes_ops_stft(recorded, learner_dir):
    noisy = (0.3 * np.random.default_rng(1).standard_normal(4000)).astype(np.float32)
    cdiffuse_inference.predict(noisy, learner_dir, fast=True, plain=True, device="cpu")
    assert recorded["stft"] == [] and recorded["plain"] == 1
    cdiffuse_inference._model_cache.clear()


def test_tsc_sampler_takes_k4_and_k5(recorded):
    config = load_config()
    model = DiffusionTSCNet(8, 201, 50, device="cpu", generator=torch.Generator().manual_seed(4))
    args = argparse.Namespace(arch="tsc-diffuse", sampler_batch=8, comp_type="pow")
    schedule = inference_schedule(linear_noise_schedule(50),
                                  [0.0001, 0.001, 0.01, 0.05, 0.2, 0.35], fast=True)
    rng = np.random.default_rng(2)
    signals = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (7000, 8000)]
    outs = inference_diffuse.predict_batch(model, args, config, signals, schedule, 5,
                                           device="cpu")
    steps = len(schedule.alpha)
    assert recorded["stft"] == [(torch.float32, 2, True, 400, 100, "pow")] * (1 + steps)
    assert recorded["istft"] == [(torch.complex64, 3, True, 400, 100, "pow")] * steps
    assert recorded["plain"] == 0
    assert [len(o) for o in outs] == [7000, 8000] and all(np.isfinite(o).all() for o in outs)
