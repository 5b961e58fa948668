"""The port's composite metrics (speech_enhancement_tpu_torch/metrics/
composite.py) against the JAX package's on the same pairs, on the CPU:
``compute_metrics`` and each part (wss, llr, snr/ssnr, stoi) to 1e-9,
from numpy or from wav paths, with equal and unequal lengths."""

import numpy as np
import pytest

from speech_enhancement_tpu.metrics import composite as jax_composite
from speech_enhancement_tpu_torch.data import save_wav
from speech_enhancement_tpu_torch.metrics import composite

SR = 16000


def _pair(seed, length=2 * SR, noise=0.05):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / SR
    envelope = 0.55 + 0.45 * np.sin(2 * np.pi * 3.1 * t)
    clean = 0.3 * np.sin(2 * np.pi * (150 + 20 * seed) * t) * envelope
    enhanced = clean + noise * rng.standard_normal(length)
    return clean.astype(np.float32), enhanced.astype(np.float32)


PAIRS = [(0, 2 * SR, 0.05), (1, 24037, 0.2), (2, SR, 0.01)]


@pytest.mark.parametrize("seed, length, noise", PAIRS)
@pytest.mark.parametrize("part", ["wss", "llr", "stoi"])
def test_parts_equal_jax(seed, length, noise, part):
    clean, enhanced = (a.astype(np.float64) for a in _pair(seed, length, noise))
    got = getattr(composite, part)(clean, enhanced, SR)
    want = getattr(jax_composite, part)(clean, enhanced, SR)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed, length, noise", PAIRS)
def test_snr_equals_jax(seed, length, noise):
    clean, enhanced = (a.astype(np.float64) for a in _pair(seed, length, noise))
    (overall, seg), (w_overall, w_seg) = (m.snr(clean, enhanced, SR)
                                          for m in (composite, jax_composite))
    np.testing.assert_allclose(overall, w_overall, rtol=0, atol=1e-9)
    np.testing.assert_allclose(seg, w_seg, rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed, length, noise", PAIRS)
def test_compute_metrics_equals_jax(seed, length, noise):
    clean, enhanced = _pair(seed, length, noise)
    enhanced = enhanced[:-37]  # unequal lengths: both cut to the shorter
    got = composite.compute_metrics(clean, enhanced, SR)
    want = jax_composite.compute_metrics(clean, enhanced, SR)
    assert len(got) == 6 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_compute_metrics_from_paths_equals_jax(tmp_path):
    clean, enhanced = _pair(3)
    save_wav(tmp_path / "c.wav", clean)
    save_wav(tmp_path / "e.wav", enhanced)
    args = (str(tmp_path / "c.wav"), str(tmp_path / "e.wav"), SR, 1)
    np.testing.assert_allclose(composite.compute_metrics(*args),
                               jax_composite.compute_metrics(*args), rtol=0, atol=1e-9)
