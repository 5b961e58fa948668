"""The port's own PESQ engine (speech_enhancement_tpu_torch/metrics/pesq.py
over csrc/pesq.cc) against the JAX package's (metrics/pesq.py over
native/pesq/pesq.cc).

Both libraries are built from the same C++ source with the same compiler
flags, so their scores agree to far below 1e-6 MOS; a larger difference
means that the two copies of the engine have diverged.
"""

import numpy as np
import pytest

from speech_enhancement_tpu.metrics import pesq as jax_pesq
from speech_enhancement_tpu_torch.metrics import pesq as port_pesq

SR = 16000


def _pair(seed, batch=3, length=SR):
    """Tone-plus-noise clean and noisy batches (voiced energy for PESQ)."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / SR
    tone = 0.3 * np.sin(2 * np.pi * 170.0 * t) * (0.55 + 0.45 * np.sin(2 * np.pi * 3.1 * t))
    clean = np.stack([tone * (1.0 + 0.05 * j) for j in range(batch)])
    noisy = clean + 0.05 * (1 + np.arange(batch))[:, None] * rng.standard_normal(clean.shape)
    return clean.astype(np.float32), noisy.astype(np.float32)


def test_batch_pesq_raw_matches_jax_package():
    clean, noisy = _pair(0)
    noisy[2] = 0.0  # a silent row fails in both engines: -1
    got = port_pesq.batch_pesq_raw(clean, noisy)
    want = jax_pesq.batch_pesq_raw(clean, noisy)
    assert got.shape == (3,) and got[2] == want[2] == -1.0
    assert np.all((got[:2] > 1.0) & (got[:2] < 4.7))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_single_scores_and_labels_match_jax_package():
    clean, noisy = _pair(1, batch=2)
    for c, n in zip(clean, noisy):
        assert abs(port_pesq.pesq(SR, c, n) - jax_pesq.pesq(SR, c, n)) <= 1e-6
    assert port_pesq.pesq_loss(clean[0], np.zeros_like(clean[0])) == -1.0
    with pytest.raises(RuntimeError):
        port_pesq.pesq(SR, clean[0], np.zeros_like(clean[0]))
    np.testing.assert_allclose(port_pesq.batch_pesq(list(clean), list(noisy)),
                               jax_pesq.batch_pesq(list(clean), list(noisy)), rtol=0, atol=1e-6)


def test_label_bias_knob_matches_jax_package(monkeypatch):
    """The bias arm of the label study shifts every score that is not a
    failure, clipped to the MOS scale, in both packages alike."""
    clean, noisy = _pair(2)
    noisy[0] = 0.0
    monkeypatch.setenv("SE_TPU_PESQ_LABEL_BIAS", "0.3")
    got = port_pesq.batch_pesq_raw(clean, noisy, exclude_noise=True)
    np.testing.assert_allclose(got, jax_pesq.batch_pesq_raw(clean, noisy, exclude_noise=True),
                               rtol=0, atol=1e-6)
    monkeypatch.delenv("SE_TPU_PESQ_LABEL_BIAS")
    plain = port_pesq.batch_pesq_raw(clean, noisy)
    assert got[0] == plain[0] == -1.0
    np.testing.assert_allclose(got[1:], np.clip(plain[1:] + 0.3, 1.0, 5.0), rtol=0, atol=1e-12)
