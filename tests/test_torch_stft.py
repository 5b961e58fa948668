"""Port featurization (speech_enhancement_tpu_torch.ops.stft and the plain
versions of the K4/K5 kernels) against the JAX package on the CPU.

Both sides take the DFT as fp32 matmuls on a float64-built basis and
differ only in summation order, so spectra and waveforms agree to about
1e-6 of their scale: the bounds below (rtol 1e-5 and an atol of 1e-5 on
values of order 1) leave a decade of room.  Compression turns an absolute
DFT error e at a bin of magnitude |X| into about e * |X|^-0.7, so a
compressed spectrum gets atol 5e-5 for its near-empty bins (the Pallas
kernel sums its four hop blocks in another order than one 400-term
matmul).  The Pallas kernels run in interpret mode, as
tests/test_pallas_stft.py runs them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu import ops as jops
from speech_enhancement_tpu.ops.pallas_stft import pallas_istft, pallas_stft
from speech_enhancement_tpu_torch import ops as tops
from speech_enhancement_tpu_torch.ops.fused_stft import (
    fused_istft,
    fused_stft,
    istft_reference,
    stft_reference,
)

RTOL, ATOL = 1e-5, 1e-5
COMP_ATOL = 5e-5  # compressed spectra, see the module docstring


def _signal(seed, shape):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("comp_type", ["pow", "log", "none"])
def test_compressed_stft_matches_jax(comp_type):
    x = _signal(0, (2, 8000))
    want = np.asarray(jops.compressed_stft(jnp.asarray(x), 400, 100, comp_type=comp_type))
    got = tops.compressed_stft(torch.from_numpy(x), 400, 100, comp_type=comp_type).numpy()
    assert got.shape == want.shape == (2, 81, 201)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=COMP_ATOL)


@pytest.mark.parametrize("comp_type", ["pow", "log", "none"])
def test_uncompressed_istft_matches_jax(comp_type):
    x = _signal(1, (2, 8000))
    spec = np.asarray(jops.compressed_stft(jnp.asarray(x), 400, 100, comp_type=comp_type))
    want = np.asarray(jops.uncompressed_istft(jnp.asarray(spec), 400, 100,
                                              comp_type=comp_type, length=7950))
    got = tops.uncompressed_istft(torch.tensor(spec), 400, 100,
                                  comp_type=comp_type, length=7950).numpy()
    assert got.shape == want.shape == (2, 7950)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_stft_istft_match_jax():
    x = _signal(2, (3, 4000))
    want = np.asarray(jops.stft(jnp.asarray(x), 400, 100))
    got = tops.stft(torch.from_numpy(x), 400, 100)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    back_j = np.asarray(jops.istft(jnp.asarray(want), 400, 100))
    back_t = tops.istft(got, 400, 100).numpy()
    np.testing.assert_allclose(back_t, back_j, rtol=RTOL, atol=ATOL)
    # and the round trip restores the signal (torch.istft semantics)
    np.testing.assert_allclose(back_t, x, rtol=1e-4, atol=ATOL)


def test_normalize_batch_matches_jax_with_silent_row():
    x = _signal(3, (3, 4000))
    x[1] = 0.0  # a digitally silent utterance gets gain c = 1, not inf
    jc, jn, jg = (np.asarray(a) for a in jops.normalize_batch(jnp.asarray(x), jnp.asarray(x)))
    tc, tn, tg = (a.numpy() for a in tops.normalize_batch(torch.from_numpy(x),
                                                          torch.from_numpy(x)))
    assert tg[1, 0] == 1.0 and np.all(np.isfinite(tn))
    for got, want in ((tc, jc), (tn, jn), (tg, jg)):
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("comp_type", ["pow", "none"])
@pytest.mark.parametrize("length", [8000, 6400])
def test_stft_reference_matches_pallas(comp_type, length):
    """81 and 65 frames: neither is a multiple of the Pallas 64-frame tile."""
    x = _signal(4, (2, length))
    want = np.asarray(pallas_stft(jnp.asarray(x), 400, 100, comp_type=comp_type))
    got = stft_reference(torch.from_numpy(x), 400, 100, comp_type).numpy()
    assert got.shape == want.shape == (2, length // 100 + 1, 201)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=COMP_ATOL)


@pytest.mark.parametrize("comp_type", ["pow", "none"])
@pytest.mark.parametrize("length", [8000, 6350])
def test_istft_reference_matches_pallas(comp_type, length):
    x = _signal(5, (2, 8000))
    spec = np.asarray(jops.compressed_stft(jnp.asarray(x), 400, 100, comp_type=comp_type))
    want = np.asarray(pallas_istft(jnp.asarray(spec), 400, 100, comp_type=comp_type,
                                   length=length))
    got = istft_reference(torch.tensor(spec), 400, 100, comp_type, length).numpy()
    assert got.shape == want.shape == (2, length)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_compress_gate_zeroes_empty_bins():
    """The kernels' plain versions gate on |X|^2 > 1e-24 (Pallas
    semantics): an all-zero signal gives an all-zero spectrum and back."""
    x = torch.zeros(1, 4000)
    spec = stft_reference(x)
    assert torch.count_nonzero(spec) == 0
    assert torch.count_nonzero(istft_reference(spec, length=4000)) == 0


def test_wrappers_take_plain_versions_on_cpu():
    x = torch.from_numpy(_signal(6, (2, 4000)))
    spec = fused_stft(x)
    assert torch.equal(spec, stft_reference(x))
    assert torch.equal(fused_istft(spec, length=3990), istft_reference(spec, length=3990))


@pytest.mark.parametrize("n_fft,hop,comp_type", [(400, 100, "log"), (401, 100, "pow"),
                                                 (400, 30, "pow"), (400, 40, "pow")])
def test_wrappers_reject_what_the_kernels_do_not_take(n_fft, hop, comp_type):
    with pytest.raises(ValueError):
        fused_stft(torch.zeros(1, 4000), n_fft, hop, comp_type)
