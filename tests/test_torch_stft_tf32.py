"""The arithmetic of K4's tensor-core kernel (csrc/stft.cu, stft_kernel), as
far as the CPU can hold it: a PyTorch copy of what the kernel computes, in
float32, against the plain version (stft_reference) and the JAX Pallas STFT
(interpret mode, as tests/test_pallas_stft.py runs it).

The copy: frames read from the reflect-padded signal at stride hop (the
kernel's staged segment, read as seg[row * hop + k]), folded into their
even and odd parts a[k] = x[k] + x[N - k], b[k] = x[k] - x[N - k] for
k < k_pad (the partner of k = 0 is itself), the folded cos and sin bases
the wrapper builds (stft_basis), TF32 rounding emulated on the fp32 bits
(round to nearest, ties away from zero, to a 10-bit mantissa:
cvt.rna.tf32.f32), each operand split into hi = tf32(x) and
lo = tf32(x - hi), the three products lo*hi + hi*lo + hi*hi summed in
fp32 (re from a and cos, im from b and sin), and the compression gated at
|X|^2 > 1e-24.

Bound: rtol 1e-4, atol 2e-4, the bound chip_smoke.py and
tests/test_pallas_stft.py hold K4 to (fp32 sums in another order;
compression amplifies the absolute error of near-empty bins).  3xTF32
keeps about 21 bits of each product and holds it; a single TF32 product
(11 bits) errs by about 5e-4 of a bin's scale and does not, which
test_single_tf32_product_breaks_the_bound shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_enhancement_tpu.ops.pallas_stft import pallas_stft
from speech_enhancement_tpu_torch.ops import fused_stft as fs

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 2e-4
GEOMETRIES = [(400, 100), (300, 75)]  # the main path; K padded 151 -> 152


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32: add half a step of the 13 dropped bits to the
    magnitude and clear them (the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def k4_copy(x: torch.Tensor, n_fft: int, hop: int, products: int = 3,
            compress: bool = True) -> torch.Tensor:
    """What stft_kernel computes for ``x`` ``[B, L]``, in float32."""
    basis = fs.stft_basis(n_fft)  # [2, k_pad, f_pad]
    k_pad = basis.shape[1]
    nfreq = n_fft // 2 + 1
    n_frames = 1 + x.shape[1] // hop
    xp = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop)[:, :n_frames]  # seg[row * hop + k]
    k = torch.arange(k_pad)
    partner = torch.where(k == 0, 0, n_fft - k)
    even = frames[..., k] + frames[..., partner]
    odd = frames[..., k] - frames[..., partner]

    def product(a, b):
        a_hi, b_hi = tf32(a), tf32(b)
        out = a_hi @ b_hi
        if products == 3:
            out = tf32(a - a_hi) @ b_hi + a_hi @ tf32(b - b_hi) + out
        return out[..., :nfreq]

    re, im = product(even, basis[0]), product(odd, basis[1])
    if compress:
        mag2 = re * re + im * im
        live = mag2 > 1e-24
        scale = torch.where(live, torch.where(live, mag2, 1.0) ** -0.35, 0.0)
        re, im = re * scale, im * scale
    return torch.complex(re, im)


def _signal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _within(got, want):
    got, want = torch.view_as_real(got), torch.view_as_real(torch.as_tensor(want))
    return bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())


def test_tf32_rounding():
    """Ties go away from zero; 1 + 2^-10 and its neighbours round as a
    10-bit mantissa does."""
    step = 2.0 ** -10
    x = torch.tensor([1 + step, 1 + step / 2, 1 + step / 2 - 2 ** -23,
                      -(1 + step / 2), 3.0, -0.0])
    want = torch.tensor([1 + step, 1 + step, 1.0, -(1 + step), 3.0, -0.0])
    assert torch.equal(tf32(x), want)


@pytest.mark.parametrize("n_fft", [400, 300])
def test_folded_basis_gives_the_window_dft(n_fft):
    """Unit impulses at k and N - k through the folded basis give the
    float64 real FFT of the windowed impulses; padding is zero."""
    basis = fs.stft_basis(n_fft).double()
    nfreq = n_fft // 2 + 1
    assert basis.shape[1] % 8 == 0 and nfreq <= basis.shape[1] < nfreq + 8
    assert basis.shape[2] % 104 == 0 and basis.shape[2] >= nfreq
    window = torch.hamming_window(n_fft, dtype=torch.float64)
    want = torch.fft.rfft(torch.diag(window), dim=1)  # row n: w[n] e^{-2 pi i n f / N}
    eye = torch.eye(n_fft, dtype=torch.float64)
    k = torch.arange(nfreq)
    partner = torch.where(k == 0, 0, n_fft - k)
    even, odd = eye[:, k] + eye[:, partner], eye[:, k] - eye[:, partner]  # [n, k]
    got_re = even @ basis[0, :nfreq, :nfreq]
    got_im = odd @ basis[1, :nfreq, :nfreq]
    torch.testing.assert_close(got_re, want.real, rtol=0, atol=1e-7)
    torch.testing.assert_close(got_im, want.imag, rtol=0, atol=1e-7)
    assert not basis[:, nfreq:].any() and not basis[:, :, nfreq:].any()


@pytest.mark.parametrize("n_fft", [400, 300])
def test_fragment_order_is_a_relayout(n_fft):
    """[tile, s, part, c, t, e] holds row 8 s + 4 e + t of bin 104 tile + c."""
    basis = fs.stft_basis(n_fft)
    frag = fs.basis_fragment_order(basis)
    tiles, steps = basis.shape[2] // 104, basis.shape[1] // 8
    assert frag.shape == (tiles, steps, 2, 104, 4, 2) and frag.is_contiguous()
    tile, s, part, c, t, e = torch.meshgrid(*(torch.arange(m) for m in frag.shape),
                                            indexing="ij")
    assert torch.equal(frag, basis[part, 8 * s + 4 * e + t, 104 * tile + c])


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
@pytest.mark.parametrize("length", [8000, 6437])
def test_3xtf32_copy_matches_reference_and_pallas(n_fft, hop, length):
    """6437 leaves a ragged last frame tile and a length that is no
    multiple of hop."""
    x = _signal(length + n_fft, (2, length))
    got = k4_copy(torch.from_numpy(x), n_fft, hop)
    want_ref = fs.stft_reference(torch.from_numpy(x), n_fft, hop)
    want_pallas = np.array(pallas_stft(jnp.asarray(x), n_fft, hop, comp_type="pow"))
    assert got.shape == want_ref.shape == want_pallas.shape == (2, 1 + length // hop,
                                                                 n_fft // 2 + 1)
    assert _within(got, want_ref)
    assert _within(got, want_pallas)


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
def test_3xtf32_copy_uncompressed(n_fft, hop):
    x = _signal(3, (2, 4000))
    got = k4_copy(torch.from_numpy(x), n_fft, hop, compress=False)
    assert _within(got, fs.stft_reference(torch.from_numpy(x), n_fft, hop, "none"))


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
def test_single_tf32_product_breaks_the_bound(n_fft, hop):
    """One TF32 product (hi * hi) misses rtol 1e-4 / atol 2e-4, by more
    than twice the bound somewhere: the split into three is needed."""
    x = torch.from_numpy(_signal(4, (2, 8000)))
    want = torch.view_as_real(fs.stft_reference(x, n_fft, hop))
    one = torch.view_as_real(k4_copy(x, n_fft, hop, products=1))
    excess = ((one - want).abs() / (ATOL + RTOL * want.abs())).max()
    assert excess > 2.0
    three = torch.view_as_real(k4_copy(x, n_fft, hop))
    assert ((three - want).abs() / (ATOL + RTOL * want.abs())).max() < 1.0


def test_silent_signal_gives_zero_spectrum():
    """The gate: an all-zero signal has |X|^2 = 0 <= 1e-24 everywhere."""
    assert torch.count_nonzero(k4_copy(torch.zeros(1, 4000), 400, 100)) == 0
