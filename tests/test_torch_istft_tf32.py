"""The arithmetic of K5's tensor-core kernel (csrc/stft.cu, istft_kernel), as
far as the CPU can hold it: a PyTorch copy of what the kernel computes, in
float32, against the plain version (istft_reference) and the JAX Pallas
iSTFT (interpret mode, as tests/test_torch_stft.py runs it).

The copy: the spectrum uncompressed with the gate |z|^2 > 1e-24 (as the
kernel stages it), zero-padded to k_pad bins; the folded inverse bases the
wrapper builds (istft_basis); TF32 rounding on the fp32 bits as
csrc/mma.cuh's to_tf32 takes it (round to nearest, ties away, as
cvt.rna.tf32.f32), each operand split into hi = tf32(x) and
lo = tf32(x - hi), the three products lo*hi + hi*lo + hi*hi summed in fp32;
C = R Bc and S = I Bs over n <= n_fft / 2, the frame C - S at n and C + S
at n_fft - n; then the overlap-add, the window-sum-square envelope (> 1e-11)
and the center trim.

Bound: rtol 1e-4, atol 1e-4, the bound chip_smoke.py holds K5 to (fp32 sums
of 201 products of order-1 values in another order).  3xTF32 keeps about
21 bits of each product and holds it; a single TF32 product (11 bits) does
not, which test_one_tf32_product_or_three shows: it decides that the kernel
takes three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops.pallas_stft import pallas_istft
from test_torch_stft_tf32 import tf32  # the kernels' rounding, tested there
from speech_enhancement_tpu_torch.ops import fused_stft as fs
from speech_enhancement_tpu_torch.ops.stft import hamming_window, overlap_add

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
GEOMETRIES = [(400, 100), (300, 75)]  # the main path; k_pad 151 -> 152


def k5_copy(spec: torch.Tensor, n_fft: int, hop: int, length: int | None = None,
            products: int = 3, compress: bool = True) -> torch.Tensor:
    """What istft_kernel computes for ``spec`` ``[B, T, F]``, in float32."""
    basis = fs.istft_basis(n_fft)  # [2, k_pad, n_pad]
    k_pad, half = basis.shape[1], n_fft // 2
    b, n_frames, nfreq = spec.shape
    re, im = spec.real.float(), spec.imag.float()
    if compress:
        mag2 = re * re + im * im
        live = mag2 > 1e-24
        scale = torch.where(live, torch.where(live, mag2, 1.0) ** ((1.0 / 0.3 - 1.0) / 2.0), 0.0)
        re, im = re * scale, im * scale
    staged = torch.zeros(2, b, n_frames, k_pad)
    staged[0, ..., :nfreq], staged[1, ..., :nfreq] = re, im

    def product(a, w):
        a_hi, w_hi = tf32(a), tf32(w)
        out = a_hi @ w_hi
        if products == 3:
            out = tf32(a - a_hi) @ w_hi + a_hi @ tf32(w - w_hi) + out
        return out[..., :half + 1]

    c, s = product(staged[0], basis[0]), product(staged[1], basis[1])
    frames = torch.cat([c - s, (c + s)[..., 1:half].flip(-1)], dim=-1)  # n, then n_fft - n
    window = hamming_window(n_fft)
    sig = overlap_add(frames, hop)
    env = overlap_add((window * window).expand(1, n_frames, n_fft), hop)
    sig = (sig / torch.where(env > 1e-11, env, 1.0))[:, half:sig.shape[1] - half]
    return sig if length is None else sig[:, :length]


def _spectrum(seed, b, length, n_fft, hop, comp_type="pow"):
    """The compressed spectrum of RMS-1 audio, as the serving path hands K5
    the model's output (numpy float32, and complex64)."""
    x = np.random.default_rng(seed).standard_normal((b, length)).astype(np.float32)
    return fs.stft_reference(torch.from_numpy(x), n_fft, hop, comp_type)


def _excess(got, want):
    """max |got - want| / (atol + rtol |want|): < 1 inside the bound."""
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


@pytest.mark.parametrize("n_fft", [400, 300])
def test_istft_basis_is_the_windowed_inverse_dft(n_fft):
    """Unit spectra through the folded basis, unfolded (C - S at n, C + S at
    N - n), give the float64 inverse real FFT of each bin times the window;
    padding is zero."""
    basis = fs.istft_basis(n_fft).double()
    nfreq, half = n_fft // 2 + 1, n_fft // 2
    assert basis.shape[1] % 8 == 0 and nfreq <= basis.shape[1] < nfreq + 8
    assert basis.shape[2] % 104 == 0 and basis.shape[2] >= nfreq
    window = torch.hamming_window(n_fft, dtype=torch.float64)
    eye = torch.eye(nfreq, dtype=torch.complex128)
    zero = torch.zeros(nfreq, nfreq, dtype=torch.float64)
    for part, spec in ((0, eye), (1, 1j * eye)):  # row f: bin f alone, real or imaginary
        want = torch.fft.irfft(spec, n=n_fft, dim=1) * window
        c = basis[0, :nfreq, :nfreq] if part == 0 else zero
        s = basis[1, :nfreq, :nfreq] if part == 1 else zero
        got = torch.cat([c - s, (c + s)[:, 1:half].flip(-1)], dim=1)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-7)
    assert not basis[:, nfreq:].any() and not basis[:, :, nfreq:].any()


@pytest.mark.parametrize("n_fft", [400, 300])
def test_istft_fragment_order_is_a_relayout(n_fft):
    """[chunk, s, part, c, t, e] holds row (bin) 8 s + 4 e + t of column
    (n) 104 chunk + c."""
    basis = fs.istft_basis(n_fft)
    frag = fs.basis_fragment_order(basis)
    chunks, steps = basis.shape[2] // 104, basis.shape[1] // 8
    assert frag.shape == (chunks, steps, 2, 104, 4, 2) and frag.is_contiguous()
    chunk, s, part, c, t, e = torch.meshgrid(*(torch.arange(m) for m in frag.shape),
                                             indexing="ij")
    assert torch.equal(frag, basis[part, 8 * s + 4 * e + t, 104 * chunk + c])


@pytest.mark.parametrize("comp_type", ["pow", "none"])
@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
@pytest.mark.parametrize("length", [8000, 6437])
def test_3xtf32_copy_matches_reference_and_pallas(n_fft, hop, comp_type, length):
    """6437 cuts the output inside a hop block."""
    spec = _spectrum(length + n_fft, 2, 8100, n_fft, hop, comp_type)
    got = k5_copy(spec, n_fft, hop, length, compress=comp_type == "pow")
    want_ref = fs.istft_reference(spec, n_fft, hop, comp_type, length)
    want_pallas = torch.from_numpy(np.array(pallas_istft(
        jnp.asarray(spec.numpy()), n_fft, hop, comp_type=comp_type, length=length)))
    assert got.shape == want_ref.shape == want_pallas.shape == (2, length)
    assert _excess(got, want_ref) < 1.0
    assert _excess(got, want_pallas) < 1.0


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
def test_one_tf32_product_or_three(n_fft, hop):
    """The test that decides K5's design: one TF32 product (hi * hi) misses
    rtol 1e-4 / atol 1e-4 against istft_reference, by more than twice the
    bound somewhere, so the kernel takes three, which hold it."""
    spec = _spectrum(4, 2, 8000, n_fft, hop)
    want = fs.istft_reference(spec, n_fft, hop)
    assert _excess(k5_copy(spec, n_fft, hop, products=1), want) > 2.0
    assert _excess(k5_copy(spec, n_fft, hop), want) < 1.0


def test_silent_spectrum_gives_zeros():
    """The gate: an all-zero spectrum uncompresses to zeros, and the
    envelope division leaves them zero."""
    spec = torch.zeros(1, 41, 201, dtype=torch.complex64)
    assert torch.count_nonzero(k5_copy(spec, 400, 100)) == 0
