"""The arithmetic of K1's fp32 tensor-core instance
(csrc/shaw_attention_tf32.cu), as far as the CPU can hold it: a PyTorch copy
of its 3xTF32 products against the plain version (shaw_attention_reference)
and the JAX fused Shaw attention (Pallas, interpret mode), the forward
dispatch per (dtype, head dim, direction), and the fp32 alignment checks
that refuse what the kernel cannot take before any launch.  The kernel
itself runs only on the card, where chip_smoke.py holds it against
shaw_attention_reference.

The copy: every operand split into hi = tf32(x) and lo = tf32(x - hi)
(round to nearest, ties away, as csrc/mma.cuh's to_tf32 and
cvt.rna.tf32.f32 round; the same integer operations on the fp32 bits), every product taken as
lo*hi + hi*lo + hi*hi in fp32; the Shaw bias by the kernel's skew
(shaw_bias_skewed: R' = E_band q^T read at 63 * 20 + i * 21 - j * 20) over
the split table and queries; the softmax in log2 units as the kernel takes
it (p = exp2(x * scale * log2 e - m)); P in fp32, split like any operand,
for P V; lse = (m + log2 l) ln 2.

Bound: rtol 1e-4, atol 1e-5 on the output and atol 1e-4 on lse, the bounds
chip_smoke.py and tests/test_pallas_attention.py hold fp32 K1 to.  One TF32
product (a 10-bit mantissa) errs by several times that bound, which
test_single_tf32_product_breaks_the_bound shows: the split is needed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops.pallas_attention import fused_shaw_attention as jax_fused
from test_torch_stft_tf32 import tf32  # the kernels' rounding, tested there
from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.ops import fused_attention as fa

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

RTOL, ATOL, LSE_ATOL = 1e-4, 1e-5, 1e-4
LOG2E = 1.4426950408889634


def split_products(f, a, b, products=3):
    """``f(a, b)`` for a bilinear ``f`` as the kernel takes it: lo*hi +
    hi*lo + hi*hi of the TF32 splits (or hi*hi alone)."""
    a_hi, b_hi = tf32(a), tf32(b)
    out = f(a_hi, b_hi)
    if products == 3:
        out = f(tf32(a - a_hi), b_hi) + f(a_hi, tf32(b - b_hi)) + out
    return out


def k1_tf32_copy(q, k, v, table, max_pos_emb, scale=None, products=3):
    """What shaw_attention_tf32_kernel computes: ``(out, lse)`` in fp32."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    dots = split_products(lambda a, b: torch.einsum("bihd,bjhd->bhij", a, b), q, k, products)
    bias = split_products(lambda a, e: fa.shaw_bias_skewed(a, e, max_pos_emb), q, table,
                          products)
    x = (dots + bias) * (scale * LOG2E)  # log2 units
    m = x.amax(dim=-1, keepdim=True)
    p = torch.exp2(x - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = split_products(lambda a, b: torch.einsum("bhij,bjhd->bihd", a, b), p, v, products)
    out = pv / l.permute(0, 2, 1, 3)
    lse = (m + torch.log2(l))[..., 0] * np.log(2.0)
    return out, lse


def _operands(seed, b, n, h, d, max_pos_emb):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    table = rng.standard_normal((2 * max_pos_emb + 1, d)).astype(np.float32)
    return q, k, v, table


def _reference_lse(q, k, table, max_pos_emb, scale):
    rel = table[fa.relative_index(q.shape[1], max_pos_emb)]
    logits = (torch.einsum("bihd,bjhd->bhij", q, k)
              + torch.einsum("bihd,ijd->bhij", q, rel)) * scale
    return torch.logsumexp(logits, dim=-1)


def _excess(got, want):
    """max |got - want| / (atol + rtol |want|): < 1 inside the bound."""
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


@pytest.mark.parametrize("max_pos_emb", [8, 512])
@pytest.mark.parametrize("n", [7, 64, 161, 321])
def test_tf32_copy_matches_reference_and_jax(n, max_pos_emb):
    """n = 64 fills its tiles; 7, 161 and 321 leave ragged last query and
    key tiles; max_pos_emb 8 clips inside a tile."""
    b, h, d = (1, 2, 16) if n == 321 else (2, 2, 16)
    q, k, v, table = _operands(n + max_pos_emb, b, n, h, d, max_pos_emb)
    tq, tk, tv, tt = (torch.from_numpy(a) for a in (q, k, v, table))
    scale = d ** -0.5
    got, lse = k1_tf32_copy(tq, tk, tv, tt, max_pos_emb)
    want = fa.shaw_attention_reference(tq, tk, tv, tt, max_pos_emb, scale)
    want_jax = torch.from_numpy(np.array(jax_fused(
        *(jnp.asarray(a) for a in (q, k, v, table)), max_pos_emb, scale)))
    assert got.shape == want.shape == want_jax.shape == (b, n, h, d)
    assert _excess(got, want) < 1.0
    assert _excess(got, want_jax) < 1.0
    assert float((lse - _reference_lse(tq, tk, tt, max_pos_emb, scale)).abs().max()) < LSE_ATOL


def test_tf32_copy_at_head_dim_32():
    q, k, v, table = (torch.from_numpy(a) for a in _operands(32, 2, 100, 1, 32, 8))
    got, lse = k1_tf32_copy(q, k, v, table, 8)
    assert _excess(got, fa.shaw_attention_reference(q, k, v, table, 8)) < 1.0
    assert float((lse - _reference_lse(q, k, table, 8, 32 ** -0.5)).abs().max()) < LSE_ATOL


def test_single_tf32_product_breaks_the_bound():
    """One TF32 product (hi * hi) misses rtol 1e-4 / atol 1e-5 by more than
    twice the bound somewhere; three hold it."""
    q, k, v, table = (torch.from_numpy(a) for a in _operands(5, 2, 161, 2, 16, 512))
    want = fa.shaw_attention_reference(q, k, v, table, 512)
    assert _excess(k1_tf32_copy(q, k, v, table, 512, products=1)[0], want) > 2.0
    assert _excess(k1_tf32_copy(q, k, v, table, 512)[0], want) < 1.0


@pytest.mark.parametrize("dtype,d,direction,want", [
    (torch.float32, 16, "forward", "tensor_core_tf32"),
    (torch.float32, 32, "forward", "tensor_core_tf32"),
    (torch.float32, 16, "backward", "tensor_core_tf32"),
    (torch.float32, 32, "backward", "tensor_core_tf32"),
    (torch.bfloat16, 16, "forward", "tensor_core"),
    (torch.bfloat16, 32, "backward", "tensor_core"),
    (torch.float32, 8, "forward", "cuda_core"),
    (torch.bfloat16, 4, "backward", "cuda_core"),
])
def test_forward_and_backward_dispatch(dtype, d, direction, want):
    """Each (dtype, head dim, direction) has one kernel: fp32 at d 16 and
    32 runs in 3xTF32 in both directions (csrc/shaw_attention_tf32.cu and
    shaw_attention_bwd_tf32.cu), d 4 and 8 on CUDA cores."""
    assert fa.kernel_instance(dtype, d, direction) == want


def test_dispatch_refuses_an_unknown_direction():
    with pytest.raises(ValueError):
        fa.kernel_instance(torch.float32, 16, "sideways")


def test_fp32_wrapper_takes_the_plain_version_on_cpu():
    """CPU tensors never launch: no count moves."""
    q, k, v, table = (torch.from_numpy(a) for a in _operands(6, 2, 33, 2, 16, 8))
    before = dict(_native.launches)
    got, lse = fa.fused_shaw_attention_fwd(q, k, v, table, 8, 0.25, with_lse=True)
    assert _native.launches == before
    assert lse is None
    assert torch.equal(got, fa.shaw_attention_reference(q, k, v, table, 8, 0.25))


def _fp32_operands(kv_row=128, q_offset=0, table_offset=0, v_offset=64):
    """fp32 q, and k, v as views of one [2, 9, kv_row] projection."""
    q = torch.zeros(2 * 9 * 64 + q_offset)[q_offset:].view(2, 9, 4, 16)
    kv = torch.zeros(2, 9, kv_row)
    k = kv[..., :64].view(2, 9, 4, 16)
    v = kv[..., v_offset:v_offset + 64].view(2, 9, 4, 16)
    table = torch.zeros(1025 * 16 + table_offset)[table_offset:].view(1025, 16)
    return q, k, v, table


@pytest.mark.parametrize("kv_row", [128, 132])
def test_fp32_alignment_check_passes_16_byte_layouts(kv_row):
    """Rows of 132 floats (528 bytes) are 16-byte multiples: fp32 takes
    them, where bf16 needs multiples of 8 elements."""
    q, k, v, table = _fp32_operands(kv_row)
    fa._check(q, k, v, table, 512)
    fa._check_alignment(q, k, v, table)


@pytest.mark.parametrize("kind", ["q_pointer", "table_pointer", "kv_row_stride", "v_pointer"])
def test_fp32_alignment_check_raises_before_launch(kind):
    q, k, v, table = _fp32_operands(
        kv_row=130 if kind == "kv_row_stride" else 136,
        q_offset=1 if kind == "q_pointer" else 0,
        table_offset=2 if kind == "table_pointer" else 0,
        v_offset=66 if kind == "v_pointer" else 64)
    fa._check(q, k, v, table, 512)  # the shape checks pass: only alignment is wrong
    with pytest.raises(ValueError):
        fa._check_alignment(q, k, v, table)
