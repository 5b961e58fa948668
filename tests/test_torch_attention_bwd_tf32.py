"""The arithmetic of K2's fp32 tensor-core instance
(csrc/shaw_attention_bwd_tf32.cu), as far as the CPU can hold it: a PyTorch
copy of its 3xTF32 products over the two skews of the bf16 instance
(inverse_skew and transposed_bias, tests/test_torch_attention_bwd_mma.py),
held against the plain version (shaw_attention_bwd_reference) and the JAX
backward (jax.grad through the XLA attention, and through the fused Pallas
attention in interpret mode); the backward dispatch and the fp32 alignment
checks that refuse what the kernel cannot take before any launch.  The
kernel itself runs only on the card, where chip_smoke.py holds it against
shaw_attention_bwd_reference.

The copy: P from the fp32 K1's row log-sum-exp and Delta from its output
(k1_tf32_copy, tests/test_torch_attention_tf32.py), p = exp2(x * scale *
log2 e - lse * log2 e); every product (S, the bias, dP in each pass; dq and
its bias term D' E_band; dE_band = D'^T Q; dv; dk) taken as lo*hi + hi*lo +
hi*hi of the TF32 splits (split_products, csrc/mma.cuh's rounding); dp in
fp32, not rounded; pass A's key tiles of 64, or 32 at head dim 32, as the
kernel takes them.

Bounds: rtol 1e-4 + atol 1e-5 on dq, dk, dv, relative RMS < 1e-5 on dtable
(a sum of up to n^2 / 2 products per clipped row), the bounds chip_smoke.py
holds the kernel to.  One TF32 product per fp32 product misses them
(test_single_tf32_product_breaks_the_bound): the split is needed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops import pallas_attention as pa
from test_torch_attention_bwd_mma import inverse_skew, transposed_bias
from test_torch_attention_tf32 import k1_tf32_copy, split_products
from speech_enhancement_tpu_torch.ops import fused_attention as fa

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

RTOL, ATOL, DTABLE_RMS = 1e-4, 1e-5, 1e-5
LOG2E = 1.4426950408889634
NAMES = ("dq", "dk", "dv", "dtable")


def _einsum(spec):
    return lambda a, b: torch.einsum(spec, a, b)


def bwd_tf32_copy(q, k, v, table, g, max_pos_emb, products=3):
    """What the fp32 tensor-core K2 computes: ``(dq, dk, dv, dtable)``, the
    forward's ``out`` and ``lse`` from the fp32 K1's copy (three products
    there always), ``products`` TF32 products per fp32 product here."""
    scale = q.shape[-1] ** -0.5
    out, lse = k1_tf32_copy(q, k, v, table, max_pos_emb)
    neg_lse = -lse * LOG2E  # [b, h, n], log2 units

    def mul(f, a, b):
        return split_products(f, a, b, products)

    def skewed_bias(a, e):
        return fa.shaw_bias_skewed(a, e, max_pos_emb)

    delta = (g * out).sum(-1).transpose(1, 2)  # rowsum(dO o O), [b, h, n]
    # pass A: queries as rows
    s = mul(_einsum("bihd,bjhd->bhij"), q, k) + mul(skewed_bias, q, table)
    p = torch.exp2(s * (scale * LOG2E) + neg_lse[..., None])
    dp = p * (mul(_einsum("bihd,bjhd->bhij"), g, v) - delta[..., None]) * scale
    tile = 32 if q.shape[-1] == 32 else 64  # pass A's key tile
    dq = (mul(_einsum("bhij,bjhd->bihd"), dp, k)
          + mul(lambda a, e: inverse_skew(q, a, e, max_pos_emb, tile)[0], dp, table))
    dtable = mul(lambda a, qq: inverse_skew(qq, a, table, max_pos_emb, tile)[1], dp, q)
    # pass B: keys as rows, the transposed bias through R'_blk
    s_t = (mul(_einsum("bjhd,bihd->bhji"), k, q)
           + mul(lambda a, e: transposed_bias(a, e, max_pos_emb), q, table))
    p_t = torch.exp2(s_t * (scale * LOG2E) + neg_lse[:, :, None, :])
    dv = mul(_einsum("bhji,bihd->bjhd"), p_t, g)
    dp_t = p_t * (mul(_einsum("bjhd,bihd->bhji"), v, g) - delta[:, :, None, :]) * scale
    dk = mul(_einsum("bhji,bihd->bjhd"), dp_t, q)
    return dq, dk, dv, dtable


def _operands(seed, b, n, h, d, max_pos_emb):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(4))
    table = rng.standard_normal((2 * max_pos_emb + 1, d)).astype(np.float32)
    return q, k, v, table, g


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def _excess(got, want):
    """max |got - want| / (atol + rtol |want|): < 1 inside the bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max())


def _hold(got, want):
    for name, a, w in zip(NAMES, got, want):
        a, w = np.asarray(a), np.asarray(w)
        assert a.shape == w.shape, name
        if name == "dtable":
            assert _rel_rms(a, w) < DTABLE_RMS, name
        else:
            assert _excess(a, w) < 1.0, name


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("n,max_pos_emb", [(7, 512), (100, 8), (161, 512)])
def test_copy_matches_reference(n, max_pos_emb, d):
    """n = 7 and 100 leave ragged query and key tiles, 161 three key tiles
    (the training shape's n); max_pos_emb 8 clips inside a tile."""
    q, k, v, table, g = (torch.from_numpy(a) for a in _operands(n + d, 1, n, 2, d, max_pos_emb))
    got = bwd_tf32_copy(q, k, v, table, g, max_pos_emb)
    want = fa.shaw_attention_bwd_reference(q, k, v, table, g, max_pos_emb)
    _hold(got, want)


def _jax_xla_grad(q, k, v, table, g, max_pos_emb):
    scale = q.shape[-1] ** -0.5

    def loss(q_, k_, v_, t_):
        return jnp.sum(pa._xla_attention(q_, k_, v_, t_, max_pos_emb, scale) * g)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, table)))


def _jax_pallas_grad(q, k, v, table, g, max_pos_emb):
    """jax.grad of the fused Pallas attention, whose custom VJP is the Pallas
    backward kernel (interpret mode on the CPU)."""

    def loss(q_, k_, v_, t_):
        return jnp.sum(pa.fused_shaw_attention(q_, k_, v_, t_, max_pos_emb) * g)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, table)))


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("max_pos_emb", [512, 8])
def test_copy_matches_jax_backward(max_pos_emb, d, route):
    """fp32 operands from a seed through both packages; n = 70 leaves a
    ragged second tile."""
    q, k, v, table, g = _operands(3 * d + max_pos_emb, 2, 70, 2, d, max_pos_emb)
    got = bwd_tf32_copy(*(torch.from_numpy(a) for a in (q, k, v, table, g)), max_pos_emb)
    grad = _jax_xla_grad if route == "xla" else _jax_pallas_grad
    _hold(got, grad(q, k, v, table, g, max_pos_emb))


def test_single_tf32_product_breaks_the_bound():
    """One TF32 product (hi * hi) per fp32 product misses rtol 1e-4 / atol
    1e-5 by more than twice the bound somewhere; three hold it."""
    q, k, v, table, g = (torch.from_numpy(a) for a in _operands(5, 2, 161, 2, 16, 512))
    want = fa.shaw_attention_bwd_reference(q, k, v, table, g, 512)
    one = bwd_tf32_copy(q, k, v, table, g, 512, products=1)
    assert max(_excess(a, w) for a, w in zip(one[:3], want[:3])) > 2.0
    _hold(bwd_tf32_copy(q, k, v, table, g, 512), want)


def test_fp32_backward_takes_the_plain_version_on_cpu():
    """CPU tensors never launch: no backward counter moves."""
    q, k, v, table, g = (torch.from_numpy(a) for a in _operands(8, 2, 33, 2, 32, 8))
    before = (fa.bwd_launches, fa.bwd_mma_launches, fa.bwd_tf32_launches)
    got = fa.fused_shaw_attention_bwd(q, k, v, table, None, None, g, 8)
    assert (fa.bwd_launches, fa.bwd_mma_launches, fa.bwd_tf32_launches) == before
    for name, a, w in zip(NAMES, got, fa.shaw_attention_bwd_reference(q, k, v, table, g, 8)):
        assert torch.equal(a, w), name


def _fp32_operands(out_offset=0, g_offset=0, q_offset=0, kv_row=128):
    """fp32 q, k and v (views of one [2, 9, kv_row] projection), table, and
    the backward's contiguous out and g, each at the given element offset."""
    def at(offset, shape):
        numel = int(np.prod(shape))
        return torch.zeros(numel + offset)[offset:].view(shape)

    kv = torch.zeros(2, 9, kv_row)
    k, v = kv[..., :64].view(2, 9, 4, 16), kv[..., 64:128].view(2, 9, 4, 16)
    shape = (2, 9, 4, 16)
    return at(q_offset, shape), k, v, at(0, (1025, 16)), at(out_offset, shape), at(g_offset, shape)


def test_fp32_backward_alignment_check_passes_aligned_operands():
    q, k, v, table, out, g = _fp32_operands()
    fa._check(q, k, v, table, 512)
    fa._check_alignment(q, k, v, table, out, g)


@pytest.mark.parametrize("kind", ["out_pointer", "g_pointer", "q_pointer", "kv_row_stride"])
def test_fp32_backward_alignment_check_raises_before_launch(kind):
    """out and g 4 bytes off a 16-byte boundary, q likewise, or k and v
    rows of 130 floats (520 bytes, not a multiple of 16): refused."""
    q, k, v, table, out, g = _fp32_operands(out_offset=int(kind == "out_pointer"),
                                            g_offset=int(kind == "g_pointer"),
                                            q_offset=int(kind == "q_pointer"),
                                            kv_row=130 if kind == "kv_row_stride" else 128)
    fa._check(q, k, v, table, 512)  # the shape checks pass: only alignment is wrong
    with pytest.raises(ValueError):
        fa._check_alignment(q, k, v, table, out, g)
