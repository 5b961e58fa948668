"""The plain version of the K1 kernel (shaw_attention_reference) against the
JAX fused Shaw attention (Pallas, interpret mode on the CPU).

fp32: both compute fp32 logits and softmax from the same operands and
differ in summation order only: rtol 1e-4, atol 1e-5, the bound
tests/test_pallas_attention.py holds the Pallas kernel to.

bf16: both round the operands, the Shaw table and P to bf16 and the output
to bf16; a last-bit difference in an fp32 logit can flip a rounding of P
or of the output, each one bf16 step (2^-8 relative) of values of order 1,
so the bound is atol 2e-2 + rtol 2e-2 (about two output steps plus P).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops.pallas_attention import fused_shaw_attention as jax_fused
from speech_enhancement_tpu_torch.ops import fused_attention as fa

CASES = [  # (n, heads, d, max_pos_emb): n=33 with P=8 clips cheaply
    (7, 2, 8, 512),
    (101, 4, 16, 512),
    (33, 2, 8, 8),
]
TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}


def _operands(seed, b, n, h, d, max_pos_emb):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
    table = rng.standard_normal((2 * max_pos_emb + 1, d)).astype(np.float32)
    return q, k, v, table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,d,max_pos_emb", CASES)
def test_reference_matches_jax_fused(dtype, n, h, d, max_pos_emb):
    q, k, v, table = _operands(n, 3, n, h, d, max_pos_emb)
    scale = d ** -0.5
    jd = getattr(jnp, dtype)
    want = jax_fused(*(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(table),
                     max_pos_emb, scale)
    want = np.asarray(want.astype(jnp.float32))
    td = getattr(torch, dtype)
    got = fa.shaw_attention_reference(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                      torch.from_numpy(table), max_pos_emb, scale)
    assert got.dtype == td and got.shape == (3, n, h, d)
    rtol, atol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_takes_plain_version_on_cpu(dtype):
    q, k, v, table = (torch.from_numpy(a) for a in _operands(0, 2, 33, 2, 8, 8))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    launches = fa.launches
    got = fa.fused_shaw_attention(q, k, v, table, 8)
    assert torch.equal(got, fa.shaw_attention_reference(q, k, v, table, 8, 8 ** -0.5))
    assert fa.launches == launches  # the counter counts kernel launches only


def test_reference_reads_strided_kv_views():
    """k and v as the two halves of one to_kv projection (the layout the
    time conformer passes) give the same result as contiguous copies."""
    q, k, v, table = (torch.from_numpy(a) for a in _operands(1, 2, 21, 4, 4, 512))
    kv = torch.cat([k.flatten(2), v.flatten(2)], dim=-1)
    kh, vh = (t.view(2, 21, 4, 4) for t in kv.chunk(2, dim=-1))
    assert not kh.is_contiguous()
    torch.testing.assert_close(fa.shaw_attention_reference(q, kh, vh, table),
                               fa.shaw_attention_reference(q, k, v, table))


def _bad(kind):
    q = torch.zeros(2, 5, 4, 16)
    k = v = q
    table = torch.zeros(1025, 16)
    if kind == "head_dim":
        q = k = v = torch.zeros(2, 5, 4, 12)
        table = torch.zeros(1025, 12)
    elif kind == "dtype":
        q = k = v = q.half()
    elif kind == "table":
        table = torch.zeros(17, 16)
    elif kind == "head_stride":
        q = k = v = torch.zeros(2, 5, 16, 4).transpose(2, 3)
    elif kind == "shape":
        k = torch.zeros(2, 6, 4, 16)
    return q, k, v, table


@pytest.mark.parametrize("kind", ["head_dim", "dtype", "table", "head_stride", "shape"])
def test_kernel_input_checks(kind):
    """What the CUDA kernel cannot take is refused before any launch."""
    with pytest.raises((TypeError, ValueError)):
        fa._check(*_bad(kind), 512)
