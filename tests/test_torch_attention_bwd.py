"""The plain version of the K2 kernel (shaw_attention_bwd_reference) against
the JAX fused Shaw-attention backward (Pallas, interpret mode on the CPU),
and the autograd route of the port's fused attention against flax's.

fp32: rtol 1e-4, atol 1e-5, the bounds tests/test_pallas_attention.py holds
the Pallas backward to: both sides compute the same fp32 products in
another summation order.

bf16: both sides round the operands, P and dS*scale to bf16; a last-bit
difference in an fp32 logit can flip one of those roundings, so the bound
is relative RMS < 1e-2 for each gradient (measured about 3e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.models.conformer import ShawAttention as FlaxShawAttention
from speech_enhancement_tpu.ops import pallas_attention as pa
from speech_enhancement_tpu_torch.models import ShawAttention
from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.ops import fused_attention as fa

# one intra-op thread: the pytest-xdist workers share the cores, and with
# torch's default of a thread per core in each, these tests took 3.5x as long
torch.set_num_threads(1)

NAMES = ("dq", "dk", "dv", "dtable")


def _operands(seed, b, n, h, d, max_pos_emb):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(4))
    table = rng.standard_normal((2 * max_pos_emb + 1, d)).astype(np.float32)
    return q, k, v, table, g


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def _port(q, k, v, table, g, max_pos_emb, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, table, g)]
    return fa.shaw_attention_bwd_reference(*t[:4], t[4], max_pos_emb, q.shape[-1] ** -0.5)


def _jax_grad(q, k, v, table, g, max_pos_emb):
    scale = q.shape[-1] ** -0.5

    def loss(q_, k_, v_, t_):
        return jnp.sum(pa._xla_attention(q_, k_, v_, t_, max_pos_emb, scale) * g)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, table)))


CASES = [  # (b, n, h, d, max_pos_emb)
    (2, 17, 2, 8, 512),
    (3, 40, 2, 8, 8),  # n > 17 with max_pos_emb 8: clipped rows 0 and 16
]


@pytest.mark.parametrize("b,n,h,d,max_pos_emb", CASES)
def test_reference_matches_pallas_backward(b, n, h, d, max_pos_emb):
    q, k, v, table, g = _operands(n, b, n, h, d, max_pos_emb)
    got = _port(q, k, v, table, g, max_pos_emb)
    want = pa._bwd_kernel_call(*(jnp.asarray(a) for a in (q, k, v, table, g)),
                               max_pos_emb, d ** -0.5, None)
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    for name, a, w in zip(NAMES, got, _jax_grad(q, k, v, table, g, max_pos_emb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_reference_matches_pallas_k3_route(monkeypatch):
    """The JAX side forced onto its i-tiled backward with the separate drel
    pass (K3), as tests/test_pallas_attention.py does: 4 batch tiles x 3
    query tiles."""
    monkeypatch.setattr(pa, "_VMEM_FALLBACK_BYTES", 1)
    monkeypatch.setattr(pa, "_I_TILE", 64)
    b, n, h, d = 7, 150, 2, 8
    q, k, v, table, g = _operands(3, b, n, h, d, 512)
    want = pa._bwd_kernel_call(*(jnp.asarray(a) for a in (q, k, v, table, g)),
                               512, d ** -0.5, 2)
    for name, a, w in zip(NAMES, _port(q, k, v, table, g, 512), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("max_pos_emb", [512, 8])
def test_reference_bf16_matches_pallas_backward(max_pos_emb):
    b, n, h, d = 3, 33, 2, 8
    q, k, v, table, g = _operands(7, b, n, h, d, max_pos_emb)
    got = _port(q, k, v, table, g, max_pos_emb, torch.bfloat16)
    want = pa._bwd_kernel_call(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, table, g)),
                               max_pos_emb, d ** -0.5, None)
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == torch.bfloat16, name
        err = _rel_rms(a.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert err < 1e-2, (name, err)


@pytest.mark.parametrize("max_pos_emb", [512, 8])
def test_reference_equals_autograd_of_forward_reference(max_pos_emb):
    b, n, h, d = 2, 21, 2, 4
    q, k, v, table, g = (torch.from_numpy(a) for a in _operands(5, b, n, h, d, max_pos_emb))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, table)]
    out = fa.shaw_attention_reference(*leaves, max_pos_emb)
    want = torch.autograd.grad(out, leaves, g)
    got = fa.shaw_attention_bwd_reference(q, k, v, table, g, max_pos_emb)
    for name, a, w in zip(NAMES, got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6, msg=name)


def test_autograd_function_takes_plain_versions_on_cpu():
    q, k, v, table, g = (torch.from_numpy(a) for a in _operands(6, 2, 19, 2, 8, 8))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, table)]
    launches = dict(_native.launches)
    out = fa.fused_shaw_attention(*leaves, 8)
    got = torch.autograd.grad(out, leaves, g)
    assert _native.launches == launches  # kernels only count
    assert torch.equal(out, fa.shaw_attention_reference(q, k, v, table, 8))
    for name, a, w in zip(NAMES, got, fa.shaw_attention_bwd_reference(q, k, v, table, g, 8)):
        assert torch.equal(a, w), name


def test_shaw_attention_fused_gradients_match_flax():
    """Parameter and input gradients of ShawAttention(fused=True): the
    port's autograd route (plain versions on the CPU) against jax.grad of
    the flax module, whose backward is the Pallas kernel (interpret)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 33, 16)).astype(np.float32)
    gy = rng.standard_normal((3, 33, 16)).astype(np.float32)
    flax_attn = FlaxShawAttention(dim=16, heads=2, dim_head=8, fused=True)
    params = flax_attn.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]

    def loss(p, x_):
        return jnp.sum(flax_attn.apply({"params": p}, x_, deterministic=True) * gy)

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    attn = ShawAttention(16, heads=2, dim_head=8, fused=True)
    norm = torch.nn.LayerNorm(16, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(torch.tensor(np.asarray(params["LayerNorm_0"]["scale"])))
        norm.bias.copy_(torch.tensor(np.asarray(params["LayerNorm_0"]["bias"])))
        for name in ("to_q", "to_kv", "to_out"):
            lin = getattr(attn, name)
            lin.weight.copy_(torch.tensor(np.asarray(params[name]["kernel"]).T))
            if lin.bias is not None:
                lin.bias.copy_(torch.tensor(np.asarray(params[name]["bias"])))
        attn.rel_pos_emb.weight.copy_(torch.tensor(np.asarray(params["rel_pos_emb"])))
    xt = torch.from_numpy(x).requires_grad_()
    out = attn(norm(xt))
    out.backward(torch.from_numpy(gy))
    assert _rel_rms(xt.grad, want_x) < 1e-4
    pairs = [(attn.to_q.weight.grad.T, want_p["to_q"]["kernel"]),
             (attn.to_kv.weight.grad.T, want_p["to_kv"]["kernel"]),
             (attn.to_out.weight.grad.T, want_p["to_out"]["kernel"]),
             (attn.to_out.bias.grad, want_p["to_out"]["bias"]),
             (attn.rel_pos_emb.weight.grad, want_p["rel_pos_emb"]),
             (norm.weight.grad, want_p["LayerNorm_0"]["scale"])]
    for got, want in pairs:
        assert _rel_rms(got, want) < 1e-4
