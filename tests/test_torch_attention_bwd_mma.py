"""The arithmetic of K2's bf16 tensor-core instance
(csrc/shaw_attention_bwd_mma.cu), as far as the CPU can hold it: PyTorch
copies of its two skews, and of the whole backward built from them, against
the gather formulas of shaw_attention_bwd_reference and the JAX backward
(Pallas, interpret mode).  The kernel runs only on the card, where
chip_smoke.py holds it against shaw_attention_bwd_reference.

* Pass A, the inverse skew: for each warp of 16 queries and key tile of 64,
  dp is scattered into an offset band D'[i][r], r = 63 + i - j (80 wide),
  dq's bias term is D' E_band (E_band the 80 clipped table rows of offsets
  i_w - j_0 - 63 + r), and the table gradient is D'^T Q folded onto the
  clipped rows.
* Pass B, the transposed skew: for each block of 64 keys and query tile of
  64, R'_blk[r][i] = E_band[r] . q_i over the 128 band rows is written at
  row pitch 67 and bias^T[j][i] is read at (63 + i - j) * 67 + i.

Bounds: the transposed bias against the gather at rtol 1e-6 + atol 1e-5
(the same 16 products summed in another order, as
tests/test_torch_attention_mma.py); dq's bias term, a sum of n products of
order 1 with partial sums up to about 40 (fp32 step 3.8e-6), at rtol 1e-5
+ atol 1e-4; the table gradient, a sum of up to n^2 / 2 products per
clipped row, at relative RMS 1e-6 against the float64 reference sum.  The whole copy in
fp32 at rtol 1e-4 + atol 1e-5 (dtable relative RMS 1e-5), the bounds
tests/test_torch_attention_bwd.py and chip_smoke.py hold K2 to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops import pallas_attention as pa
from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.ops import fused_attention as fa

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)

ROWS, TILE, WARP_BAND, BLOCK_BAND, PITCH_B = 16, 64, 80, 128, 67
NAMES = ("dq", "dk", "dv", "dtable")


def _clipped(offsets, max_pos_emb):
    return offsets.clamp(-max_pos_emb, max_pos_emb) + max_pos_emb


def inverse_skew(q, dp, table, max_pos_emb, tile=TILE):
    """Pass A's bias terms: ``(dq_bias [b, n, h, d], dtable [2P+1, d])``
    from ``dp`` ``[b, h, n, n]`` through the offset band D' of each warp's
    16 queries and key tile of ``tile`` keys (16 + tile band rows)."""
    b, n, h, d = q.shape
    warp_band = ROWS + tile
    nw, nj = -(-n // ROWS), -(-n // tile)
    dpp = torch.zeros(b, h, nw * ROWS, nj * tile)
    dpp[..., :n, :n] = dp
    tiles = dpp.view(b, h, nw, ROWS, nj, tile).permute(0, 1, 2, 4, 3, 5)
    il, jl = torch.arange(ROWS)[:, None], torch.arange(tile)[None, :]
    cell = (il * warp_band + tile - 1 + il - jl).reshape(-1)  # D'[i][tile - 1 + i - j]
    band = torch.zeros(b, h, nw, nj, ROWS * warp_band)
    band[..., cell] = tiles.reshape(b, h, nw, nj, ROWS * tile)
    band = band.view(b, h, nw, nj, ROWS, warp_band)
    offsets = (ROWS * torch.arange(nw)[:, None, None] - tile * torch.arange(nj)[None, :, None]
               - (tile - 1) + torch.arange(warp_band))  # [nw, nj, warp_band]
    e_band = table[_clipped(offsets, max_pos_emb)]  # [nw, nj, 80, d]
    dq_bias = torch.einsum("bhwjir,wjrd->bwihd", band, e_band).reshape(b, nw * ROWS, h, d)
    qp = torch.zeros(b, nw * ROWS, h, d)
    qp[:, :n] = q
    de_band = torch.einsum("bhwjir,bwihd->wjrd", band, qp.view(b, nw, ROWS, h, d))
    dtable = torch.zeros(table.shape, dtype=torch.float64)
    dtable.index_add_(0, _clipped(offsets, max_pos_emb).reshape(-1),
                      de_band.reshape(-1, d).double())
    return dq_bias[:, :n], dtable


def transposed_bias(q, table, max_pos_emb):
    """Pass B's bias ``[b, h, n (keys), n (queries)]`` through R'_blk."""
    b, n, h, d = q.shape
    nt = -(-n // TILE)
    qp = torch.zeros(b, nt * TILE, h, d)
    qp[:, :n] = q
    offsets = (TILE * torch.arange(nt)[None, :, None] - TILE * torch.arange(nt)[:, None, None]
               - (TILE - 1) + torch.arange(BLOCK_BAND))  # [key block, query tile, 128]
    e_band = table[_clipped(offsets, max_pos_emb)]
    r_blk = torch.einsum("kird,bilhd->bhkirl", e_band, qp.view(b, nt, TILE, h, d))
    flat = torch.zeros(b, h, nt, nt, BLOCK_BAND, PITCH_B)
    flat[..., :TILE] = r_blk  # R'_blk[r][i] at r * 67 + i
    il, jl = torch.arange(TILE)[None, :], torch.arange(TILE)[:, None]
    address = (TILE - 1 + il - jl) * PITCH_B + il  # [j, i]
    tiles = flat.view(b, h, nt, nt, BLOCK_BAND * PITCH_B)[..., address]
    bias_t = tiles.permute(0, 1, 2, 4, 3, 5).reshape(b, h, nt * TILE, nt * TILE)
    return bias_t[..., :n, :n]


def bwd_copy(q, k, v, table, g, max_pos_emb):
    """The tensor-core K2 in fp32: pass A (P from the row log-sum-exp, Delta
    = rowsum(dO o O), dq with the inverse skew, dtable) and pass B (the
    transposed tile with its skewed bias, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    s = (torch.einsum("bihd,bjhd->bhij", q, k) + fa.shaw_bias_skewed(q, table, max_pos_emb))
    lse = torch.logsumexp(s * scale, dim=-1)  # what K1 writes
    p = torch.exp(s * scale - lse[..., None])
    delta = (g * torch.einsum("bhij,bjhd->bihd", p, v)).sum(-1).transpose(1, 2)  # [b, h, n]
    dp = p * (torch.einsum("bihd,bjhd->bhij", g, v) - delta[..., None]) * scale
    dq_bias, dtable = inverse_skew(q, dp, table, max_pos_emb)
    dq = torch.einsum("bhij,bjhd->bihd", dp, k) + dq_bias
    s_t = torch.einsum("bjhd,bihd->bhji", k, q) + transposed_bias(q, table, max_pos_emb)
    p_t = torch.exp(s_t * scale - lse[:, :, None, :])
    dp_t = p_t * (torch.einsum("bjhd,bihd->bhji", v, g) - delta[:, :, None, :]) * scale
    dv = torch.einsum("bhji,bihd->bjhd", p_t, g)
    dk = torch.einsum("bhji,bihd->bjhd", dp_t, q)
    return dq, dk, dv, dtable


def _operands(seed, b, n, h, d, max_pos_emb):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
                  for _ in range(4))
    table = torch.from_numpy(rng.standard_normal((2 * max_pos_emb + 1, d)).astype(np.float32))
    return q, k, v, table, g


def _rel_rms(got, want):
    got, want = got.double(), want.double()
    return float(((got - want).pow(2).mean() / want.pow(2).mean()).sqrt())


SKEW_CASES = [(7, 512), (64, 512), (161, 512), (321, 512), (100, 8)]  # (n, max_pos_emb)


@pytest.mark.parametrize("n,max_pos_emb", SKEW_CASES)
def test_inverse_skew_equals_gather(n, max_pos_emb):
    """n = 64 fills its tiles; 7, 161, 321 leave ragged query and key
    tiles; max_pos_emb 8 clips inside a tile (rows 0 and 16 collect many
    offsets)."""
    q, _, _, table, _ = _operands(n, 2, n, 2, 16, max_pos_emb)
    dp = torch.from_numpy(np.random.default_rng(n + 1).standard_normal((2, 2, n, n))
                          .astype(np.float32))
    dq_bias, dtable = inverse_skew(q, dp, table, max_pos_emb)
    rel = table[fa.relative_index(n, max_pos_emb)]
    torch.testing.assert_close(dq_bias, torch.einsum("bhij,ijd->bihd", dp, rel),
                               rtol=1e-5, atol=1e-4)
    want = torch.zeros(table.shape, dtype=torch.float64)
    want.index_add_(0, fa.relative_index(n, max_pos_emb).reshape(-1),
                    torch.einsum("bihd,bhij->ijd", q, dp).reshape(n * n, -1).double())
    assert _rel_rms(dtable, want) < 1e-6


@pytest.mark.parametrize("n,max_pos_emb", SKEW_CASES)
def test_transposed_bias_equals_gather(n, max_pos_emb):
    q, _, _, table, _ = _operands(n + 7, 1, n, 2, 16, max_pos_emb)
    rel = table[fa.relative_index(n, max_pos_emb)]
    want = torch.einsum("bihd,ijd->bhij", q, rel).transpose(-1, -2)
    torch.testing.assert_close(transposed_bias(q, table, max_pos_emb), want,
                               rtol=1e-6, atol=1e-5)


def test_skews_see_every_offset():
    """Tables whose rows are their own offsets: each skew must address the
    row clip(i - j) for every (i, j), exactly."""
    n, max_pos_emb = 150, 40
    offsets = torch.arange(-max_pos_emb, max_pos_emb + 1, dtype=torch.float32)
    table = offsets[:, None].expand(-1, 16) / 16
    want = (torch.arange(n)[:, None] - torch.arange(n)[None, :]).clamp(
        -max_pos_emb, max_pos_emb).float()
    q = torch.ones(1, n, 1, 16)
    assert torch.equal(transposed_bias(q, table, max_pos_emb)[0, 0], want.T)
    dp = torch.ones(1, 1, n, n)
    dq_bias, _ = inverse_skew(q, dp, table, max_pos_emb)
    assert torch.equal(dq_bias[0, :, 0, 0], want.sum(1) / 16)
    _, counts = inverse_skew(q, dp, torch.zeros_like(table), max_pos_emb)
    want_counts = torch.bincount((want + max_pos_emb).long().reshape(-1),
                                 minlength=2 * max_pos_emb + 1)
    assert torch.equal(counts[:, 0], want_counts.double())


@pytest.mark.parametrize("n,max_pos_emb", SKEW_CASES)
def test_copy_matches_reference(n, max_pos_emb):
    q, k, v, table, g = _operands(3 * n, 1, n, 2, 16, max_pos_emb)
    got = bwd_copy(q, k, v, table, g, max_pos_emb)
    want = fa.shaw_attention_bwd_reference(q, k, v, table, g, max_pos_emb)
    for name, a, w in zip(NAMES, got, want):
        if name == "dtable":
            assert _rel_rms(a, w) < 1e-5, name
        else:
            torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("max_pos_emb", [512, 8])
def test_copy_matches_pallas_backward(d, max_pos_emb):
    """fp32 at small width against the JAX backward kernel."""
    b, n, h = 2, 40, 2
    q, k, v, table, g = _operands(d + max_pos_emb, b, n, h, d, max_pos_emb)
    got = bwd_copy(q, k, v, table, g, max_pos_emb)
    want = pa._bwd_kernel_call(*(jnp.asarray(t.numpy()) for t in (q, k, v, table, g)),
                               max_pos_emb, d ** -0.5, None)
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, "tensor_core"), (torch.bfloat16, 32, "tensor_core"),
    (torch.bfloat16, 4, "cuda_core"), (torch.bfloat16, 8, "cuda_core"),
    (torch.float32, 4, "cuda_core"), (torch.float32, 8, "cuda_core"),
    (torch.float32, 16, "tensor_core_tf32"), (torch.float32, 32, "tensor_core_tf32"),
])
def test_backward_instance_dispatch(dtype, d, want):
    """fused_shaw_attention_bwd picks its instance by kernel_instance
    (direction "backward"): bf16 at d 16 and 32 on bf16 tensor cores, fp32
    at d 16 and 32 on tensor cores in 3xTF32, d 4 and 8 on CUDA cores."""
    assert fa.kernel_instance(dtype, d, "backward") == want


@pytest.mark.parametrize("dtype,d", [(torch.float16, 16), (torch.bfloat16, 64),
                                     (torch.float64, 16), (torch.float32, 12)])
def test_backward_dispatch_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError):
        fa.kernel_instance(dtype, d, "backward")


def test_backward_takes_the_plain_version_on_cpu_for_either_instance():
    """CPU tensors never launch: no count moves."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, table, g = (t.to(dtype) for t in _operands(9, 2, 21, 2, 16, 8))
        before = dict(_native.launches)
        got = fa.fused_shaw_attention_bwd(q, k, v, table, None, None, g, 8)
        assert _native.launches == before
        for name, a, w in zip(NAMES, got, fa.shaw_attention_bwd_reference(q, k, v, table, g, 8)):
            assert torch.equal(a, w), name
