"""The arithmetic of K1's bf16 tensor-core instance (csrc/shaw_attention_mma.cu),
as far as the CPU can hold it: its Shaw-bias skew, the (dtype, head dim)
dispatch between the two K1 instances, and the checks that refuse what the
kernel cannot take before any launch.  The kernel itself runs only on the
card (chip_smoke.py holds it against shaw_attention_reference there).

The skew: shaw_bias_skewed builds the bias as the kernel does (a clipped
band of 80 table rows per warp of 16 queries and key tile of 64,
R' = E_band q^T written at row pitch 20, read at 63 * 20 + i * 21 - j * 20)
and is held to the relative_index gather in fp32 at rtol 1e-6, plus atol
1e-5 for entries near zero: both sum the same 16 or 32 products per entry
in another order, with partial sums up to about 8 whose fp32 step is
9.5e-7.  A table of offsets checks the addresses exactly.
"""

import numpy as np
import pytest
import torch

from speech_enhancement_tpu_torch.ops import fused_attention as fa

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


def _gather_bias(q, table, max_pos_emb):
    n = q.shape[1]
    rel = table[fa.relative_index(n, max_pos_emb)].float()
    return torch.einsum("bihd,ijd->bhij", q.float(), rel)


@pytest.mark.parametrize("max_pos_emb", [8, 512])
@pytest.mark.parametrize("n", [7, 64, 100, 321, 1281])
def test_skewed_bias_equals_gather(n, max_pos_emb):
    """n = 64 fills its tiles; 7, 100, 321 and 1281 leave ragged last
    query and key tiles; max_pos_emb 8 clips inside a tile, 512 clips
    only at n = 1281."""
    d, h = (32, 1) if n == 1281 else (16, 2)
    rng = np.random.default_rng(n + max_pos_emb)
    q = torch.from_numpy(rng.standard_normal((1, n, h, d)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((2 * max_pos_emb + 1, d)).astype(np.float32))
    got = fa.shaw_bias_skewed(q, table, max_pos_emb)
    assert got.shape == (1, h, n, n) and got.dtype == torch.float32
    torch.testing.assert_close(got, _gather_bias(q, table, max_pos_emb), rtol=1e-6, atol=1e-5)


def test_skewed_bias_sees_every_offset():
    """A table whose rows are their own offsets: the skew must read the
    row clip(i - j) for every (i, j), exactly."""
    n, max_pos_emb = 150, 40
    q = torch.ones(1, n, 1, 16)
    table = torch.arange(-max_pos_emb, max_pos_emb + 1, dtype=torch.float32)[:, None]
    table = table.expand(-1, 16) / 16
    want = (torch.arange(n)[:, None] - torch.arange(n)[None, :]).clamp(-max_pos_emb,
                                                                       max_pos_emb).float()
    assert torch.equal(fa.shaw_bias_skewed(q, table, max_pos_emb)[0, 0], want)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, "tensor_core"), (torch.bfloat16, 32, "tensor_core"),
    (torch.bfloat16, 4, "cuda_core"), (torch.bfloat16, 8, "cuda_core"),
    (torch.float32, 4, "cuda_core"), (torch.float32, 16, "tensor_core_tf32"),
    (torch.float32, 32, "tensor_core_tf32"),
])
def test_kernel_instance_dispatch(dtype, d, want):
    """K1's instance (the forward, kernel_instance's default direction):
    bf16 at d 16 and 32 on bf16 tensor cores, fp32 there in 3xTF32, d 4
    and 8 on CUDA cores."""
    assert fa.kernel_instance(dtype, d) == want
    assert fa.kernel_instance(dtype, d, "forward") == want


@pytest.mark.parametrize("dtype,d", [(torch.float16, 16), (torch.bfloat16, 12),
                                     (torch.float32, 64)])
def test_kernel_instance_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError):
        fa.kernel_instance(dtype, d)


def _aligned_operands(b=2, n=9, h=4, d=16):
    kv = torch.zeros(b, n, 2 * h * d, dtype=torch.bfloat16)
    k, v = (t.view(b, n, h, d) for t in kv.chunk(2, dim=-1))
    q = torch.zeros(b, n, h, d, dtype=torch.bfloat16)
    return q, k, v, torch.zeros(1025, d, dtype=torch.bfloat16)


def _misaligned(kind):
    q, k, v, table = _aligned_operands()
    if kind == "q_pointer":  # a view 2 bytes into its storage
        q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    elif kind == "table_pointer":
        table = torch.zeros(table.numel() + 8, dtype=torch.bfloat16)[4:-4].view(table.shape)
    elif kind == "kv_row_stride":  # rows of 68 elements: 136 bytes
        kv = torch.zeros(2, 9, 2 * 64 + 4, dtype=torch.bfloat16)
        k, v = kv[..., :64].view(2, 9, 4, 16), kv[..., 64:128].view(2, 9, 4, 16)
    elif kind == "v_pointer":  # v 8 bytes past a 16-byte boundary
        kv = torch.zeros(2, 9, 2 * 64 + 4, dtype=torch.bfloat16)
        v = kv[..., 4:68].view(2, 9, 4, 16)
    return q, k, v, table


def test_alignment_check_passes_the_time_conformer_layout():
    fa._check_alignment(*_aligned_operands())


@pytest.mark.parametrize("kind", ["q_pointer", "table_pointer", "kv_row_stride", "v_pointer"])
def test_alignment_check_raises_before_launch(kind):
    q, k, v, table = _misaligned(kind)
    fa._check(q, k, v, table, 512)  # the shape checks pass: only alignment is wrong
    with pytest.raises(ValueError):
        fa._check_alignment(q, k, v, table)
