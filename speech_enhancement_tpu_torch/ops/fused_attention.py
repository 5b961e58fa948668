"""Fused Shaw relative-position attention forward (K1) for CUDA.

Replaces ``speech_enhancement_tpu/ops/pallas_attention.py``
(``_attn_kernel`` via ``_kernel_call`` / ``fused_shaw_attention``).  The
kernel lives in ``csrc/shaw_attention.cu``, whose header says what bounds
it on an H100 and how it is laid out: an online softmax over key tiles, so
any sequence length runs in bounded shared memory, with the clipped Shaw
offsets computed in the kernel.  ``ShawAttention(fused=True)`` (the time
conformer of ``TSCNet(fused_attention=True)``) calls it.

:func:`fused_shaw_attention` launches the kernel for CUDA tensors and
takes the plain PyTorch version, :func:`shaw_attention_reference`, only
for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from speech_enhancement_tpu_torch.ops import _native

__all__ = ["build", "fused_shaw_attention", "shaw_attention_reference"]

# kernel launches of the wrapper since import (or since a caller reset it)
launches = 0

_HEAD_DIMS = (4, 8, 16, 32)  # csrc/shaw_attention.cu template instances
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, table, out, is_bf16, batch, n, h, d,
    # q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, max_pos, scale, stream
    "se_shaw_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _L, _L, _L, _L, _L, _L, _I, ctypes.c_float, _P],
}


def build() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shaw_attention.cu``."""
    return _native.load("shaw_attention", _SIGNATURES)


def relative_index(n: int, max_pos_emb: int, device=None) -> torch.Tensor:
    """``[n, n]`` table rows ``clip(i - j, +-max_pos_emb) + max_pos_emb``."""
    pos = torch.arange(n, device=device)
    return (pos[:, None] - pos[None, :]).clamp(-max_pos_emb, max_pos_emb) + max_pos_emb


def shaw_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             rel_table: torch.Tensor, max_pos_emb: int = 512,
                             scale: float | None = None) -> torch.Tensor:
    """Plain version of :func:`fused_shaw_attention` with the Pallas
    kernel's numerics: operands rounded to q's dtype, fp32 logits and
    softmax, P rounded to v's dtype, fp32 accumulation of P.V, output in
    q's dtype.  Materializes the ``[B, h, n, n]`` fp32 logits."""
    n, d = q.shape[1], q.shape[3]
    if scale is None:
        scale = d ** -0.5
    rel = rel_table[relative_index(n, max_pos_emb, q.device)].to(q.dtype).float()
    qf, kf = q.float(), k.float()
    dots = torch.einsum("bihd,bjhd->bhij", qf, kf)
    bias = torch.einsum("bihd,ijd->bhij", qf, rel)
    attn = torch.softmax((dots + bias) * scale, dim=-1).to(v.dtype).float()
    return torch.einsum("bhij,bjhd->bihd", attn, v.float()).to(q.dtype)


def _check(q, k, v, rel_table, max_pos_emb):
    for name, t in (("q", q), ("k", k), ("v", v), ("rel_table", rel_table)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {_DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, n, h, d] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if rel_table.shape != (2 * max_pos_emb + 1, d):
        raise ValueError(f"rel_table must be [{2 * max_pos_emb + 1}, {d}], got "
                         f"{tuple(rel_table.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{name} must have unit stride over d and stride d "
                             f"over heads, got strides {t.stride()}")
    if b * h >= 2 ** 31 or -(-n // 64) > 65535:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")


def fused_shaw_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_table: torch.Tensor, max_pos_emb: int = 512,
                         scale: float | None = None) -> torch.Tensor:
    """``softmax((q k^T + shaw_bias) * scale) v`` for all heads, with
    ``shaw_bias[i, j] = q_i . rel_table[clip(i - j, +-max_pos_emb) + max_pos_emb]``.

    ``q, k, v``: ``[B, n, heads, d]``, fp32 or bf16; k and v may be views
    with any batch and sequence strides (the halves of the ``to_kv``
    output).  ``rel_table``: ``[2 * max_pos_emb + 1, d]``.  Returns a
    contiguous ``[B, n, heads, d]`` in the dtype of q.
    """
    global launches
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return shaw_attention_reference(q, k, v, rel_table, max_pos_emb, scale)
    if q.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {q.device}")
    _check(q, k, v, rel_table, max_pos_emb)
    b, n, h, d = q.shape
    table = rel_table.to(q.dtype).contiguous()
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or n == 0:
        return out
    lib = build()
    status = lib.se_shaw_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(table.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), int(q.dtype == torch.bfloat16),
        b, n, h, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), max_pos_emb, float(scale),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _native.check(status, "se_shaw_attention")
    launches += 1
    return out
