"""Fused Shaw relative-position attention for CUDA: forward (K1) and
backward (K2, with K3 folded in).

Replaces ``speech_enhancement_tpu/ops/pallas_attention.py``: the forward
``_attn_kernel`` (via ``_kernel_call``) and the backward
``_attn_bwd_kernel`` / ``_attn_bwd_drel_kernel`` (via ``_bwd_kernel_call``).
The kernels live in ``csrc/shaw_attention.cu`` and
``csrc/shaw_attention_bwd.cu``, whose headers say what bounds them on an
H100 and how they are laid out.  ``ShawAttention(fused=True)`` (the time
conformer of ``TSCNet(fused_attention=True)``) calls
:func:`fused_shaw_attention`, which is differentiable in q, k, v and the
table: under autograd its forward is K1 (which then also writes each row's
log-sum-exp) and its backward is K2.

Every wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version (:func:`shaw_attention_reference`,
:func:`shaw_attention_bwd_reference`) only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from speech_enhancement_tpu_torch.ops import _native

__all__ = [
    "build",
    "build_bwd",
    "fused_shaw_attention",
    "fused_shaw_attention_bwd",
    "fused_shaw_attention_fwd",
    "shaw_attention_bwd_reference",
    "shaw_attention_reference",
]

# kernel launches of each wrapper since import (or since a caller reset it)
launches = 0
bwd_launches = 0

_HEAD_DIMS = (4, 8, 16, 32)  # csrc/shaw_attention.cu template instances
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, table, out, lse, is_bf16, batch, n, h, d,
    # q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, max_pos, scale, stream
    "se_shaw_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _L, _L, _L, _L, _L, _L, _I, _F, _P],
}
_SIGNATURES_BWD = {
    # q, k, v, table, out, g, lse, delta, dq, dk, dv, dtable, is_bf16, batch,
    # n, h, d, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, max_pos, scale, groups,
    # band_rows, stream
    "se_shaw_attention_bwd": [_P] * 12 + [_I] * 5 + [_L] * 6
                             + [_I, _F, _I, _I, _P],
}
_BM = 64  # query rows per block of K2's pass A (csrc/shaw_attention_bwd.cu kBM)
_SMEM_BYTES = 227 * 1024  # shared memory a block may use on an H100
_STATIC_SMEM_BYTES = 40 * 1024  # K2 pass A's static share, rounded up
_BWD_BLOCKS = 132 * 8  # pass A's target grid: 8 blocks per H100 SM


def build() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shaw_attention.cu`` (K1)."""
    return _native.load("shaw_attention", _SIGNATURES)


def build_bwd() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shaw_attention_bwd.cu`` (K2)."""
    return _native.load("shaw_attention_bwd", _SIGNATURES_BWD)


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


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def fused_shaw_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             table: torch.Tensor, max_pos_emb: int, scale: float,
                             with_lse: bool):
    """K1 on CUDA tensors (the plain version on CPU tensors): ``(out,
    lse)``, with ``lse`` the ``[B, h, n]`` fp32 row log-sum-exp that K2
    takes when ``with_lse`` and the kernel ran, else None.  ``table`` is in
    q's dtype."""
    global launches
    if q.device.type == "cpu":
        return shaw_attention_reference(q, k, v, table, max_pos_emb, scale), None
    if q.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {q.device}")
    _check(q, k, v, table, max_pos_emb)
    b, n, h, d = q.shape
    table = table.contiguous()
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or n == 0:
        return out, lse
    lib = build()
    status = lib.se_shaw_attention(
        _ptr(q), _ptr(k), _ptr(v), _ptr(table), _ptr(out),
        _ptr(lse) if with_lse else None, int(q.dtype == torch.bfloat16),
        b, n, h, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), max_pos_emb, float(scale), _stream(q))
    _native.check(status, "se_shaw_attention")
    launches += 1
    return out, lse


def shaw_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 rel_table: torch.Tensor, g: torch.Tensor,
                                 max_pos_emb: int = 512, scale: float | None = None):
    """Plain version of :func:`fused_shaw_attention_bwd`: the formulas of
    the TPU backward kernel (``_attn_bwd_kernel`` with
    ``_recompute_softmax_ds``) with its roundings, in fp32 over
    materialized ``[B, h, n, n]`` logits.

    ``dV = P^T G``, ``dS = P o (G V^T - rowsum(P o G V^T))``, ``dp = dS *
    scale`` rounded to q's dtype, ``dQ = dp K + sum_j dp[i, j]
    E[clip(i - j)]``, ``dK = dp^T Q``; P (fp32) is rounded to q's dtype
    before ``P^T G``; the table gradient sums ``q_i dp[i, j]`` over
    batch and heads into row ``clip(i - j) + max_pos_emb`` (that last
    segment sum in float64: a clipped row collects up to n^2 / 2 pairs,
    whose fp32 sum would be less exact than the kernel's blocked one).
    Returns ``(dq, dk, dv, dtable)``: dq, dk, dv in q's dtype, dtable in
    the table's."""
    n, d = q.shape[1], q.shape[3]
    if scale is None:
        scale = d ** -0.5
    dtype = q.dtype
    idx = relative_index(n, max_pos_emb, q.device)
    rel = rel_table[idx].to(dtype).float()  # [i, j, d]
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    logits = (torch.einsum("bihd,bjhd->bhij", qf, kf)
              + torch.einsum("bihd,ijd->bhij", qf, rel)) * scale
    attn = torch.softmax(logits, dim=-1)
    dattn = torch.einsum("bihd,bjhd->bhij", gf, vf)
    ds = attn * (dattn - (attn * dattn).sum(dim=-1, keepdim=True))
    dp = (ds * scale).to(dtype).float()
    dv = torch.einsum("bhij,bihd->bjhd", attn.to(dtype).float(), gf)
    dk = torch.einsum("bhij,bihd->bjhd", dp, qf)
    dq = (torch.einsum("bhij,bjhd->bihd", dp, kf)
          + torch.einsum("bhij,ijd->bihd", dp, rel))
    drel = torch.einsum("bihd,bhij->ijd", qf, dp)
    dtable = torch.zeros(rel_table.shape, dtype=torch.float64, device=q.device)
    dtable.index_add_(0, idx.reshape(-1), drel.reshape(n * n, d).double())
    return dq.to(dtype), dk.to(dtype), dv.to(dtype), dtable.to(rel_table.dtype)


def fused_shaw_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             rel_table: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor | None, g: torch.Tensor,
                             max_pos_emb: int = 512, scale: float | None = None):
    """Gradients ``(dq, dk, dv, dtable)`` of :func:`fused_shaw_attention`
    for the output gradient ``g``, by K2.  ``out`` and ``lse`` are the
    forward's output and row log-sum-exp (K1 writes both); ``rel_table``
    is in q's dtype.  dq, dk, dv come back contiguous in q's dtype, dtable
    in the table's (summed in fp32 with atomics, so not bit-deterministic
    from run to run).  CPU tensors take the plain version, which needs
    neither ``out`` nor ``lse``."""
    global bwd_launches
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return shaw_attention_bwd_reference(q, k, v, rel_table, g, max_pos_emb, scale)
    if q.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {q.device}")
    _check(q, k, v, rel_table, max_pos_emb)
    b, n, h, d = q.shape
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q, got {tuple(t.shape)} {t.dtype}")
    if lse is None or lse.shape != (b, h, n) or lse.dtype != torch.float32:
        raise ValueError("lse must be the forward's [B, h, n] fp32 log-sum-exp")
    band_rows = min(_BM + n - 1, 2 * max_pos_emb + 1)
    if band_rows * d * 4 + _STATIC_SMEM_BYTES > _SMEM_BYTES:
        raise ValueError(f"max_pos_emb {max_pos_emb} at head dim {d} exceeds "
                         f"the backward kernel's shared memory")
    table = rel_table.contiguous()
    out, g, lse = out.contiguous(), g.contiguous(), lse.contiguous()
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    dtable = torch.zeros(table.shape, dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return dq, dk, dv, dtable.to(table.dtype)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    groups = max(1, min(b, -(-_BWD_BLOCKS // (h * -(-n // _BM)))))
    lib = build_bwd()
    status = lib.se_shaw_attention_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(table), _ptr(out), _ptr(g), _ptr(lse),
        _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dtable),
        int(q.dtype == torch.bfloat16), b, n, h, d, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), max_pos_emb,
        float(scale), groups, band_rows, _stream(q))
    _native.check(status, "se_shaw_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv, dtable.to(table.dtype)


class _FusedShawAttention(torch.autograd.Function):
    """K1 forward (with the row log-sum-exp), K2 backward."""

    @staticmethod
    def forward(ctx, q, k, v, table, max_pos_emb, scale):
        out, lse = fused_shaw_attention_fwd(q, k, v, table, max_pos_emb, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, table, out, lse)
        ctx.max_pos_emb, ctx.scale = max_pos_emb, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, table, out, lse = ctx.saved_tensors
        dq, dk, dv, dtable = fused_shaw_attention_bwd(
            q, k, v, table, out, lse, g, ctx.max_pos_emb, ctx.scale)
        return dq, dk, dv, dtable, None, None


def fused_shaw_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_table: torch.Tensor, max_pos_emb: int = 512,
                         scale: float | None = None) -> torch.Tensor:
    """``softmax((q k^T + shaw_bias) * scale) v`` for all heads, with
    ``shaw_bias[i, j] = q_i . rel_table[clip(i - j, +-max_pos_emb) + max_pos_emb]``.

    ``q, k, v``: ``[B, n, heads, d]``, fp32 or bf16; k and v may be views
    with any batch and sequence strides (the halves of the ``to_kv``
    output).  ``rel_table``: ``[2 * max_pos_emb + 1, d]``, used in q's
    dtype.  Returns a contiguous ``[B, n, heads, d]`` in the dtype of q.
    Differentiable in q, k, v and the table (backward: K2); without
    autograd the forward writes no log-sum-exp.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    table = rel_table.to(q.dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, table)):
        return _FusedShawAttention.apply(q, k, v, table, max_pos_emb, scale)
    return fused_shaw_attention_fwd(q, k, v, table, max_pos_emb, scale, with_lse=False)[0]
