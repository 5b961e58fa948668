"""Fused Shaw relative-position attention for CUDA: forward (K1) and
backward (K2, with K3 folded in).

Replaces ``speech_enhancement_tpu/ops/pallas_attention.py``: the forward
``_attn_kernel`` (via ``_kernel_call``) and the backward
``_attn_bwd_kernel`` / ``_attn_bwd_drel_kernel`` (via ``_bwd_kernel_call``).
K1 and K2 have three instances each: bf16 at head dims 16 and 32 runs on
tensor cores (``csrc/shaw_attention_mma.cu``,
``csrc/shaw_attention_bwd_mma.cu``), fp32 at head dims 16 and 32 on tensor
cores in 3xTF32 (``csrc/shaw_attention_tf32.cu``,
``csrc/shaw_attention_bwd_tf32.cu``), and both dtypes at head dims 4 and 8
on CUDA cores (``csrc/shaw_attention.cu``, ``csrc/shaw_attention_bwd.cu``).
:func:`kernel_instance` picks one from (dtype, head dim, direction).  Each
source's header says what bounds it on an H100 and how it is laid out.
``ShawAttention(fused=True)`` (the time conformer of
``TSCNet(fused_attention=True)``) calls :func:`fused_shaw_attention`,
which is differentiable in q, k, v and the table: under autograd its
forward is K1 (which then also writes each row's log-sum-exp) and its
backward is K2.

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
    "build_bwd_mma",
    "build_bwd_tf32",
    "build_mma",
    "build_tf32",
    "bwd_mma_occupancy",
    "bwd_tf32_occupancy",
    "fused_shaw_attention",
    "fused_shaw_attention_bwd",
    "fused_shaw_attention_fwd",
    "kernel_instance",
    "mma_occupancy",
    "shaw_attention_bwd_reference",
    "shaw_attention_reference",
    "shaw_bias_skewed",
    "tf32_occupancy",
]

# kernel launches since import (or since a caller reset them): K1's CUDA-core
# instance, K1's bf16 and fp32 tensor-core instances, and K2's likewise
launches = 0
mma_launches = 0
tf32_launches = 0
bwd_launches = 0
bwd_mma_launches = 0
bwd_tf32_launches = 0

_HEAD_DIMS = (4, 8, 16, 32)  # the head dims K1 and K2 are built for
_DTYPES = (torch.float32, torch.bfloat16)
# the instance of each (dtype, head dim >= 16, direction); head dims 4 and
# 8 run on CUDA cores
_TENSOR_CORE = {
    (torch.bfloat16, "forward"): "tensor_core",    # csrc/shaw_attention_mma.cu
    (torch.float32, "forward"): "tensor_core_tf32",  # csrc/shaw_attention_tf32.cu
    (torch.bfloat16, "backward"): "tensor_core",   # csrc/shaw_attention_bwd_mma.cu
    (torch.float32, "backward"): "tensor_core_tf32",  # csrc/shaw_attention_bwd_tf32.cu
}
# the tensor-core instances' tiling (kWarps * 16 query rows per block, kBN
# keys per tile, kWarpBand band rows per warp, R' pitch kRP), mirrored by
# shaw_bias_skewed
_MMA_BM, _MMA_BN, _MMA_WARP_ROWS, _MMA_WARP_BAND, _MMA_RP = 64, 64, 16, 80, 20
_LOG2E = 1.4426950408889634
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, table, out, lse, is_bf16, batch, n, h, d,
    # q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, max_pos, scale, stream
    "se_shaw_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _L, _L, _L, _L, _L, _L, _I, _F, _P],
}
_SIGNATURES_MMA = {
    # q, k, v, table, out, lse, batch, n, h, d,
    # q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, max_pos, scale * log2(e), stream
    "se_shaw_attention_mma": [_P] * 6 + [_I] * 4 + [_L] * 6 + [_I, _F, _P],
    # d, *blocks
    "se_shaw_attention_mma_occupancy": [_I, ctypes.POINTER(ctypes.c_int)],
}
_SIGNATURES_TF32 = {
    # as se_shaw_attention_mma, fp32 operands
    "se_shaw_attention_tf32": [_P] * 6 + [_I] * 4 + [_L] * 6 + [_I, _F, _P],
    # d, *blocks
    "se_shaw_attention_tf32_occupancy": [_I, ctypes.POINTER(ctypes.c_int)],
}
_SIGNATURES_BWD = {
    # q, k, v, table, out, g, lse, delta, dq, dk, dv, dtable, is_bf16, batch,
    # n, h, d, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, max_pos, scale, groups,
    # band_rows, stream
    "se_shaw_attention_bwd": [_P] * 12 + [_I] * 5 + [_L] * 6
                             + [_I, _F, _I, _I, _P],
}
_SIGNATURES_BWD_MMA = {
    # q, k, v, table, out, g, lse, delta, dq, dk, dv, dtable, batch, n, h, d,
    # q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, max_pos, scale, groups, band_rows,
    # stream
    "se_shaw_attention_bwd_mma": [_P] * 12 + [_I] * 4 + [_L] * 6 + [_I, _F, _I, _I, _P],
    # d, band_rows, *blocks of pass A, *blocks of pass B
    "se_shaw_attention_bwd_mma_occupancy": [_I, _I, ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_int)],
}
_SIGNATURES_BWD_TF32 = {
    # as se_shaw_attention_bwd_mma, fp32 operands
    "se_shaw_attention_bwd_tf32": _SIGNATURES_BWD_MMA["se_shaw_attention_bwd_mma"],
    # d, band_rows, *blocks of pass A, *blocks of pass B
    "se_shaw_attention_bwd_tf32_occupancy":
        _SIGNATURES_BWD_MMA["se_shaw_attention_bwd_mma_occupancy"],
}
_BM = 64  # query rows per block of K2's pass A (csrc/shaw_attention_bwd.cu kBM)
_SMEM_BYTES = 227 * 1024  # shared memory a block may use on an H100
_STATIC_SMEM_BYTES = 40 * 1024  # K2 pass A's static share, rounded up
_BWD_BLOCKS = 132 * 8  # pass A's target grid: 8 blocks per H100 SM


def build() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shaw_attention.cu`` (K1)."""
    return _native.load("shaw_attention", _SIGNATURES)


def build_mma() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shaw_attention_mma.cu`` (K1,
    the bf16 tensor-core instance)."""
    return _native.load("shaw_attention_mma", _SIGNATURES_MMA)


def build_tf32() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shaw_attention_tf32.cu`` (K1,
    the fp32 tensor-core instance)."""
    return _native.load("shaw_attention_tf32", _SIGNATURES_TF32)


def mma_occupancy(d: int) -> int:
    """Resident blocks (of 4 warps) per SM of the bf16 tensor-core instance
    at head dim ``d``, as the CUDA runtime computes it for the built kernel."""
    blocks = ctypes.c_int(0)
    _native.check(build_mma().se_shaw_attention_mma_occupancy(d, ctypes.byref(blocks)),
                  "se_shaw_attention_mma_occupancy")
    return blocks.value


def tf32_occupancy(d: int) -> int:
    """Resident blocks (of 4 warps) per SM of the fp32 tensor-core instance
    at head dim ``d``, as the CUDA runtime computes it for the built kernel."""
    blocks = ctypes.c_int(0)
    _native.check(build_tf32().se_shaw_attention_tf32_occupancy(d, ctypes.byref(blocks)),
                  "se_shaw_attention_tf32_occupancy")
    return blocks.value


def kernel_instance(dtype: torch.dtype, d: int, direction: str = "forward") -> str:
    """Which instance of K1 (``direction="forward"``) or K2
    (``"backward"``) takes operands of ``dtype`` at head dim ``d``:
    ``"tensor_core"`` (bf16 at d 16 or 32: bf16 mma.sync, fp32
    accumulate), ``"tensor_core_tf32"`` (fp32 at d 16 or 32: 3xTF32
    mma.sync, about fp32's accuracy) or ``"cuda_core"`` (d 4 or 8, below
    one mma k-step), in either direction.  Dispatch, not a fallback: a
    failed build or launch of the chosen instance raises."""
    if dtype not in _DTYPES or d not in _HEAD_DIMS or direction not in ("forward", "backward"):
        raise ValueError(f"no K1 or K2 instance for {dtype} at head dim {d} ({direction})")
    return _TENSOR_CORE.get((dtype, direction), "cuda_core") if d >= 16 else "cuda_core"


def build_bwd() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shaw_attention_bwd.cu`` (K2)."""
    return _native.load("shaw_attention_bwd", _SIGNATURES_BWD)


def build_bwd_mma() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shaw_attention_bwd_mma.cu``
    (K2, the bf16 tensor-core instance)."""
    return _native.load("shaw_attention_bwd_mma", _SIGNATURES_BWD_MMA)


def build_bwd_tf32() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/shaw_attention_bwd_tf32.cu``
    (K2, the fp32 tensor-core instance)."""
    return _native.load("shaw_attention_bwd_tf32", _SIGNATURES_BWD_TF32)


def _bwd_occupancy(lib: ctypes.CDLL, entry: str, d: int, n: int,
                   max_pos_emb: int) -> tuple[int, int]:
    a, b = ctypes.c_int(0), ctypes.c_int(0)
    band_rows = min(_BM + n - 1, 2 * max_pos_emb + 1)
    _native.check(getattr(lib, entry)(d, band_rows, ctypes.byref(a), ctypes.byref(b)), entry)
    return a.value, b.value


def bwd_mma_occupancy(d: int, n: int, max_pos_emb: int = 512) -> tuple[int, int]:
    """Resident blocks (of 4 warps) per SM of the bf16 tensor-core K2's pass
    A, whose band of clipped table rows grows with ``n``, and pass B at head
    dim ``d``, as the CUDA runtime computes them for the built kernels."""
    return _bwd_occupancy(build_bwd_mma(), "se_shaw_attention_bwd_mma_occupancy", d, n,
                          max_pos_emb)


def bwd_tf32_occupancy(d: int, n: int, max_pos_emb: int = 512) -> tuple[int, int]:
    """As :func:`bwd_mma_occupancy`, for the fp32 tensor-core K2."""
    return _bwd_occupancy(build_bwd_tf32(), "se_shaw_attention_bwd_tf32_occupancy", d, n,
                          max_pos_emb)


def relative_index(n: int, max_pos_emb: int, device=None) -> torch.Tensor:
    """``[n, n]`` table rows ``clip(i - j, +-max_pos_emb) + max_pos_emb``."""
    pos = torch.arange(n, device=device)
    return (pos[:, None] - pos[None, :]).clamp(-max_pos_emb, max_pos_emb) + max_pos_emb


def shaw_bias_skewed(q: torch.Tensor, rel_table: torch.Tensor,
                     max_pos_emb: int = 512) -> torch.Tensor:
    """The unscaled Shaw bias ``[B, h, n, n]`` (fp32), built the way the
    tensor-core instance of K1 builds it: for each warp's 16 query rows
    and each key tile of 64, the 80 clipped table rows of offsets
    ``i_w - j_0 - 63 + r`` form a band, ``R'[r][i] = E_band[r] . q_i`` is
    written to a flat buffer at row pitch 20, and ``bias[i][j]`` is read at
    ``63 * 20 + i * 21 - j * 20``: the skew as an address pattern.  Equals
    ``q . rel_table[relative_index]`` up to summation order."""
    b, n, h, d = q.shape
    rows, tile, band, pitch = _MMA_WARP_ROWS, _MMA_BN, _MMA_WARP_BAND, _MMA_RP
    nw, nj = -(-n // rows), -(-n // tile)
    qp = torch.zeros((b, nw * rows, h, d), dtype=torch.float32, device=q.device)
    qp[:, :n] = q.float()
    qp = qp.view(b, nw, rows, h, d)
    offsets = (rows * torch.arange(nw, device=q.device)[:, None, None]
               - tile * torch.arange(nj, device=q.device)[None, :, None]
               - (tile - 1) + torch.arange(band, device=q.device))
    e_band = rel_table.float()[offsets.clamp(-max_pos_emb, max_pos_emb) + max_pos_emb]
    r_t = torch.einsum("bwihd,wjrd->bhwjri", qp, e_band)  # R'[r][i]
    flat = torch.zeros((b, h, nw, nj, band, pitch), dtype=torch.float32, device=q.device)
    flat[..., :rows] = r_t
    il = torch.arange(rows, device=q.device)[:, None]
    jl = torch.arange(tile, device=q.device)[None, :]
    address = (tile - 1) * pitch + il * (pitch + 1) - jl * pitch  # [16, 64]
    tiles = flat.view(b, h, nw, nj, band * pitch)[..., address]  # [b, h, nw, nj, 16, 64]
    bias = tiles.permute(0, 1, 2, 4, 3, 5).reshape(b, h, nw * rows, nj * tile)
    return bias[:, :, :n, :n]


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


def _check_alignment(q, k, v, table, out=None, g=None):
    """The tensor-core instances copy 16-byte chunks of q, k, v and table
    rows: every base pointer 16-byte aligned, batch and sequence strides
    multiples of 16 bytes (8 bf16 or 4 fp32 elements).  The backward's
    contiguous ``out`` and ``g``, where given, need aligned base pointers
    too.  Raises before any launch otherwise."""
    named = [("q", q), ("k", k), ("v", v), ("rel_table", table), ("out", out), ("g", g)]
    for name, t in ((name, t) for name, t in named if t is not None):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (data_ptr % 16 = "
                             f"{t.data_ptr() % 16}), which the {q.dtype} tensor-core "
                             f"kernel needs")
    per_chunk = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(0) % per_chunk or t.stride(1) % per_chunk:
            raise ValueError(f"{name}'s batch and sequence strides {t.stride()[:2]} "
                             f"must be multiples of {per_chunk} elements (16 bytes)")
    b, n, h, _ = q.shape
    if b * h * -(-n // _MMA_BM) >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def fused_shaw_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             table: torch.Tensor, max_pos_emb: int, scale: float,
                             with_lse: bool):
    """K1 on CUDA tensors (the plain version on CPU tensors): ``(out,
    lse)``, with ``lse`` the ``[B, h, n]`` fp32 row log-sum-exp that K2
    takes when ``with_lse`` and the kernel ran, else None.  ``table`` is in
    q's dtype.  The instance is :func:`kernel_instance`'s."""
    global launches, mma_launches, tf32_launches
    if q.device.type == "cpu":
        return shaw_attention_reference(q, k, v, table, max_pos_emb, scale), None
    if q.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {q.device}")
    _check(q, k, v, table, max_pos_emb)
    b, n, h, d = q.shape
    table = table.contiguous()
    instance = kernel_instance(q.dtype, d, "forward")
    if instance != "cuda_core":
        _check_alignment(q, k, v, table)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or n == 0:
        return out, lse
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None)
    if instance == "tensor_core":
        status = build_mma().se_shaw_attention_mma(
            *pointers, b, n, h, d, *strides, max_pos_emb, float(scale) * _LOG2E,
            _native.current_stream(q.device))
        _native.check(status, "se_shaw_attention_mma")
        mma_launches += 1
    elif instance == "tensor_core_tf32":
        status = build_tf32().se_shaw_attention_tf32(
            *pointers, b, n, h, d, *strides, max_pos_emb, float(scale) * _LOG2E,
            _native.current_stream(q.device))
        _native.check(status, "se_shaw_attention_tf32")
        tf32_launches += 1
    else:
        status = build().se_shaw_attention(
            *pointers, int(q.dtype == torch.bfloat16), b, n, h, d, *strides, max_pos_emb,
            float(scale), _native.current_stream(q.device))
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
    for the output gradient ``g``, by K2 (the instance
    :func:`kernel_instance` picks).  ``out`` and ``lse`` are the
    forward's output and row log-sum-exp (K1 writes both); ``rel_table``
    is in q's dtype.  dq, dk, dv come back contiguous in q's dtype, dtable
    in the table's (summed in fp32 with atomics, so not bit-deterministic
    from run to run).  CPU tensors take the plain version, which needs
    neither ``out`` nor ``lse``."""
    global bwd_launches, bwd_mma_launches, bwd_tf32_launches
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
    instance = kernel_instance(q.dtype, d, "backward")
    band_rows = min(_BM + n - 1, 2 * max_pos_emb + 1)
    # the tensor-core entry points refuse a band that does not fit themselves
    if instance == "cuda_core" and band_rows * d * 4 + _STATIC_SMEM_BYTES > _SMEM_BYTES:
        raise ValueError(f"max_pos_emb {max_pos_emb} at head dim {d} exceeds "
                         f"the backward kernel's shared memory")
    table = rel_table.contiguous()
    out, g, lse = out.contiguous(), g.contiguous(), lse.contiguous()
    if instance != "cuda_core":
        _check_alignment(q, k, v, table, out, g)
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    dtable = torch.zeros(table.shape, dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return dq, dk, dv, dtable.to(table.dtype)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    groups = max(1, min(b, -(-_BWD_BLOCKS // (h * -(-n // _BM)))))
    pointers = (_ptr(q), _ptr(k), _ptr(v), _ptr(table), _ptr(out), _ptr(g), _ptr(lse),
                _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dtable))
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    stream = _native.current_stream(q.device)
    if instance == "tensor_core":
        status = build_bwd_mma().se_shaw_attention_bwd_mma(
            *pointers, b, n, h, d, *strides, max_pos_emb, float(scale), groups, band_rows,
            stream)
        _native.check(status, "se_shaw_attention_bwd_mma")
        bwd_mma_launches += 1
    elif instance == "tensor_core_tf32":
        status = build_bwd_tf32().se_shaw_attention_bwd_tf32(
            *pointers, b, n, h, d, *strides, max_pos_emb, float(scale), groups, band_rows,
            stream)
        _native.check(status, "se_shaw_attention_bwd_tf32")
        bwd_tf32_launches += 1
    else:
        status = build_bwd().se_shaw_attention_bwd(
            *pointers, int(q.dtype == torch.bfloat16), b, n, h, d, *strides, max_pos_emb,
            float(scale), groups, band_rows, stream)
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
