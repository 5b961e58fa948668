"""Conformer block (port of speech_enhancement_tpu/models/conformer.py).

FF(0.5) -> MHSA with Shaw relative positions -> conv module -> FF(0.5) ->
post-LayerNorm, residual around each.  Operates on ``[B, N, C]``.  Module
nesting mirrors the reference torch conformer so that ``state_dict`` keys
are the ones ``export_tscnet`` writes (``ff1.fn.fn.net.0``, ``attn.fn.to_q``,
``conv.net.5.running_mean``, ...).

LayerNorms use eps 1e-6, flax's default, as the JAX package does.
"""

from __future__ import annotations

import torch
from torch import nn

from speech_enhancement_tpu_torch.models.layers import Swish
from speech_enhancement_tpu_torch.ops.fused_attention import (
    fused_shaw_attention,
    relative_index,
)

LN_EPS = 1e-6


class Scale(nn.Module):
    def __init__(self, scale: float, fn: nn.Module):
        super().__init__()
        self.scale = scale
        self.fn = fn

    def forward(self, x):
        return self.fn(x) * self.scale


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class FeedForward(nn.Module):
    """Linear(4x) -> swish -> dropout -> Linear -> dropout (pre-norm and
    the 0.5 scale are applied around it)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(dim, dim * mult), Swish(), nn.Dropout(dropout),
            nn.Linear(dim * mult, dim), nn.Dropout(dropout),
        )

    def forward(self, x):
        return self.net(x)


class ShawAttention(nn.Module):
    """Multi-head self-attention with Shaw relative positions
    (``conformer.py:56-150``).

    ``fused=True`` runs the K1 kernel (``ops/fused_attention.py``) on the
    projections as the Linears lay them out.  The eager path scales the
    content and position logits separately and takes the softmax in the
    logits dtype, as the JAX eager path does.
    """

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 16,
                 dropout: float = 0.0, max_pos_emb: int = 512, fused: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        self.max_pos_emb = max_pos_emb
        self.fused = fused
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.rel_pos_emb = nn.Embedding(2 * max_pos_emb + 1, dim_head)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x).view(b, n, h, d)
        k, v = (t.view(b, n, h, d) for t in self.to_kv(x).chunk(2, dim=-1))
        table = self.rel_pos_emb.weight
        if self.fused:
            out = fused_shaw_attention(q, k, v, table, self.max_pos_emb, self.scale)
        else:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [b, h, n, d]
            dots = torch.einsum("bhid,bhjd->bhij", q, k) * self.scale
            rel = table[relative_index(n, self.max_pos_emb, x.device)].to(q.dtype)
            pos = torch.einsum("bhid,ijd->bhij", q, rel) * self.scale
            attn = torch.softmax(dots + pos, dim=-1).to(v.dtype)
            out = torch.einsum("bhij,bhjd->bhid", attn, v).transpose(1, 2)
        out = out.reshape(b, n, h * d).to(x.dtype)
        return self.dropout(self.to_out(out))


class Transpose(nn.Module):
    def forward(self, x):
        return x.transpose(1, 2)


class DepthWiseConv1d(nn.Module):
    def __init__(self, chan: int, kernel_size: int, padding: tuple[int, int]):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv1d(chan, chan, kernel_size, groups=chan)

    def forward(self, x):
        return self.conv(nn.functional.pad(x, self.padding))


class ConvModule(nn.Module):
    """LayerNorm -> pointwise (2x expansion, doubled for the GLU) -> GLU ->
    depthwise k=31 padded (15, 15) -> BatchNorm (eval: running stats, eps
    1e-5) -> swish -> pointwise -> dropout (``conformer.py:153-186``)."""

    def __init__(self, dim: int, expansion_factor: int = 2, kernel_size: int = 31,
                 dropout: float = 0.0):
        super().__init__()
        inner = dim * expansion_factor
        pad = kernel_size // 2
        self.net = nn.Sequential(
            nn.LayerNorm(dim, eps=LN_EPS),
            Transpose(),
            nn.Conv1d(dim, inner * 2, 1),
            nn.GLU(dim=1),
            DepthWiseConv1d(inner, kernel_size, (pad, pad - (kernel_size + 1) % 2)),
            nn.BatchNorm1d(inner, eps=1e-5),
            Swish(),
            nn.Conv1d(inner, dim, 1),
            Transpose(),
            nn.Dropout(dropout),
        )

    def forward(self, x):
        return self.net(x)


class ConformerBlock(nn.Module):
    """Residuals around each sub-module, half-scaled feed-forwards, trailing
    LayerNorm (``conformer.py:189-220``)."""

    def __init__(self, dim: int, dim_head: int = 16, heads: int = 4, ff_mult: int = 4,
                 conv_expansion_factor: int = 2, conv_kernel_size: int = 31,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 conv_dropout: float = 0.0, fused_attention: bool = False):
        super().__init__()
        self.ff1 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult, ff_dropout)))
        self.attn = PreNorm(dim, ShawAttention(dim, heads, dim_head, attn_dropout,
                                               fused=fused_attention))
        self.conv = ConvModule(dim, conv_expansion_factor, conv_kernel_size,
                               conv_dropout)
        self.ff2 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult, ff_dropout)))
        self.post_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ff1(x) + x
        x = self.attn(x) + x
        x = self.conv(x) + x
        x = self.ff2(x) + x
        return self.post_norm(x)
