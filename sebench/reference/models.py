"""Plain CMGAN generator (TSCNet) and metric discriminator.

Follows the published CMGAN (Cao et al., Interspeech 2022;
github.com/ruizhecao96/CMGAN, ``src/models/generator.py``,
``conformer.py``, ``discriminator.py``) in NCHW with the published module
names, so that a ``state_dict`` of either side loads into the other.  No
kernels, no fused paths, no int8, no process groups.  Departures from the
published code, which the system under test shares: LayerNorm eps 1e-6;
BatchNorm with batch statistics and the biased variance in training;
spectral norm reading a stored (u, v) pair that :meth:`Discriminator.refresh_`
steps once after each update.

Dropout is drawn in the published order (per conformer: feed-forward 1,
attention output, conv module, feed-forward 2; then the discriminator's
MLP), so that under one seed the same masks come out as on any other
implementation that draws in that order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6


class PReLU(nn.Module):
    def __init__(self, num_parameters: int = 1, init: float = 0.25, dim: int = 1):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.full((num_parameters,), init))

    def forward(self, x):
        shape = [1] * x.ndim
        shape[self.dim] = -1
        return torch.where(x >= 0, x, self.weight.view(shape) * x)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True), eps 1e-5, biased variance."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class BatchNorm1d(nn.BatchNorm1d):
    """Training: batch statistics with the biased variance (running
    statistics are not compared and not kept); eval: running statistics."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        var, mean = torch.var_mean(x, dim=(0, 2), correction=0)
        y = (x - mean[:, None]) * torch.rsqrt(var + self.eps)[:, None]
        return y * self.weight[:, None] + self.bias[:, None]


class Swish(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(x)


class Scale(nn.Module):
    def __init__(self, scale: float, fn: nn.Module):
        super().__init__()
        self.scale, self.fn = scale, fn

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
    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, dim * mult), Swish(), nn.Dropout(dropout),
                                 nn.Linear(dim * mult, dim), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


def relative_index(n: int, max_pos: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, device=device)
    return (pos[:, None] - pos[None, :]).clamp(-max_pos, max_pos) + max_pos


class Attention(nn.Module):
    """Multi-head self-attention with Shaw relative positions."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 16, dropout: float = 0.0,
                 max_pos_emb: int = 512):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim_head ** -0.5
        self.max_pos_emb = max_pos_emb
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.rel_pos_emb = nn.Embedding(2 * max_pos_emb + 1, dim_head)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        if torch.is_grad_enabled() or x.shape[0] <= 1:
            return self._forward(x)
        # without autograd, in chunks of sequences whose attention maps
        # stay near 2^28 elements
        chunk = max(1, (1 << 28) // (self.heads * x.shape[1] * x.shape[1]))
        return torch.cat([self._forward(part) for part in x.split(chunk)])

    def _forward(self, x):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x).view(b, n, h, d).transpose(1, 2)
        k, v = (t.view(b, n, h, d).transpose(1, 2) for t in self.to_kv(x).chunk(2, dim=-1))
        dots = torch.einsum("bhid,bhjd->bhij", q, k) * self.scale
        rel = self.rel_pos_emb.weight[relative_index(n, self.max_pos_emb, x.device)]
        pos = torch.einsum("bhid,ijd->bhij", q, rel) * self.scale
        attn = torch.softmax(dots + pos, dim=-1)
        out = torch.einsum("bhij,bhjd->bhid", attn, v).transpose(1, 2).reshape(b, n, h * d)
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
        return self.conv(F.pad(x, self.padding))


class ConvModule(nn.Module):
    def __init__(self, dim: int, expansion_factor: int = 2, kernel_size: int = 31,
                 dropout: float = 0.0):
        super().__init__()
        inner = dim * expansion_factor
        pad = kernel_size // 2
        self.net = nn.Sequential(
            nn.LayerNorm(dim, eps=LN_EPS), Transpose(), nn.Conv1d(dim, inner * 2, 1),
            nn.GLU(dim=1), DepthWiseConv1d(inner, kernel_size, (pad, pad - (kernel_size + 1) % 2)),
            BatchNorm1d(inner, eps=1e-5), Swish(), nn.Conv1d(inner, dim, 1), Transpose(),
            nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, dim_head: int = 16, heads: int = 4, ff_mult: int = 4,
                 conv_expansion_factor: int = 2, conv_kernel_size: int = 31,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0, conv_dropout: float = 0.0):
        super().__init__()
        self.ff1 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult, ff_dropout)))
        self.attn = PreNorm(dim, Attention(dim, heads, dim_head, attn_dropout))
        self.conv = ConvModule(dim, conv_expansion_factor, conv_kernel_size, conv_dropout)
        self.ff2 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult, ff_dropout)))
        self.post_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        x = self.ff1(x) + x
        x = self.attn(x) + x
        x = self.conv(x) + x
        x = self.ff2(x) + x
        return self.post_norm(x)


class DilatedDenseNet(nn.Module):
    def __init__(self, depth: int = 4, channels: int = 64):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(channels * (i + 1), channels, (2, 3), dilation=(2 ** i, 1)))
            setattr(self, f"norm{i + 1}", InstanceNorm(channels))
            setattr(self, f"prelu{i + 1}", PReLU(channels))

    def forward(self, x):
        skip = out = x
        for i in range(self.depth):
            y = getattr(self, f"conv{i + 1}")(F.pad(skip, (1, 1, 2 ** i, 0)))
            out = getattr(self, f"prelu{i + 1}")(getattr(self, f"norm{i + 1}")(y))
            skip = torch.cat([out, skip], dim=1)
        return out


class DenseEncoder(nn.Module):
    def __init__(self, in_channel: int = 3, channels: int = 64):
        super().__init__()
        self.conv_1 = nn.Sequential(nn.Conv2d(in_channel, channels, (1, 1)),
                                    InstanceNorm(channels), PReLU(channels))
        self.dilated_dense = DilatedDenseNet(4, channels)
        self.conv_2 = nn.Sequential(nn.Conv2d(channels, channels, (1, 3), (1, 2), (0, 1)),
                                    InstanceNorm(channels), PReLU(channels))

    def forward(self, x):
        return self.conv_2(self.dilated_dense(self.conv_1(x)))


class TSCB(nn.Module):
    def __init__(self, channels: int = 64, dropout: float = 0.2):
        super().__init__()
        kw = dict(dim=channels, dim_head=channels // 4, heads=4, attn_dropout=dropout,
                  ff_dropout=dropout)
        self.time_conformer = ConformerBlock(**kw)
        self.freq_conformer = ConformerBlock(**kw)

    def forward(self, x):
        b, c, t, f = x.shape
        x_t = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
        x_t = self.time_conformer(x_t) + x_t
        x_f = x_t.view(b, f, t, c).permute(0, 2, 1, 3).reshape(b * t, f, c)
        x_f = self.freq_conformer(x_f) + x_f
        return x_f.view(b, t, f, c).permute(0, 3, 1, 2)


class SPConvTranspose2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size, r: int = 1):
        super().__init__()
        self.r = r
        self.conv = nn.Conv2d(in_channels, out_channels * r, kernel_size)

    def forward(self, x):
        y = self.conv(F.pad(x, (1, 1, 0, 0)))
        b, nch, t, f = y.shape
        y = y.view(b, self.r, nch // self.r, t, f).permute(0, 2, 3, 4, 1)
        return y.reshape(b, nch // self.r, t, f * self.r)


class MaskDecoder(nn.Module):
    def __init__(self, num_features: int = 201, channels: int = 64):
        super().__init__()
        self.dense_block = DilatedDenseNet(4, channels)
        self.sub_pixel = SPConvTranspose2d(channels, channels, (1, 3), 2)
        self.conv_1 = nn.Conv2d(channels, 1, (1, 2))
        self.norm = InstanceNorm(1)
        self.prelu = PReLU(1)
        self.final_conv = nn.Conv2d(1, 1, (1, 1))
        self.prelu_out = PReLU(num_features, init=-0.25, dim=-1)

    def forward(self, x):
        x = self.sub_pixel(self.dense_block(x))
        x = self.final_conv(self.prelu(self.norm(self.conv_1(x))))
        return self.prelu_out(x[:, 0])


class ComplexDecoder(nn.Module):
    def __init__(self, channels: int = 64):
        super().__init__()
        self.dense_block = DilatedDenseNet(4, channels)
        self.sub_pixel = SPConvTranspose2d(channels, channels, (1, 3), 2)
        self.prelu = PReLU(channels)
        self.norm = InstanceNorm(channels)
        self.conv = nn.Conv2d(channels, 2, (1, 2))

    def forward(self, x):
        x = self.sub_pixel(self.dense_block(x))
        return self.conv(self.prelu(self.norm(x)))


class TSCNet(nn.Module):
    """``forward(re, im)`` on ``[B, T, F]`` compressed spectra returns the
    enhanced ``(re, im)``.  ``checkpointed=True`` recomputes each TSCB in
    the backward (plain ``torch.utils.checkpoint``, which replays the
    forward's dropout masks): the same gradients in less memory."""

    def __init__(self, num_channel: int = 64, num_features: int = 201,
                 checkpointed: bool = False):
        super().__init__()
        self.checkpointed = checkpointed
        self.dense_encoder = DenseEncoder(3, num_channel)
        self.TSCB_1 = TSCB(num_channel)
        self.TSCB_2 = TSCB(num_channel)
        self.TSCB_3 = TSCB(num_channel)
        self.TSCB_4 = TSCB(num_channel)
        self.mask_decoder = MaskDecoder(num_features, num_channel)
        self.complex_decoder = ComplexDecoder(num_channel)

    def forward(self, re, im):
        mag = torch.sqrt(re * re + im * im)
        phase = torch.atan2(im, re)
        out = self.dense_encoder(torch.stack([mag, re, im], dim=1))
        for tscb in (self.TSCB_1, self.TSCB_2, self.TSCB_3, self.TSCB_4):
            if self.checkpointed and self.training and torch.is_grad_enabled():
                out = checkpoint(tscb, out, use_reentrant=False)
            else:
                out = tscb(out)
        out_mag = self.mask_decoder(out) * mag
        complex_out = self.complex_decoder(out)
        return (out_mag * torch.cos(phase) + complex_out[:, 0],
                out_mag * torch.sin(phase) + complex_out[:, 1])


class SpectralNorm(nn.Module):
    """sigma = u . (W v) from the stored pair; :meth:`refresh_` is one
    power-iteration step."""

    def _flat(self):
        return self.weight_orig.reshape(self.weight_orig.shape[0], -1)

    def normalized_weight(self):
        return self.weight_orig / torch.dot(self.weight_u, self._flat() @ self.weight_v)

    @torch.no_grad()
    def refresh_(self):
        w = self._flat()
        v = w.t() @ self.weight_u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = w @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        self.weight_u.copy_(u)
        self.weight_v.copy_(v)


class SpectralNormConv2d(SpectralNorm):
    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int, padding: int):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_orig = nn.Parameter(torch.empty(cout, cin, kernel_size, kernel_size))
        self.register_buffer("weight_u", torch.empty(cout))
        self.register_buffer("weight_v", torch.empty(cin * kernel_size * kernel_size))

    def forward(self, x):
        return F.conv2d(x, self.normalized_weight(), stride=self.stride, padding=self.padding)


class SpectralNormLinear(SpectralNorm):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight_orig = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.full((cout,), 0.01))
        self.register_buffer("weight_u", torch.empty(cout))
        self.register_buffer("weight_v", torch.empty(cin))

    def forward(self, x):
        return F.linear(x, self.normalized_weight(), self.bias)


class LearnableSigmoid(nn.Module):
    def __init__(self, in_features: int = 1, beta: float = 1.0):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(in_features))

    def forward(self, x):
        return self.beta * torch.sigmoid(self.slope * x)


class Discriminator(nn.Module):
    """``forward(x, y)`` on magnitude spectra ``[B, T, F]`` -> ``[B, 1]``."""

    def __init__(self, ndf: int = 16, dropout: float = 0.3):
        super().__init__()
        widths = [2, ndf, ndf * 2, ndf * 4, ndf * 8]
        layers: list[nn.Module] = []
        for cin, cout in zip(widths[:-1], widths[1:]):
            layers += [SpectralNormConv2d(cin, cout, 4, 2, 1), InstanceNorm(cout), PReLU(cout)]
        layers += [nn.AdaptiveMaxPool2d(1), nn.Flatten(), SpectralNormLinear(ndf * 8, ndf * 4),
                   nn.Dropout(dropout), PReLU(ndf * 4), SpectralNormLinear(ndf * 4, 1),
                   LearnableSigmoid(1)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x, y):
        return self.layers(torch.stack([x, y], dim=1))

    @torch.no_grad()
    def refresh_(self):
        for m in self.modules():
            if isinstance(m, SpectralNorm):
                m.refresh_()
