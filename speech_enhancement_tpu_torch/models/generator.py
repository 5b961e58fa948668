"""TSCNet, the CMGAN generator (port of speech_enhancement_tpu/models/generator.py).

NCHW inside, with H = time and W = frequency, as the reference torch
model; the public interface keeps the JAX layout: ``TSCNet`` takes a
complex ``[B, T, F]`` spectrogram (or an (re, im) pair, so that it can run
in bf16) and returns ``(real, imag)``, each ``[B, T, F]`` fp32.  Submodule
names are the reference ``state_dict`` keys ``export_tscnet`` writes, so
``load_state_dict(strict=True)`` takes its output.

In training (``model.train()`` with autograd on) each TSCB is
rematerialized, as the JAX package's ``tscb_stack`` always does: its
activations are recomputed in the backward instead of kept.

Under a profiler session (``utils.profiling``) the encoder, each TSCB's
time and frequency conformers and the two decoders are spans
``se.model.encoder``, ``se.model.tscb.time``, ``se.model.tscb.freq`` and
``se.model.decoders`` (a recompute in the backward spans again, on the
autograd engine's thread).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_tpu_torch.models.conformer import ConformerBlock
from speech_enhancement_tpu_torch.models.layers import (
    InstanceNorm,
    PReLU,
    init_weights_,
    rematerialized,
)
from speech_enhancement_tpu_torch.ops.fused_relayout import swap_seq_axes
from speech_enhancement_tpu_torch.ops.int8 import QuantConv2d
from speech_enhancement_tpu_torch.utils.device import resolve_device
from speech_enhancement_tpu_torch.utils.profiling import span


def conv2d(quantized: bool, *args, **kwargs) -> nn.Conv2d:
    """``nn.Conv2d``, or with ``quantized`` its int8 serving twin
    :class:`~speech_enhancement_tpu_torch.ops.int8.QuantConv2d` (the same
    parameters)."""
    return (QuantConv2d if quantized else nn.Conv2d)(*args, **kwargs)


class DilatedDenseNet(nn.Module):
    """Four densely connected (2, 3) convs, time-dilated 2^i with causal
    time padding (pad ``dil`` frames before, none after) and (1, 1) on
    frequency (``generator.py:49-80``).  ``quantized``: the four convs
    contract in int8 (``ops/int8.py``)."""

    def __init__(self, depth: int = 4, channels: int = 64, quantized: bool = False):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"conv{i + 1}",
                    conv2d(quantized, channels * (i + 1), channels, (2, 3),
                           dilation=(2 ** i, 1)))
            setattr(self, f"norm{i + 1}", InstanceNorm(channels))
            setattr(self, f"prelu{i + 1}", PReLU(channels))

    def forward(self, x):
        skip = x
        out = x
        for i in range(self.depth):
            dil = 2 ** i
            y = F.pad(skip, (1, 1, dil, 0))
            y = getattr(self, f"conv{i + 1}")(y)
            out = getattr(self, f"prelu{i + 1}")(getattr(self, f"norm{i + 1}")(y))
            skip = torch.cat([out, skip], dim=1)
        return out


class DenseEncoder(nn.Module):
    """1x1 conv -> DilatedDenseNet -> (1, 3) conv with stride (1, 2) that
    halves F (``generator.py:83-106``).  ``quantized``: the dense block
    and the strided conv in int8; the 1x1 conv (Cin 3) stays float."""

    def __init__(self, in_channel: int = 3, channels: int = 64, quantized: bool = False):
        super().__init__()
        self.conv_1 = nn.Sequential(nn.Conv2d(in_channel, channels, (1, 1)),
                                    InstanceNorm(channels), PReLU(channels))
        self.dilated_dense = DilatedDenseNet(4, channels, quantized)
        self.conv_2 = nn.Sequential(conv2d(quantized, channels, channels, (1, 3), (1, 2),
                                           (0, 1)),
                                    InstanceNorm(channels), PReLU(channels))

    def forward(self, x):
        return self.conv_2(self.dilated_dense(self.conv_1(x)))


class TSCB(nn.Module):
    """Time conformer over ``[B*F, T, C]``, then freq conformer over
    ``[B*T, F, C]``, with a residual outside each (``generator.py:109-156``).
    Only the time conformer takes ``fused_attention``; the freq conformer
    stays eager, as in the JAX package.  Each conformer adds the outer
    residual itself (``skip``), after its post-norm.

    ``fused_relayout=True`` runs the fold between the two conformers,
    ``[B, F, T, C] -> [B, T, F, C]``, through the K6 swap kernel
    (``ops/fused_relayout.py``), as the JAX package's flag does.  The
    first fold stays a torch permute: it also moves C from NCHW's axis 1
    to the minor axis, a fold the channels-last JAX package never has;
    the last one, back to NCHW, likewise."""

    def __init__(self, channels: int = 64, dropout: float = 0.2,
                 fused_attention: bool = False, fused_relayout: bool = False):
        super().__init__()
        kw = dict(dim=channels, dim_head=channels // 4, heads=4,
                  attn_dropout=dropout, ff_dropout=dropout)
        self.fused_relayout = fused_relayout
        self.time_conformer = ConformerBlock(**kw, fused_attention=fused_attention)
        self.freq_conformer = ConformerBlock(**kw)

    def forward(self, x):
        b, c, t, f = x.shape
        with span("se.model.tscb.time"):
            x_t = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
            x_t = self.time_conformer(x_t, skip=x_t)
        with span("se.model.tscb.freq"):
            if self.fused_relayout:
                x_f = swap_seq_axes(x_t.view(b, f, t, c)).view(b * t, f, c)
            else:
                x_f = x_t.view(b, f, t, c).permute(0, 2, 1, 3).reshape(b * t, f, c)
            x_f = self.freq_conformer(x_f, skip=x_f)
            return x_f.view(b, t, f, c).permute(0, 3, 1, 2)


class SPConvTranspose2d(nn.Module):
    """Sub-pixel upsampler along F: conv to r * out channels, then the r
    channel blocks interleave F-major (``generator.py:208-227``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, r: int = 1,
                 quantized: bool = False):
        super().__init__()
        self.r = r
        self.conv = conv2d(quantized, in_channels, out_channels * r, kernel_size)

    def forward(self, x):
        y = self.conv(F.pad(x, (1, 1, 0, 0)))
        b, nch, t, f = y.shape
        y = y.view(b, self.r, nch // self.r, t, f).permute(0, 2, 3, 4, 1)
        return y.reshape(b, nch // self.r, t, f * self.r)


class MaskDecoder(nn.Module):
    """Dense block -> sub-pixel x2 -> conv to 1 channel -> norm / PReLU ->
    1x1 conv -> per-frequency PReLU(init -0.25) mask ``[B, T, F]``
    (``generator.py:230-251``).  ``quantized``: the dense block and the
    sub-pixel conv in int8; the two 1-channel output convs stay float."""

    def __init__(self, num_features: int = 201, channels: int = 64, quantized: bool = False):
        super().__init__()
        self.dense_block = DilatedDenseNet(4, channels, quantized)
        self.sub_pixel = SPConvTranspose2d(channels, channels, (1, 3), 2, quantized)
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
    """Dense block -> sub-pixel x2 -> norm / PReLU -> conv to (re, im)
    ``[B, 2, T, F]`` (``generator.py:254-269``).  ``quantized``: the dense
    block and the sub-pixel conv in int8; the 2-channel output conv stays
    float."""

    def __init__(self, channels: int = 64, quantized: bool = False):
        super().__init__()
        self.dense_block = DilatedDenseNet(4, channels, quantized)
        self.sub_pixel = SPConvTranspose2d(channels, channels, (1, 3), 2, quantized)
        self.prelu = PReLU(channels)
        self.norm = InstanceNorm(channels)
        self.conv = nn.Conv2d(channels, 2, (1, 2))

    def forward(self, x):
        x = self.sub_pixel(self.dense_block(x))
        return self.conv(self.prelu(self.norm(x)))


def split_spec(spec):
    """A complex spectrogram or an (re, im) pair -> (re, im)."""
    if isinstance(spec, (tuple, list)):
        return spec
    return spec.real, spec.imag


class TSCNet(nn.Module):
    """CMGAN generator (``generator.py:283-325``).

    ``forward(spec)`` with complex ``spec [B, T, F]`` (or an (re, im) pair)
    returns ``(real, imag)``, each ``[B, T, F]`` fp32: the masked magnitude
    recombined with the noisy phase, plus the complex decoder's residual.
    Weights are drawn from ``generator`` (seed 0 when None) on the CPU and
    then moved to ``device`` (``cuda`` when None; pass ``'cpu'`` for the
    CPU).  ``remat=False`` keeps the TSCB activations
    in training instead of recomputing them (more memory, same result).

    ``quantized_convs=True`` runs the JAX package's 15 convs in int8
    (``ops/int8.py``, a serving path without gradients): the encoder's
    dense block and strided conv, and each decoder's dense block and
    sub-pixel conv.  The encoder's 1x1 input conv and the decoders' 1- and
    2-channel output convs stay float.  The parameters, their names and
    their initial values are the float model's.
    """

    def __init__(self, num_channel: int = 64, num_features: int = 201,
                 fused_attention: bool = False, fused_relayout: bool = False,
                 remat: bool = True, quantized_convs: bool = False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.remat = remat
        self.dense_encoder = DenseEncoder(3, num_channel, quantized_convs)
        # the four blocks keep the reference's attribute names TSCB_1..4,
        # which are their state_dict keys
        kw = dict(fused_attention=fused_attention, fused_relayout=fused_relayout)
        self.TSCB_1 = TSCB(num_channel, **kw)
        self.TSCB_2 = TSCB(num_channel, **kw)
        self.TSCB_3 = TSCB(num_channel, **kw)
        self.TSCB_4 = TSCB(num_channel, **kw)
        self.mask_decoder = MaskDecoder(num_features, num_channel, quantized_convs)
        self.complex_decoder = ComplexDecoder(num_channel, quantized_convs)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights_(self, generator)
        self.to(resolve_device(device))

    def forward(self, spec):
        with span("se.model.encoder"):
            re, im = split_spec(spec)
            # magnitude and phase in fp32 even under a bf16 compute dtype:
            # the phase recombination at the output is precision-critical
            ref, imf = re.float(), im.float()
            mag32 = torch.sqrt(ref * ref + imf * imf)
            phase = torch.atan2(imf, ref)
            x_in = torch.stack([mag32.to(re.dtype), re, im], dim=1)  # [B, 3, T, F]
            out = self.dense_encoder(x_in)

        remat = self.remat and self.training and torch.is_grad_enabled()
        for tscb in (self.TSCB_1, self.TSCB_2, self.TSCB_3, self.TSCB_4):
            out = rematerialized(tscb, out) if remat else tscb(out)

        with span("se.model.decoders"):
            out_mag = self.mask_decoder(out).float() * mag32
            complex_out = self.complex_decoder(out).float()
            return (out_mag * torch.cos(phase) + complex_out[:, 0],
                    out_mag * torch.sin(phase) + complex_out[:, 1])
