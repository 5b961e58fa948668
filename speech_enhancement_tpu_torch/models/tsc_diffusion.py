"""The diffusion TSCNet: the CMGAN backbone as a spectrogram-domain
conditional diffusion model (port of
speech_enhancement_tpu/models/tsc_diffusion.py).

Two dense encoders (the diffused input and the noisy conditioner), one
``MergeBlock`` shared by all four TSCBs (one set of weights, applied four
times, as the reference's single instance), then the CMGAN mask and
complex decoders.  NCHW inside, with H = time and W = frequency;
submodule names are the reference ``state_dict`` keys (``TSCB_1..4``,
``merge_block``), which ``convert_tsc_diffusion``
(``speech_enhancement_tpu/utils/convert_torch.py:328-352``) reads.
Attention stays on the plain path, as in the JAX package, and the TSCBs
keep their activations in training, as the JAX model does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from speech_enhancement_tpu_torch.models.diffuse import DiffusionEmbedding
from speech_enhancement_tpu_torch.models.generator import (
    TSCB,
    ComplexDecoder,
    DenseEncoder,
    MaskDecoder,
    split_spec,
)
from speech_enhancement_tpu_torch.models.layers import init_weights_
from speech_enhancement_tpu_torch.utils.device import resolve_device


class MergeBlock(nn.Module):
    """Diffusion-step bias and conditioner gating
    (``tsc_diffusion.py:28-49``): ``x + proj(emb(t))``, a 1x1 conv to 2C
    plus the conditioner's 1x1 conv to 2C, ``sigmoid(gate) * tanh(filter)``,
    a 1x1 conv back to C, and ``(x + residual) / sqrt(2)``."""

    def __init__(self, channels: int, num_steps: int):
        super().__init__()
        self.diffusion_embedding = DiffusionEmbedding(num_steps)
        self.diffusion_projection = nn.Linear(512, channels)
        self.merge_diffusion = nn.Conv2d(channels, 2 * channels, 1)
        self.conditioner_projection = nn.Conv2d(channels, 2 * channels, 1)
        self.output_residual = nn.Conv2d(channels, channels, 1)

    def forward(self, x, conditioner, diffusion_step):
        step = self.diffusion_projection(self.diffusion_embedding(diffusion_step))
        y = self.merge_diffusion(x + step[:, :, None, None].to(x.dtype))
        y = y + self.conditioner_projection(conditioner)
        gate, filt = torch.chunk(y, 2, dim=1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        return (x + self.output_residual(y)) / math.sqrt(2.0)


def _features(spec):
    """(input ``[B, 3, T, F]`` of magnitude, real and imaginary parts in
    the parts' dtype, fp32 magnitude, fp32 phase) of a complex
    spectrogram or an (re, im) pair."""
    re, im = split_spec(spec)
    ref, imf = re.float(), im.float()
    mag32 = torch.sqrt(ref * ref + imf * imf)
    return torch.stack([mag32.to(re.dtype), re, im], dim=1), mag32, torch.atan2(imf, ref)


class DiffusionTSCNet(nn.Module):
    """``forward(spec, noisy_spec, t)`` with complex ``[B, T, F]``
    spectrograms (or (re, im) pairs, so that it can run in bf16) returns
    ``(real, imag)``, each ``[B, T, F]`` fp32 (``tsc_diffusion.py:52-98``).
    Magnitudes and phase are computed in fp32 whatever the inputs' dtype.
    Weights are drawn from ``generator`` (seed 0 when None) on the CPU and
    moved to ``device`` (``cuda`` when None; ``'cpu'`` for the CPU)."""

    def __init__(self, num_channel: int = 64, num_features: int = 201, num_steps: int = 50,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dense_encoder = DenseEncoder(3, num_channel)
        self.dense_encoder_noisy = DenseEncoder(3, num_channel)
        self.merge_block = MergeBlock(num_channel, num_steps)
        self.TSCB_1 = TSCB(num_channel)
        self.TSCB_2 = TSCB(num_channel)
        self.TSCB_3 = TSCB(num_channel)
        self.TSCB_4 = TSCB(num_channel)
        self.mask_decoder = MaskDecoder(num_features, num_channel)
        self.complex_decoder = ComplexDecoder(num_channel)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights_(self, generator)
        self.to(resolve_device(device))

    def forward(self, spec, noisy_spec, diffusion_step):
        x_in, mag32, phase = _features(spec)
        noisy_in, _, _ = _features(noisy_spec)
        out = self.dense_encoder(x_in)
        out_noisy = self.dense_encoder_noisy(noisy_in)
        for tscb in (self.TSCB_1, self.TSCB_2, self.TSCB_3, self.TSCB_4):
            out = tscb(self.merge_block(out, out_noisy, diffusion_step))
        out_mag = self.mask_decoder(out).float() * mag32
        complex_out = self.complex_decoder(out).float()
        return (out_mag * torch.cos(phase) + complex_out[:, 0],
                out_mag * torch.sin(phase) + complex_out[:, 1])
