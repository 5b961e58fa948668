"""DiffuSE, the conditional waveform diffusion model (port of
speech_enhancement_tpu/models/diffuse.py).

NCL inside, as the reference torch model: waveforms ``[B, C, L]``.  The
public interface keeps the JAX one: ``DiffuSE(audio [B, L], spectrogram
[B, T, F], t [B]) -> [B, L]``.  Submodule names are the reference
``state_dict`` keys (``residual_layers.{i}``, ``dilated_conv.0/.1`` and
``output_projection.0/.1`` with GroupNorm), which
``speech_enhancement_tpu/utils/convert_torch.py::convert_diffuse`` reads,
so that a reference checkpoint loads with ``load_state_dict(strict=True)``.

In training (``model.train()`` with autograd on) every residual block is
recomputed in the backward instead of kept, as the JAX package's
``nn.remat`` does; the blocks hold no BatchNorm, so the recompute is
exact.  Under a bf16 copy of the weights (``torch.func.functional_call``,
as ``train/diffusion.py`` runs it) the blocks run in bf16: the embedding
table is read in fp32 and cast to the weights' dtype.  (The JAX package's
flax promotion instead carries the fp32 embedding into every block, which
then computes in fp32 on bf16-rounded weights.)
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_tpu_torch.models.layers import init_weights_, rematerialized, swish
from speech_enhancement_tpu_torch.utils.device import resolve_device


def build_embedding_table(max_steps: int) -> np.ndarray:
    """Sin/cos table ``[max_steps, 128]`` of ``t * 10^(d * 4 / 63)`` for
    ``d < 64`` (``diffuse.py:28-45``).  The product stays in float32, as
    the reference computes it, and the factor is computed in float64 and
    rounded once: at a phase of about 5e5 rad one float32 ulp of either
    moves ``sin`` by about 0.05."""
    steps = np.arange(max_steps, dtype=np.float32)[:, None]
    dims = np.arange(64, dtype=np.float32)[None, :]
    expo = (dims * np.float32(4.0) / np.float32(63.0)).astype(np.float64)
    factor = (np.float64(10.0) ** expo).astype(np.float32)
    table = steps * factor
    return np.concatenate([np.sin(table), np.cos(table)], axis=1).astype(np.float32)


class DiffusionEmbedding(nn.Module):
    """The 128-wide sin/cos timestep embedding, then two SiLU Linears to
    ``proj_dim`` (``diffuse.py:48-75``).  A fractional ``t`` lerps between
    the table rows of ``floor t`` and ``ceil t``.  The table is a
    non-persistent buffer, as in the reference: no ``state_dict`` key."""

    def __init__(self, max_steps: int, proj_dim: int = 512):
        super().__init__()
        self.register_buffer("embedding", torch.from_numpy(build_embedding_table(max_steps)),
                             persistent=False)
        self.projection1 = nn.Linear(128, proj_dim)
        self.projection2 = nn.Linear(proj_dim, proj_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        table = self.embedding
        if not t.is_floating_point():
            x = table[t]
        else:
            low, high = torch.floor(t).long(), torch.ceil(t).long()
            frac = (t - low.to(t.dtype))[..., None]
            x = table[low] + (table[high] - table[low]) * frac
        x = swish(self.projection1(x.to(self.projection1.weight.dtype)))
        return swish(self.projection2(x))


class SpectrogramUpsampler(nn.Module):
    """Two ``ConvTranspose2d(1, 1, [3, 2L], stride [1, L], padding [1,
    L // 2])`` over ``[B, 1, F, T]``, each followed by ``leaky_relu(0.4)``,
    stretching the frames by ``L = sqrt(hop)`` each (``diffuse.py:78-112``):
    ``[B, T, F] -> [B, F, T * hop]``.  The JAX kernel is this one
    transposed and flipped on both axes (``utils/convert_torch.py:249-261``)."""

    def __init__(self, hop_length: int = 100):
        super().__init__()
        root = math.isqrt(hop_length)
        if root * root != hop_length:
            raise ValueError(f"hop_length must be a perfect square, got {hop_length}")
        self.conv1 = nn.ConvTranspose2d(1, 1, [3, 2 * root], stride=[1, root],
                                        padding=[1, root // 2])
        self.conv2 = nn.ConvTranspose2d(1, 1, [3, 2 * root], stride=[1, root],
                                        padding=[1, root // 2])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.transpose(1, 2)[:, None]  # [B, 1, F, T]
        y = F.leaky_relu(self.conv1(y), 0.4)
        y = F.leaky_relu(self.conv2(y), 0.4)
        return y[:, 0]


class ResidualBlock(nn.Module):
    """The gated residual block (``diffuse.py:115-157``): the step
    projection added, the dilated conv (GroupNorm of ``2c // 16`` groups
    after it with ``use_groupnorm``), the conditioner projection added,
    ``sigmoid(gate) * tanh(filter)``, then the residual and the skip convs
    (GroupNorm of ``c // 16`` groups after the skip).  Returns ``((x +
    residual) / sqrt(2), skip)``."""

    def __init__(self, n_specs: int, residual_channels: int, dilation: int,
                 use_groupnorm: bool = True):
        super().__init__()
        c = residual_channels
        dilated = nn.Conv1d(c, 2 * c, 3, padding=dilation, dilation=dilation)
        skip = nn.Conv1d(c, c, 1)
        if use_groupnorm:
            self.dilated_conv = nn.Sequential(dilated, nn.GroupNorm((2 * c) // 16, 2 * c, 1e-5))
            self.output_projection = nn.Sequential(skip, nn.GroupNorm(c // 16, c, 1e-5))
        else:
            self.dilated_conv, self.output_projection = dilated, skip
        self.diffusion_projection = nn.Linear(512, c)
        self.conditioner_projection = nn.Conv1d(n_specs, 2 * c, 1)
        self.output_residual = nn.Conv1d(c, c, 1)

    def forward(self, x, conditioner, diffusion_step):
        step = self.diffusion_projection(diffusion_step)[:, :, None]
        y = self.dilated_conv(x + step) + self.conditioner_projection(conditioner)
        gate, filt = torch.chunk(y, 2, dim=1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        return (x + self.output_residual(y)) / math.sqrt(2.0), self.output_projection(y)


class DiffuSE(nn.Module):
    """Waveform diffusion model (``diffuse.py:160-221``): input conv, then
    ``residual_layers`` gated blocks with dilation ``2^(i mod cycle)``
    conditioned on the upsampled spectrogram (cut to the audio's length)
    and the timestep embedding, the skip sum over ``sqrt(layers)``, and a
    zero-initialized output conv predicting the combined noise.

    ``forward(audio [B, L], spectrogram [B, T, F], t [B]) -> [B, L]``.
    Weights are drawn from ``generator`` (seed 0 when None) on the CPU and
    moved to ``device`` (``cuda`` when None; ``'cpu'`` for the CPU)."""

    def __init__(self, dilation_cycle_length: int = 10, hop_length: int = 100,
                 n_specs: int = 201, num_steps: int = 50, residual_channels: int = 64,
                 residual_layers: int = 30, use_groupnorm: bool = True, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.remat = True
        self.hop_length, self.n_specs = hop_length, n_specs
        c = residual_channels
        self.input_projection = nn.Conv1d(1, c, 1)
        self.diffusion_embedding = DiffusionEmbedding(num_steps)
        self.spectrogram_upsampler = SpectrogramUpsampler(hop_length)
        self.residual_layers = nn.ModuleList(
            ResidualBlock(n_specs, c, 2 ** (i % dilation_cycle_length), use_groupnorm)
            for i in range(residual_layers))
        self.skip_projection = nn.Conv1d(c, c, 1)
        self.output_projection = nn.Conv1d(c, 1, 1)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights_(self, generator)
        with torch.no_grad():
            for conv in (self.spectrogram_upsampler.conv1, self.spectrogram_upsampler.conv2):
                bound = 1.0 / math.sqrt(conv.weight[0].numel())
                conv.weight.uniform_(-bound, bound, generator=generator)
                conv.bias.zero_()
            self.output_projection.weight.zero_()
            self.output_projection.bias.zero_()
        self.to(resolve_device(device))

    def forward(self, audio, spectrogram, diffusion_step):
        x = F.relu(self.input_projection(audio[:, None]))
        step = self.diffusion_embedding(diffusion_step)
        cond = self.spectrogram_upsampler(spectrogram)[:, :, :x.shape[-1]]
        remat = self.remat and self.training and torch.is_grad_enabled()
        skip_sum = torch.zeros_like(x)
        for block in self.residual_layers:
            x, skip = (rematerialized(block, x, cond, step) if remat
                       else block(x, cond, step))
            skip_sum = skip_sum + skip
        x = F.relu(self.skip_projection(skip_sum / math.sqrt(len(self.residual_layers))))
        return self.output_projection(x)[:, 0]
