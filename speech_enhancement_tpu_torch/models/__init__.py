"""TSCNet (CMGAN generator), the metric discriminator, DiffuSE and the
diffusion TSCNet, and their building blocks, as NCHW / NCL
``nn.Module``s."""

from speech_enhancement_tpu_torch.models.conformer import ConformerBlock, ShawAttention
from speech_enhancement_tpu_torch.models.diffuse import (
    DiffuSE,
    DiffusionEmbedding,
    ResidualBlock,
    SpectrogramUpsampler,
)
from speech_enhancement_tpu_torch.models.discriminator import Discriminator
from speech_enhancement_tpu_torch.models.generator import TSCNet
from speech_enhancement_tpu_torch.models.tsc_diffusion import DiffusionTSCNet, MergeBlock

__all__ = ["ConformerBlock", "DiffuSE", "DiffusionEmbedding", "DiffusionTSCNet",
           "Discriminator", "MergeBlock", "ResidualBlock", "ShawAttention",
           "SpectrogramUpsampler", "TSCNet"]
