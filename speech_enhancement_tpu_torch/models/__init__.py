"""TSCNet (CMGAN generator), the metric discriminator and their building
blocks as NCHW ``nn.Module``s."""

from speech_enhancement_tpu_torch.models.conformer import ConformerBlock, ShawAttention
from speech_enhancement_tpu_torch.models.discriminator import Discriminator
from speech_enhancement_tpu_torch.models.generator import TSCNet

__all__ = ["ConformerBlock", "Discriminator", "ShawAttention", "TSCNet"]
