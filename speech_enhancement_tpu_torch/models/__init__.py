"""TSCNet (CMGAN generator) and its building blocks as NCHW ``nn.Module``s."""

from speech_enhancement_tpu_torch.models.conformer import ConformerBlock, ShawAttention
from speech_enhancement_tpu_torch.models.generator import TSCNet

__all__ = ["ConformerBlock", "ShawAttention", "TSCNet"]
