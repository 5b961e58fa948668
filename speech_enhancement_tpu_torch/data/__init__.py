"""Host data: wav IO and the VoiceBank dataset, collator and loader."""

from speech_enhancement_tpu_torch.data.audio_io import load_wav, save_wav
from speech_enhancement_tpu_torch.data.voicebank import (
    Batch,
    Collator,
    DataLoader,
    VoicebankDataset,
)

__all__ = ["Batch", "Collator", "DataLoader", "VoicebankDataset", "load_wav", "save_wav"]
