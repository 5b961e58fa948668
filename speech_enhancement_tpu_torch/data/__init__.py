"""Host data: wav IO, the VoiceBank dataset, collator and loader, the
CDiffuSE spectrogram dataset and its preprocessing (``preprocess.py``)."""

from speech_enhancement_tpu_torch.data.audio_io import load_wav, save_wav
from speech_enhancement_tpu_torch.data.numpy_dataset import (
    NumpyDataset,
    SpecBatch,
    SpecCollator,
    from_path,
)
from speech_enhancement_tpu_torch.data.voicebank import (
    Batch,
    Collator,
    DataLoader,
    VoicebankDataset,
)

__all__ = ["Batch", "Collator", "DataLoader", "NumpyDataset", "SpecBatch", "SpecCollator",
           "VoicebankDataset", "from_path", "load_wav", "save_wav"]
