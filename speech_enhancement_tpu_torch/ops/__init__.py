"""DSP and kernel wrappers.  Importing this package builds nothing: the
CUDA kernels are compiled by the first wrapper call on a CUDA tensor."""

from speech_enhancement_tpu_torch.ops.stft import (
    batch_stft,
    compressed_stft,
    disassemble_spectrogram,
    frame_signal,
    hamming_window,
    istft,
    normalize_batch,
    overlap_add,
    power_compress,
    power_uncompress,
    stft,
    uncompressed_istft,
)

__all__ = [
    "batch_stft",
    "compressed_stft",
    "disassemble_spectrogram",
    "frame_signal",
    "hamming_window",
    "istft",
    "normalize_batch",
    "overlap_add",
    "power_compress",
    "power_uncompress",
    "stft",
    "uncompressed_istft",
]
