"""DSP and kernel wrappers.  Importing this package builds nothing: the
CUDA kernels are compiled by the first wrapper call on a CUDA tensor."""

from speech_enhancement_tpu_torch.ops.stft import (
    compressed_stft,
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
    "compressed_stft",
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
