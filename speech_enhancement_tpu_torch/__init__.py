"""speech_enhancement_tpu_torch — PyTorch/CUDA port of speech_enhancement_tpu.

The JAX package beside this one is the reference; this package holds the
same modules in PyTorch idiom and runs on an NVIDIA H100 through CUDA
kernels written by hand for Hopper (``csrc/``).  Public layouts follow the
JAX package so that the two can be compared tensor for tensor:
spectrograms are ``[B, T, F]``, attention operands ``[B, n, heads, d]``.

Layers (bottom-up):
  csrc/      CUDA C++ kernels (Shaw attention, STFT, iSTFT), built at first use
  ops/       STFT/iSTFT DSP, kernel wrappers with their plain PyTorch versions
  models/    TSCNet (CMGAN generator) as NCHW ``nn.Module``s
  utils/     JAX-parameter -> state_dict conversion (numpy only)
  enhance.py batched, length-bucketed enhancement serving

Importing the package touches no CUDA: kernels are compiled and loaded
by the first wrapper call that receives a CUDA tensor.
"""

__version__ = "0.1.0"
