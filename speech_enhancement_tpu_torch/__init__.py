"""speech_enhancement_tpu_torch — PyTorch/CUDA port of speech_enhancement_tpu.

The JAX package beside this one is the reference; this package holds the
same modules in PyTorch idiom and runs on an NVIDIA H100 through CUDA
kernels written by hand for Hopper (``csrc/``).  Public layouts follow the
JAX package so that the two can be compared tensor for tensor:
spectrograms are ``[B, T, F]``, attention operands ``[B, n, heads, d]``.

Layers (bottom-up):
  csrc/      CUDA C++ kernels (Shaw attention forward and backward, STFT,
             iSTFT, axis swap) and the C++ PESQ engine, built at first use
  ops/       STFT/iSTFT DSP, kernel wrappers with their plain PyTorch versions
  metrics/   PESQ (the native engine's ctypes binding) and the composite
             evaluation metrics (CSIG, CBAK, COVL, SSNR, STOI)
  models/    TSCNet (CMGAN generator), the metric discriminator, DiffuSE and
             the diffusion TSCNet as NCHW / NCL ``nn.Module``s
  train/     criteria, optimizers, train states, GAN steps (SCP-GAN/CMGAN)
             and the training epoch with its step modes; the diffusion
             forward process, reverse schedule, train steps and samplers,
             and the standalone CDiffuSE learner
  data/      wav IO, the VoiceBank dataset, collator and threaded loader,
             the CDiffuSE spectrogram dataset and its preprocessing
  config/    the configuration tree and its overlays (read without PyYAML)
  utils/     checkpoints, logging, profiling, the preemption guard, JAX-variable ->
             state_dict conversion (numpy only), device selection
  enhance.py batched, length-bucketed enhancement serving
  cli/       the entry points: main_gan, inference_gan, main_diffuse,
             inference_diffuse, preprocess, cdiffuse, cdiffuse_inference
             and convert_checkpoint

Importing the package touches no CUDA: kernels are compiled and loaded
by the first wrapper call that receives a CUDA tensor.  Entry points run
on ``cuda`` unless given ``device="cpu"`` (the CLIs: ``--device cpu``).  Nothing of the JAX package
is imported.
"""

__version__ = "0.1.0"
