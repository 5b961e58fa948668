"""Benchmark of speech_enhancement_tpu_torch on NVIDIA GPUs (see README.md)."""
