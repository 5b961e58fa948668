"""IEEE fp32 for the reference: full-precision CUDA matmuls and cuDNN
convolutions (not TF32) inside, the previous settings restored on exit.
Only the ``fp32_precision`` flags are read and written."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_fp32():
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    before = (matmul.fp32_precision, conv.fp32_precision)
    matmul.fp32_precision = conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision, conv.fp32_precision = before
