"""The port imports nothing of JAX, flax, optax, yaml, the JAX package or
the repository's ``scripts/``, and needs no CUDA toolchain to import.

The machine with the card has no JAX, flax or yaml, and the port keeps
its own copy of what it needs (the PESQ engine included: csrc/pesq.cc,
built with g++ at first use), so nothing of speech_enhancement_tpu may be
loaded, not even its framework-free modules.  The kernel modules import on
a host without nvcc and build nothing until a wrapper gets a CUDA tensor.
Checked in a fresh interpreter, because this test process has JAX loaded
(tests/conftest.py), after computing PESQ labels as the training step
does.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "speech_enhancement_tpu_torch",
    "speech_enhancement_tpu_torch.ops",
    "speech_enhancement_tpu_torch.ops.stft",
    "speech_enhancement_tpu_torch.ops._native",
    "speech_enhancement_tpu_torch.ops.fused_stft",
    "speech_enhancement_tpu_torch.ops.fused_attention",
    "speech_enhancement_tpu_torch.ops.fused_relayout",
    "speech_enhancement_tpu_torch.ops.int8",
    "speech_enhancement_tpu_torch.models",
    "speech_enhancement_tpu_torch.models.layers",
    "speech_enhancement_tpu_torch.models.conformer",
    "speech_enhancement_tpu_torch.models.generator",
    "speech_enhancement_tpu_torch.models.discriminator",
    "speech_enhancement_tpu_torch.models.diffuse",
    "speech_enhancement_tpu_torch.models.tsc_diffusion",
    "speech_enhancement_tpu_torch.train",
    "speech_enhancement_tpu_torch.train.criterion",
    "speech_enhancement_tpu_torch.train.optim",
    "speech_enhancement_tpu_torch.train.state",
    "speech_enhancement_tpu_torch.train.gan",
    "speech_enhancement_tpu_torch.train.diffusion",
    "speech_enhancement_tpu_torch.train.learner",
    "speech_enhancement_tpu_torch.utils",
    "speech_enhancement_tpu_torch.utils.profiling",
    "speech_enhancement_tpu_torch.utils.convert",
    "speech_enhancement_tpu_torch.utils.device",
    "speech_enhancement_tpu_torch.enhance",
    "speech_enhancement_tpu_torch.metrics",
    "speech_enhancement_tpu_torch.metrics.pesq",
    "speech_enhancement_tpu_torch.scripts",
    "speech_enhancement_tpu_torch.scripts.train_quality_proxy",
    "speech_enhancement_tpu_torch.scripts.check_precision_quality",
    "speech_enhancement_tpu_torch.scripts.arch_ab_rich",
    "speech_enhancement_tpu_torch.scripts.train_diffusion_proxy",
    "speech_enhancement_tpu_torch.scripts.train_cdiffuse_proxy",
    "speech_enhancement_tpu_torch.scripts.run_full_recipe_proxy",
    "speech_enhancement_tpu_torch.scripts.label_bias_study",
    "speech_enhancement_tpu_torch.scripts.run_quality_parity",
    "speech_enhancement_tpu_torch.scripts.make_pesq_validation_set",
]

PROBE = """
import importlib, json, sys
import numpy as np
import torch
for name in {modules!r}:
    importlib.import_module(name)
from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.train.gan import host_pesq_labels
rng = np.random.default_rng(0)
t = np.arange(16000) / 16000
clean = np.stack([0.3 * np.sin(2 * np.pi * f * t) for f in (160.0, 190.0)])
noisy = clean + 0.05 * rng.standard_normal(clean.shape)
labels = host_pesq_labels(*(torch.from_numpy(a.astype(np.float32)) for a in (clean, noisy)))
print(json.dumps({{
    "labels": labels.tolist(),
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "flax", "optax", "yaml",
                                             "speech_enhancement_tpu", "scripts")),
    "libs": sorted(_native._libs),
}}))
"""


def test_port_imports_without_jax_or_nvcc():
    env = dict(os.environ, PATH=os.defpath, CUDA_HOME="/nonexistent",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", PROBE.format(modules=MODULES)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["foreign"] == []
    assert report["libs"] == ["pesq"]  # the host engine only: no CUDA library
    assert all(0.0 < x < 1.2 for x in report["labels"])  # (MOS - 1) / 3.5
