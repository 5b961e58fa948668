"""The port's entry points and what they stand on (config, data, composite
metrics, checkpoints, logging, the training loop, data parallelism, the GAN, diffusion and
standalone CDiffuSE CLIs, their preprocessing, the checkpoint
converter and the quality, long-run and runbook scripts of ``scripts/``) import nothing of JAX,
flax, optax, yaml, the JAX package or the repository's ``scripts/``, and
need no CUDA toolchain to import; the packaged overlays load without
yaml.

Checked in a fresh interpreter (this test process has JAX loaded, by
tests/conftest.py), as tests/test_torch_imports.py checks the modules of
the earlier slices.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "speech_enhancement_tpu_torch.config",
    "speech_enhancement_tpu_torch.config.config",
    "speech_enhancement_tpu_torch.data",
    "speech_enhancement_tpu_torch.data.audio_io",
    "speech_enhancement_tpu_torch.data.voicebank",
    "speech_enhancement_tpu_torch.data.preprocess",
    "speech_enhancement_tpu_torch.data.numpy_dataset",
    "speech_enhancement_tpu_torch.metrics.composite",
    "speech_enhancement_tpu_torch.utils.checkpoint",
    "speech_enhancement_tpu_torch.utils.logging",
    "speech_enhancement_tpu_torch.utils.preemption",
    "speech_enhancement_tpu_torch.train.loop",
    "speech_enhancement_tpu_torch.parallel",
    "speech_enhancement_tpu_torch.parallel.mesh",
    "speech_enhancement_tpu_torch.parallel.launch",
    "speech_enhancement_tpu_torch.cli",
    "speech_enhancement_tpu_torch.cli.main_gan",
    "speech_enhancement_tpu_torch.cli.inference_gan",
    "speech_enhancement_tpu_torch.cli.main_diffuse",
    "speech_enhancement_tpu_torch.cli.inference_diffuse",
    "speech_enhancement_tpu_torch.cli.convert_checkpoint",
    "speech_enhancement_tpu_torch.cli.preprocess",
    "speech_enhancement_tpu_torch.cli.cdiffuse",
    "speech_enhancement_tpu_torch.cli.cdiffuse_inference",
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
import importlib, json, os, sys
for name in {modules!r}:
    importlib.import_module(name)
from speech_enhancement_tpu_torch.config import load_config
import speech_enhancement_tpu_torch.config as pkg
cfg = load_config(os.path.join(os.path.dirname(pkg.__file__), "scp.yaml"))
print(json.dumps({{
    "loss_weights": cfg.LOSS_WEIGHTS,
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "flax", "optax", "yaml",
                                             "speech_enhancement_tpu", "scripts")),
}}))
"""


def test_entry_points_import_without_jax_yaml_or_nvcc():
    env = dict(os.environ, PATH=os.defpath, CUDA_HOME="/nonexistent", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", PROBE.format(modules=MODULES)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["foreign"] == []
    assert report["loss_weights"] == [0.3, 0.7, 0.2, 0.05]
