"""The port imports without JAX, flax or a CUDA toolchain.

The machine with the card has no JAX, flax or yaml, so the port must not
reach for them; and the kernel modules must import on a host without
nvcc, building nothing until a wrapper gets a CUDA tensor.  Checked in a
fresh interpreter, because this test process has JAX loaded
(tests/conftest.py).
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
    "speech_enhancement_tpu_torch.models",
    "speech_enhancement_tpu_torch.models.layers",
    "speech_enhancement_tpu_torch.models.conformer",
    "speech_enhancement_tpu_torch.models.generator",
    "speech_enhancement_tpu_torch.utils",
    "speech_enhancement_tpu_torch.utils.convert",
    "speech_enhancement_tpu_torch.utils.device",
    "speech_enhancement_tpu_torch.enhance",
]

PROBE = """
import importlib, json, sys
for name in {modules!r}:
    importlib.import_module(name)
from speech_enhancement_tpu_torch.ops import _native
print(json.dumps({{
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "flax", "optax", "yaml",
                                             "speech_enhancement_tpu")),
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
    assert report["libs"] == []
