#!/usr/bin/env python3
"""Repeat ``chip_smoke.py`` phase 12b's small-width fp32 scp step on the card
and report each repeat's distance from the CPU's float64 step.

    python3 speech_enhancement_tpu_torch/probes/small_step_repeats.py [--repeats 4]

The step is ``chip_smoke.small_gan_grads`` (``TSCNet(8, 201)`` +
``Discriminator(4)``, batch 2 x 4000, fp32 at IEEE).  Each repeat gives the
relative RMS of the generator's and the discriminator's gradients from
the float64 step on the CPU, first with torch's default algorithms, then
with deterministic ones (``torch.use_deterministic_algorithms`` and
``cudnn.deterministic``), so that the spread of the figure phase 12b
bounds can be read run to run and process to process.  The last line is
one JSON object ``{"default": [...], "deterministic": [...], "cpu": {...}}``;
``cpu`` is the CPU's own fp32 step.  Run it in several processes to see
the spread across processes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=4)
    args = parser.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(HERE))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("small_step_repeats: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)

    ref = cs.small_gan_grads("cpu", torch.float64)

    def distances(device: str) -> dict:
        grads = cs.small_gan_grads(device, torch.float32)
        return {m: cs.rel_rms_t(g, ref[m]) for m, g in grads.items()}

    out = {"default": [distances("cuda") for _ in range(args.repeats)]}
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    out["deterministic"] = [distances("cuda") for _ in range(args.repeats)]
    out["cpu"] = distances("cpu")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
