"""Runs one quality script of ``speech_enhancement_tpu_torch/scripts`` in this
process and prints, after the script's own output, one JSON line: the
script and its flags, its exit code, its wall time, the card's name and
power limit (``nvidia-smi``), and the launches of every kernel it made
(the one launch count, ``ops._native.launches``).  Run from the
repository root on a machine with a card:

    python3 -m speech_enhancement_tpu_torch.probes.quality_run train_diffusion_proxy \\
        --root /path/to/diffusion_proxy [the script's flags]
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    from speech_enhancement_tpu_torch.ops import _native

    name, *flags = sys.argv[1:] if argv is None else argv
    script = importlib.import_module(f"speech_enhancement_tpu_torch.scripts.{name}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    _native.clear_launches()
    t0 = time.perf_counter()
    out = script.main(flags)
    seconds = time.perf_counter() - t0
    rc = out if isinstance(out, int) else 0
    print(json.dumps({"script": name, "flags": flags, "exit_code": rc, "seconds": seconds,
                      "card": card, "launches": _native.launches}), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
