"""Run one cell of the benchmark.

    python3 -m sebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the checks on standard error and, as
the last line of standard output, the result as one JSON object.  Exits 2
with no result when the cell's CUDA devices are missing, 3 when JAX or the
JAX package was loaded in this process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parent / "_cache"
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from sebench import harness

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t0=T0)
    except harness.NoCard as exc:
        print(f"sebench: {exc}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"sebench: JAX or the JAX package was loaded in this process: {found}",
              file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
