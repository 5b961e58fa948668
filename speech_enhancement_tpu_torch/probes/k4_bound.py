#!/usr/bin/env python3
"""K4's check in ``chip_smoke.py`` (stft+compress at [32, 32000], n_fft 400,
hop 100: rtol 1e-4, atol 2e-4 against the fp32 plain version) on seeded
draws: whether it holds, and the kernel's and the fp32 plain version's
distances from the float64 plain version, with the bound applied to each
(the compression multiplies rounding by 0.3 |X|^-0.7, so a near-empty bin
decides).  The first draw is the one the check gets (K4's generator,
seeded with ``chip_smoke.SEED``); then ``--draws`` more from seeds 1000
on.  Prints the card's name and power limit first.

    python3 speech_enhancement_tpu_torch/probes/k4_bound.py [--draws 20]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draws", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    import chip_smoke as cs
    from speech_enhancement_tpu_torch.ops import fused_stft as fs

    if not torch.cuda.is_available():
        print("k4_bound: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cs.full_fp32()
    seeds = [cs.SEED] + [1000 + i for i in range(args.draws)]
    held = 0
    for i, seed in enumerate(seeds):
        x = torch.randn(32, 32000, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed))
        kernel, plain = (torch.view_as_real(t).double() for t in (fs.fused_stft(x),
                                                                   fs.stft_reference(x)))
        exact = torch.view_as_real(fs.stft_reference(x.double()))
        err, ok = cs.within(kernel, plain, 1e-4, 2e-4)
        e_kernel, ok_kernel = cs.within(kernel, exact, 1e-4, 2e-4)
        e_plain, ok_plain = cs.within(plain, exact, 1e-4, 2e-4)
        worst = int((kernel - plain).abs().argmax()) // 2
        x_abs = float(fs.stft_reference(x.double(), comp_type="none").abs().flatten()[worst])
        held += ok
        print(f"{'the check draw' if i == 0 else f'seed {seed}'}: kernel vs fp32 plain "
              f"{err:.3e} ({'ok' if ok else 'FAIL'}); against float64: kernel {e_kernel:.3e} "
              f"({'ok' if ok_kernel else 'FAIL'}), fp32 plain {e_plain:.3e} "
              f"({'ok' if ok_plain else 'FAIL'}); |X| at the worst bin {x_abs:.3e}", flush=True)
    print(f"the check held on {held} of {len(seeds)} draws", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
