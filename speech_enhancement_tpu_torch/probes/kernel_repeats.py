#!/usr/bin/env python3
"""Run K1 and K2 many times on the same inputs at the training path's
shapes, with the allocator's cache poisoned before each call, and report
every call whose output differs from the first.

    python3 speech_enhancement_tpu_torch/probes/kernel_repeats.py [--repeats 300] [--root DIR]

``--root`` is the checkout whose ``speech_enhancement_tpu_torch`` is run
(default: the one this file is in).  K1 (out and row log-sum-exp) and K2's
dq, dk, dv have no atomics, so every call must give the first call's bits:
a difference is a race or a read of memory the kernel did not write.  K2's
table gradient is summed with fp32 atomics, so it is held to the first
call's within 1e-5 of its largest entry (plus, in bf16, one step of the
final rounding: up to 2^-7 of the entry).  Before each call a 2 GiB block
of 0xff bytes (NaN in fp32 and bf16) is allocated and freed, so the
outputs' ``torch.empty`` buffers start as NaN.  Shapes: the time
conformer's B'=808 n=161 and the frequency conformer's B'=1288 n=101 of a
batch of 8 x 1 s, h=4, d=16, max_pos_emb 512, bf16 and fp32 (the instances
the wrappers pick, named by the launch counters that move).  Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

# ops/fused_attention.py's launch counters, K1's then K2's
COUNTERS = ("launches", "mma_launches", "tf32_launches", "bwd_launches", "bwd_mma_launches",
            "bwd_tf32_launches")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=300)
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    import chip_smoke as cs
    from speech_enhancement_tpu_torch.ops import fused_attention as fa

    if not torch.cuda.is_available():
        print("kernel_repeats: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    tag = f"{args.label} " if args.label else ""

    def poison():
        block = torch.full((2 << 30,), 0xFF, dtype=torch.uint8, device="cuda")
        del block

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    bad_total = 0
    for dtype in (torch.bfloat16, torch.float32):
        for b, n in ((808, 161), (1288, 101)):
            q, k, v, table = cs.attention_operands(b, n, dtype, gen)
            g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            scale = q.shape[-1] ** -0.5

            def call():
                poison()
                out, lse = fa.fused_shaw_attention_fwd(q, k, v, table, 512, scale, with_lse=True)
                poison()
                grads = fa.fused_shaw_attention_bwd(q, k, v, table, out, lse, g, 512, scale)
                return {"out": out, "lse": lse, "dq": grads[0], "dk": grads[1],
                        "dv": grads[2], "dtable": grads[3].float()}

            # the launch counters that move name the instances (an older
            # tree may lack the newer ones)
            before = {c: getattr(fa, c, 0) for c in COUNTERS}
            first = call()
            moved = [c for c in COUNTERS if getattr(fa, c, 0) != before[c]]
            torch.cuda.synchronize()
            finite = all(bool(t.float().isfinite().all()) for t in first.values())
            worst = {name: 0.0 for name in first}
            bad = []
            for r in range(args.repeats):
                got = call()
                for name, t in got.items():
                    ref = first[name].float()
                    diff = (t.float() - ref).abs().nan_to_num(float("inf"))
                    worst[name] = max(worst[name], float(diff.max()))
                    limit = torch.zeros_like(ref)
                    if name == "dtable":  # fp32 atomics, then one rounding to the dtype
                        limit = (1e-5 * ref.abs().max()
                                 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0) * ref.abs())
                    if bool((diff > limit).any()):
                        bad.append((r, name, float(diff.max())))
            bad_total += len(bad) + (not finite)
            what = f"{' + '.join(moved)} B'={b} n={n} {dtype}"
            print(f"{tag}{what}: {args.repeats} repeats after the first (finite: {finite}); "
                  f"{len(bad)} outputs differ; largest difference "
                  + ", ".join(f"{name} {x:.3g}" for name, x in worst.items()), flush=True)
            for r, name, diff in bad[:10]:
                print(f"{tag}    repeat {r}: {name} differs by {diff:.3g}", flush=True)
            del q, k, v, table, g, first, got
            torch.cuda.empty_cache()
    print(f"{tag}{bad_total} differing outputs in all", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
