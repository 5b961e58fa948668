"""Architecture A/B on the rich proxy corpus (port of scripts/arch_ab_rich.py).

Runs the 3 arches x 3 seeds GAN matrix (scp, sc, cmgan at train seeds
3-5), each arm a ``train_quality_proxy`` run in a subprocess on the rich
corpus (2 synthetic speakers x 4 noise families) in bf16 with the fused
attention kernels and the async step mode, skips an arm whose record
exists, and writes the comparison table (``.md``) and its ``.json``.

Usage (one card, about 5 min an arm; ``--device cpu`` runs on the CPU):
  python -m speech_enhancement_tpu_torch.scripts.arch_ab_rich --root /path/to/ab_rich
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from speech_enhancement_tpu_torch.scripts.train_quality_proxy import default_root
from speech_enhancement_tpu_torch.utils.device import resolve_device

# the directory that holds the package, where ``python -m`` finds it
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ARCHES = ["scp", "sc", "cmgan"]
SEEDS = [3, 4, 5]


def record_path(root: str, arch: str, seed: int) -> str:
    # train_quality_proxy tags the record with the step mode, the corpus
    # and a seed other than 3
    tag = "_async_rich" if seed == 3 else f"_async_rich_s{seed}"
    return os.path.join(root, f"ab_{arch}{tag}.json")


def run_arm(root: str, arch: str, seed: int, epochs: int, device: str | None = None) -> dict:
    arm_root = os.path.join(root, f"{arch}_s{seed}")
    rec = record_path(arm_root, arch, seed)
    if os.path.exists(rec):
        print(f"[{arch} s{seed}] record exists, skipping", flush=True)
    else:
        cmd = [
            sys.executable, "-m", "speech_enhancement_tpu_torch.scripts.train_quality_proxy",
            "--root", arm_root, "--epochs", str(epochs),
            "--arch", arch, "--train-seed", str(seed), "--corpus", "rich",
            "--precision", "bf16", "--fused-attention",
            "--step-mode", "async",
            "--report", os.path.join(arm_root, "report.md"),
        ] + ([] if device is None else ["--device", device])
        print(f"[{arch} s{seed}] training ...", flush=True)
        r = subprocess.run(cmd, cwd=PACKAGE_ROOT)
        if r.returncode != 0 and not os.path.exists(rec):
            raise SystemExit(f"arm {arch} s{seed} failed (rc={r.returncode})")
    with open(rec) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=default_root("ab_rich"))
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--report", default=None, help="default <root>/ab_rich_summary.md")
    ap.add_argument("--device", default=None,
                    help="torch device of the arms; default cuda (raises without a card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.report is None:
        args.report = os.path.join(args.root, "ab_rich_summary.md")

    results = {}
    for arch in ARCHES:
        for seed in SEEDS:
            results[(arch, seed)] = run_arm(args.root, arch, seed, args.epochs, args.device)

    noisy = results[(ARCHES[0], SEEDS[0])]["noisy"]
    lines = [
        "# Architecture A/B on the rich proxy corpus",
        "",
        "Full-size GAN arms (8 epochs, bf16 + fused attention, async "
        "step mode) on the HARDENED synthetic corpus: 2 speakers x 4 "
        "noise families (pink / white / babble-like modulated / "
        "band-limited), 320 train pairs, 0-10 dB SNR — vs the original "
        "single-speaker pink-noise corpus the earlier 3-seed ranking "
        "(docs/quality_proxy_run.md) was measured on.  Each arm's score "
        "is its best-epoch held-out PESQ/STOI from the "
        "`cli.inference_gan` checkpoint sweep.",
        "",
        f"Noisy baseline: PESQ {noisy[0]:.3f}, STOI {noisy[5]:.3f}.",
        "",
        "| arch | seed | best PESQ | best STOI | final-epoch PESQ |",
        "|---|---|---|---|---|",
    ]
    summary = {}
    for arch in ARCHES:
        bests = []
        for seed in SEEDS:
            pe = results[(arch, seed)]["per_epoch"]
            best = max(v[0] for v in pe.values())
            best_stoi = max(v[5] for v in pe.values())
            final = pe[max(pe, key=int)][0]
            bests.append(best)
            lines.append(f"| {arch} | {seed} | {best:.3f} | "
                         f"{best_stoi:.3f} | {final:.3f} |")
        summary[arch] = {
            "best_pesq_per_seed": bests,
            "mean_best_pesq": sum(bests) / len(bests),
        }
    ranking = sorted(summary, key=lambda a: -summary[a]["mean_best_pesq"])
    lines += [
        "",
        "Mean best PESQ across seeds: "
        + ", ".join(f"{a} {summary[a]['mean_best_pesq']:.3f}"
                    for a in ranking)
        + f" -> ranking on this corpus: {' > '.join(ranking)}.",
        "",
        "Synthetic proxy corpus — a ranking-robustness check, not a "
        "VoiceBank claim.",
    ]
    os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
    with open(args.report, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.splitext(args.report)[0] + ".json", "w") as f:
        json.dump({"noisy": noisy, "summary": summary,
                   "arms": {f"{a}_s{s}": results[(a, s)]
                            for a in ARCHES for s in SEEDS}}, f, indent=1)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
