"""The PESQ-engine label-bias sensitivity study (port of
scripts/label_bias_study.py).

The port's PESQ engine (``csrc/pesq.cc``) is calibrated to published
anchors but cannot be checked bit for bit against the ITU binary offline.
Every discriminator label flows through ``metrics.pesq.batch_pesq_raw``;
this study bounds the downstream cost of a plausible engine-vs-ITU
deviation by training short proxy arms with deliberately perturbed
labels (a constant bias of +-0.1 and +-0.3 MOS, zero-mean noise of sigma
0.1) through the ``SE_TPU_PESQ_LABEL_BIAS`` and ``SE_TPU_PESQ_LABEL_NOISE``
environment knobs, and reports each arm's trained PESQ and STOI against
the unperturbed control.

The evaluation path (``metrics.composite.compute_metrics`` ->
``metrics.pesq.pesq``) does not read the knobs, so every arm is scored by
the same unperturbed engine; only what the discriminator learns from
changes.

Each arm is ``train_quality_proxy`` in a process of its own (scp, bf16,
the fused attention kernels), skipped when its record exists.  Writes
``<root>/label_bias_study.md`` and its ``.json`` unless ``--report`` says
otherwise.

Usage (one card; ``--device cpu`` runs on the CPU):
  python -m speech_enhancement_tpu_torch.scripts.label_bias_study --root /path/to/label_bias
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

ARMS = [
    # (name, bias MOS, noise sigma MOS)
    ("control", 0.0, 0.0),
    ("bias+0.1", 0.1, 0.0),
    ("bias-0.1", -0.1, 0.0),
    ("bias+0.3", 0.3, 0.0),
    ("bias-0.3", -0.3, 0.0),
    ("noise0.1", 0.0, 0.1),
]


def run_arm(name: str, bias: float, noise: float, root: str, epochs: int,
            device: str | None = None, extra: tuple[str, ...] = ()) -> dict:
    """One arm's record, training it first unless it exists.  ``extra``:
    more ``train_quality_proxy`` flags (a shorter arm's corpus, say)."""
    arm_root = os.path.join(root, name.replace("+", "p").replace("-", "m"))
    record = os.path.join(arm_root, "ab_scp.json")
    if os.path.exists(record):
        print(f"[{name}] record exists, skipping", flush=True)
    else:
        env = dict(os.environ)
        env["SE_TPU_PESQ_LABEL_BIAS"] = str(bias)
        env["SE_TPU_PESQ_LABEL_NOISE"] = str(noise)
        cmd = [
            sys.executable, "-m", "speech_enhancement_tpu_torch.scripts.train_quality_proxy",
            "--root", arm_root, "--epochs", str(epochs),
            "--arch", "scp", "--precision", "bf16", "--fused-attention",
            "--report", os.path.join(arm_root, "report.md"),
        ] + ([] if device is None else ["--device", device]) + list(extra)
        print(f"[{name}] bias={bias} noise={noise} ...", flush=True)
        r = subprocess.run(cmd, env=env, cwd=PACKAGE_ROOT)
        if r.returncode != 0 and not os.path.exists(record):
            raise SystemExit(f"arm {name} failed (rc={r.returncode})")
    with open(record) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=default_root("label_bias"))
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--report", default=None, help="default <root>/label_bias_study.md")
    ap.add_argument("--device", default=None,
                    help="torch device of the arms; default cuda (raises without a card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.report is None:
        args.report = os.path.join(args.root, "label_bias_study.md")

    results = {}
    for name, bias, noise in ARMS:
        results[name] = run_arm(name, bias, noise, args.root, args.epochs, args.device)

    ctrl = results["control"]["per_epoch"]
    ctrl_best = max(v[0] for v in ctrl.values())
    ctrl_best_stoi = max(v[5] for v in ctrl.values())
    lines = [
        "# PESQ label-bias sensitivity study",
        "",
        f"Each arm is a {args.epochs}-epoch full-size SCP-GAN proxy run "
        "(`python -m speech_enhancement_tpu_torch.scripts.train_quality_proxy`, bf16 + "
        "fused attention, pipelined step mode, same corpus and seed) with the "
        "discriminator's PESQ labels deliberately perturbed through "
        "`SE_TPU_PESQ_LABEL_BIAS/NOISE` (injected in `metrics.pesq.batch_pesq_raw`, so "
        "both the training labels and the best-checkpoint validation discriminator "
        "loss).  All arms are evaluated by the same unperturbed engine.  This table "
        "converts a hypothetical engine-vs-ITU deviation into trained-quality cost.",
        "",
        "| arm | bias (MOS) | noise σ (MOS) | best PESQ | Δ vs control "
        "| best STOI | Δ | final-epoch PESQ |",
        "|---|---|---|---|---|---|---|---|",
    ]
    record = {}
    for name, bias, noise in ARMS:
        pe = results[name]["per_epoch"]
        best = max(v[0] for v in pe.values())
        best_stoi = max(v[5] for v in pe.values())
        final = pe[max(pe, key=int)][0]
        lines.append(
            f"| {name} | {bias:+.1f} | {noise:.1f} | {best:.3f} | "
            f"{best - ctrl_best:+.3f} | {best_stoi:.3f} | "
            f"{best_stoi - ctrl_best_stoi:+.3f} | {final:.3f} |"
        )
        record[name] = {"bias": bias, "noise": noise, "best_pesq": best,
                        "best_stoi": best_stoi, "final_pesq": final, "per_epoch": pe}
    # the headline is the perturbed arm farthest from the control (the
    # control itself is never picked)
    worst = max((r for k, r in record.items() if k != "control"),
                key=lambda r: abs(r["best_pesq"] - ctrl_best))
    lines += [
        "",
        f"Largest |Δ| across perturbed arms: ΔPESQ "
        f"{worst['best_pesq'] - ctrl_best:+.3f} (bias {worst['bias']:+.1f}"
        f", σ {worst['noise']:.1f}).",
        "",
        "Synthetic proxy corpus: a sensitivity bound, not a VoiceBank claim.",
    ]
    os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
    with open(args.report, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.splitext(args.report)[0] + ".json", "w") as f:
        json.dump({"noisy": results["control"]["noisy"], "arms": record}, f, indent=1)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
