"""The VoiceBank-DEMAND quality-parity runbook (port of
scripts/run_quality_parity.py).

Given the four VoiceBank-DEMAND directories, this runs the reference
recipe for each system through the port's CLIs: 100-epoch training
(``cli.main_gan``: SCP-GAN and/or CMGAN, discriminator lr 2x the
generator's, MSE, the reference loss weights) and the best-PESQ sweep of
the last checkpoints (``cli.inference_gan --validate-epochs``,
reference inference_gan.py:129-152), then writes a BASELINE.md-format
table against the reference's published numbers
(inference_gan.py:168-187):

    python -m speech_enhancement_tpu_torch.scripts.run_quality_parity \\
        --train-clean .../clean_trainset_28spk_wav \\
        --train-noisy .../noisy_trainset_28spk_wav \\
        --test-clean  .../clean_testset_wav \\
        --test-noisy  .../noisy_testset_wav \\
        --arch scp cmgan --epochs 100 -o runs/parity

Training is restartable (``--resume auto`` is passed through), so a
preempted run continues from its last checkpoint.  ``--dry-run`` prints
the commands without running them.  The run's overlay
``<output>/parity.yaml`` names the port's ``config/scp.yaml`` by its
absolute path as its ``BASE``, since both config loaders resolve a
relative ``BASE`` against the overlay's own directory.  ``--device``
(default cuda, raising without a card; ``cpu`` runs on the CPU) is passed
to both CLIs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

from speech_enhancement_tpu_torch.config import load_config
from speech_enhancement_tpu_torch.scripts.train_quality_proxy import CONFIG_DIR
from speech_enhancement_tpu_torch.utils.device import resolve_device

# the directory that holds the package, where ``python -m`` finds it
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_ROWS = {
    # best published run per system (BASELINE.md / inference_gan.py:168-187)
    "cmgan": (3.387, 4.623, 3.914, 4.103, 10.879, 0.957),
    "scp": (3.163, 4.371, 3.760, 3.838, 10.163, 0.954),
    "sc": (3.287, 4.539, 3.860, 4.007, None, None),
}
METRIC_NAMES = ("PESQ", "CSIG", "CBAK", "COVL", "SSNR", "STOI")
TAG = "parity"


def build_config(out_dir: str, args) -> str:
    """Write the run's overlay: the reference recipe (the port's
    ``scp.yaml``, by its absolute path) and the data directories."""
    cfg_path = os.path.join(out_dir, "parity.yaml")
    with open(cfg_path, "w") as f:
        f.write(
            f"BASE: ['{os.path.join(CONFIG_DIR, 'scp.yaml')}']\n"
            "DATA:\n"
            f"  TRAIN_CLEAN_DIR: '{os.path.abspath(args.train_clean)}'\n"
            f"  TRAIN_NOISY_DIR: '{os.path.abspath(args.train_noisy)}'\n"
            f"  TEST_CLEAN_DIR: '{os.path.abspath(args.test_clean)}'\n"
            f"  TEST_NOISY_DIR: '{os.path.abspath(args.test_noisy)}'\n"
        )
    return cfg_path


def checkpoint_dir(arch: str, cfg: str, model_dir: str) -> str:
    """Where ``cli.main_gan --output model_dir --tag parity -a arch`` writes
    its checkpoints: the config's ``OUTPUT``."""
    return load_config(cfg, output=model_dir, arch=arch, tag=TAG).OUTPUT


def commands_for(arch: str, cfg: str, out_dir: str, args) -> list[list[str]]:
    """The CLI invocations of the reference recipe for one system."""
    model_dir = os.path.join(out_dir, arch)
    loss_weights = ("[0.3,0.7,0.2,0.05]" if arch in ("scp", "sc")
                    else "[0.1,0.9,0.2,0.05]")  # scp.yaml:6 vs baseline
    device = [] if args.device is None else ["--device", args.device]
    train = [
        sys.executable, "-m", "speech_enhancement_tpu_torch.cli.main_gan",
        "-a", arch, "--cfg", cfg, "--output", model_dir, "--tag", TAG,
        "--epochs", str(args.epochs), "-b", str(args.batch_size),
        "--criterion", "mse", "--gen-first", "--resume", "auto",
        "--step-mode", args.step_mode,
        "--precision", args.train_precision, *device,
        "--opts", "LOSS_WEIGHTS", loss_weights,
    ]
    sweep = [
        sys.executable, "-m", "speech_enhancement_tpu_torch.cli.inference_gan",
        "--cfg", cfg, "--output", os.path.join(model_dir, "enhanced"),
        "--model_path", checkpoint_dir(arch, cfg, model_dir),
        "--validate-epochs",
        "--start", str(max(0, args.epochs - args.sweep_last)),
        "--end", str(args.epochs),
        "--batch-size", "32", "--precision", args.precision, *device,
    ]
    return [train, sweep]


def parse_sweep_output(text: str):
    """Best epoch and its six-metric row from the ``inference_gan`` sweep's
    output."""
    best_epoch = None
    m = re.search(r"Best epoch: (\d+)\s+best PESQ: ([\d.]+)", text)
    if m:
        best_epoch = int(m.group(1))
    rows = re.findall(
        r"Epoch: (\d+)\n"
        r"pesq: ([\d.]+)\s+csig: ([\d.]+)\s+cbak: ([\d.]+)\s+"
        r"covl: ([\d.]+)\s+ssnr: ([-\d.]+)\s+stoi: ([\d.]+)",
        text,
    )
    by_epoch = {int(r[0]): tuple(float(v) for v in r[1:]) for r in rows}
    if best_epoch is None and by_epoch:
        best_epoch = max(by_epoch, key=lambda e: by_epoch[e][0])
    return best_epoch, by_epoch.get(best_epoch)


def main(argv=None) -> dict | None:
    """Train and sweep each system, write the report; returns
    ``{arch: {"best_epoch", "metrics"}}`` (None with ``--dry-run``)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train-clean", required=True)
    p.add_argument("--train-noisy", required=True)
    p.add_argument("--test-clean", required=True)
    p.add_argument("--test-noisy", required=True)
    p.add_argument("--arch", nargs="+", default=["scp", "cmgan"],
                   choices=["scp", "cp", "sc", "cmgan"])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8, help="8 x 1 s crops")
    p.add_argument("--sweep-last", type=int, default=20,
                   help="checkpoint sweep covers the last N epochs")
    p.add_argument("--step-mode", default="async", choices=["two-phase", "async"],
                   help="async computes the host PESQ labels while the loop goes on")
    p.add_argument("--train-precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("-o", "--output", default="runs/parity")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device of both CLIs; default cuda (raises without a card)")
    args = p.parse_args(argv)
    if not args.dry_run:
        resolve_device(args.device)

    out_dir = os.path.abspath(args.output)
    os.makedirs(out_dir, exist_ok=True)
    cfg = build_config(out_dir, args)

    results = {}
    for arch in args.arch:
        for cmd in commands_for(arch, cfg, out_dir, args):
            print("$", " ".join(cmd), flush=True)
            if args.dry_run:
                continue
            is_sweep = "--validate-epochs" in cmd
            if is_sweep:
                # capture the sweep to parse its metric rows
                proc = subprocess.run(cmd, text=True, capture_output=True, cwd=PACKAGE_ROOT)
                sys.stdout.write(proc.stdout[-4000:])
                sys.stderr.write(proc.stderr[-4000:])
                code = proc.returncode
            else:
                # the (possibly 100-epoch) training log streams live
                code = subprocess.run(cmd, cwd=PACKAGE_ROOT).returncode
            if code != 0:
                raise SystemExit(f"{arch}: command failed ({code})")
            if is_sweep:
                best_epoch, row = parse_sweep_output(proc.stdout)
                results[arch] = {"best_epoch": best_epoch, "metrics": row}
    if args.dry_run:
        return None

    # BASELINE.md-format report
    lines = [
        "# VoiceBank-DEMAND quality parity\n",
        "| System | Metric | This framework | Reference best | Delta |",
        "|---|---|---|---|---|",
    ]
    for arch, res in results.items():
        ref = REFERENCE_ROWS.get(arch)
        row = res["metrics"]
        if row is None:
            continue
        for name, got, want in zip(METRIC_NAMES, row, ref or [None] * 6):
            delta = f"{got - want:+.3f}" if want is not None else "n/a"
            want_s = f"{want:.3f}" if want is not None else "n/a"
            lines.append(f"| {arch} (epoch {res['best_epoch']}) | {name} | "
                         f"{got:.3f} | {want_s} | {delta} |")
    report = os.path.join(out_dir, "quality_parity_results.md")
    with open(report, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"\nreport written to {report}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
