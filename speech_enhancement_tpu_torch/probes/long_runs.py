"""Runs the long-run scripts at their defaults on one card and keeps what
they show: ``run_full_recipe_proxy`` (100 epochs, the SIGKILL after epoch
24 and the resume) and ``label_bias_study`` (six 8-epoch arms, each arm's
wall time measured around its ``run_arm``), each with its wall time, the
card's name and power limit (``nvidia-smi``), and a scan of the recipe's
training log for losses that are not finite or that blow up.  Copies each
report, record and training log into ``--out`` as it finishes and prints
one JSON line per run (with the error instead, when a run fails).  Run
from the repository root:

    python3 -m speech_enhancement_tpu_torch.probes.long_runs --work /tmp/long_runs \\
        --out long_runs_out [--only full_recipe|label_bias [--flags ...]]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import time
import traceback

# the per-epoch line main_gan logs, and its per-step progress line
EPOCH_LINE = re.compile(r"Train Gen (\S+)  Train Disc (\S+)  Valid Gen (\S+)  Valid Disc (\S+)")
STEP_LINE = re.compile(r"Train: \[(\d+)/\d+\]\[(\d+)/\d+\].*generator loss (\S+) \(")


def scan_log(text: str) -> dict:
    """Each epoch's mean training losses and every logged step's generator
    loss from a ``main_gan`` log: the largest of each, and the epochs and
    steps whose value is not finite."""
    epochs = [[float(v) for v in m.groups()] for m in EPOCH_LINE.finditer(text)]
    steps = [(int(e), int(i), float(v)) for e, i, v in STEP_LINE.findall(text)]
    return {
        "epoch_lines": len(epochs),
        "max_train_gen": max((e[0] for e in epochs), default=None),
        "max_train_disc": max((e[1] for e in epochs), default=None),
        "max_step_gen": max((s[2] for s in steps), default=None),
        "not_finite_epochs": [i for i, e in enumerate(epochs)
                              if not all(math.isfinite(v) for v in e)],
        "not_finite_steps": [s[:2] for s in steps if not math.isfinite(s[2])],
        "train_gen_by_epoch": [e[0] for e in epochs],
        "valid_disc_by_epoch": [e[3] for e in epochs],
    }


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def keep(out: str, *paths: str) -> None:
    os.makedirs(out, exist_ok=True)
    for path in paths:
        if os.path.exists(path):
            shutil.copy(path, out)


def full_recipe(work: str, out: str, flags: list[str]) -> dict:
    from speech_enhancement_tpu_torch.scripts import run_full_recipe_proxy

    root = os.path.join(work, "full_recipe")
    log = os.path.join(root, "run", "scp", "default", "log_rank0.txt")
    t0 = time.perf_counter()
    try:
        rc = run_full_recipe_proxy.main(["--root", root, *flags])
    finally:
        keep(os.path.join(out, "full_recipe"), os.path.join(root, "full_recipe_run.md"),
             os.path.join(root, "full_recipe_run.json"), log)
    seconds = time.perf_counter() - t0
    with open(log) as f:
        scan = scan_log(f.read())
    return {"run": "run_full_recipe_proxy", "flags": flags, "exit_code": rc,
            "seconds": seconds, "card": card(), "log": scan}


def label_bias(work: str, out: str, flags: list[str]) -> dict:
    from speech_enhancement_tpu_torch.scripts import label_bias_study

    root = os.path.join(work, "label_bias")
    arm_seconds = {}
    run_arm = label_bias_study.run_arm

    def timed_arm(name, *args, **kwargs):
        t0 = time.perf_counter()
        record = run_arm(name, *args, **kwargs)
        arm_seconds[name] = time.perf_counter() - t0
        arm_root = os.path.join(root, name.replace("+", "p").replace("-", "m"))
        keep(os.path.join(out, "label_bias", name), os.path.join(arm_root, "ab_scp.json"),
             os.path.join(arm_root, "report.md"))
        return record

    label_bias_study.run_arm = timed_arm
    t0 = time.perf_counter()
    try:
        rc = label_bias_study.main(["--root", root, *flags])
    finally:
        label_bias_study.run_arm = run_arm
    seconds = time.perf_counter() - t0
    keep(os.path.join(out, "label_bias"), os.path.join(root, "label_bias_study.md"),
         os.path.join(root, "label_bias_study.json"))
    return {"run": "label_bias_study", "exit_code": rc, "seconds": seconds,
            "arm_seconds": arm_seconds, "card": card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True, help="corpora, checkpoints and logs")
    ap.add_argument("--out", required=True, help="where the reports and records are kept")
    ap.add_argument("--only", choices=["full_recipe", "label_bias"], default=None)
    ap.add_argument("--flags", nargs=argparse.REMAINDER, default=[],
                    help="more flags of the script run (with --only), e.g. --precision fp32")
    args = ap.parse_args(argv)
    for name, run in (("full_recipe", full_recipe), ("label_bias", label_bias)):
        if args.only in (None, name):
            try:
                result = run(args.work, args.out, args.flags)
            except (Exception, SystemExit):  # the next run goes on
                result = {"run": name, "error": traceback.format_exc(), "card": card()}
            os.makedirs(args.out, exist_ok=True)
            print(json.dumps(result), flush=True)
            with open(os.path.join(args.out, f"{name}.result.json"), "w") as f:
                json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
