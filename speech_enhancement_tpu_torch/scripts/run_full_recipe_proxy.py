"""The full 100-epoch reference recipe on the synthetic proxy corpus (port
of scripts/run_full_recipe_proxy.py).

The reference trains CMGAN/SCP for 100 epochs with a 4-cycle cosine
schedule (per-cycle lr halving, warmup 4: reference utils/utils.py:78-90),
the gen-first GAN flip at epoch 30 (``main_gan --gen-first``, the flip at
0.3 x epochs) and best-by-validation-discriminator-loss checkpoints
(main_gan.py:294-310).  The 8-epoch proxy runs scale the cycles down with
the epoch budget, so the cycle 2-4 halving and the epoch-30 flip never
run there; this script runs the whole budget through ``cli.main_gan`` in
a child process, SIGKILLs that child once the checkpoint of the last
epoch of cycle 1 (epoch 24) has landed, and resumes with ``--resume auto``
across the cycle boundary.  Schedule, loader and rng continuity across
the kill come from the checkpoint's step counters and the per-epoch
seeds (held bit for bit on the CPU by
tests/test_torch_cli_resume.py::test_resume_auto_is_bit_exact).  Then
every checkpoint is swept through ``cli.inference_gan``.

The kill fires once ``checkpoint_<k>/variables.pt`` exists and the
child's ``log_rank0.txt`` holds ``=> saved checkpoint_<k>``, which
``main_gan`` writes after the ``model_best`` copy; checkpoint directories
are renamed into place whole (``utils.checkpoint``).

Writes ``<root>/full_recipe_run.md`` (the per-epoch six-metric curve) and
its ``.json`` record unless ``--report``/``--record`` say otherwise.

Usage (one card; ``--device cpu`` runs on the CPU):
  python -m speech_enhancement_tpu_torch.scripts.run_full_recipe_proxy \\
      --root /path/to/full_recipe
"""

from __future__ import annotations

import argparse
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

from speech_enhancement_tpu_torch.scripts.train_quality_proxy import (
    CONFIG_DIR,
    data_opts,
    default_root,
    device_phrase,
    make_corpus,
    noisy_baseline,
    write_proxy_report,
)
from speech_enhancement_tpu_torch.utils.checkpoint import VARIABLES
from speech_enhancement_tpu_torch.utils.device import resolve_device

# the directory that holds the package, where the child process imports it
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POLL_SECONDS = 0.1


def _train_cmd(args, out: str, resume: bool) -> list[str]:
    """The child process of one ``main_gan`` phase."""
    cli_args = [
        "-a", "scp", "--cfg", os.path.join(CONFIG_DIR, "scp.yaml"),
        "--output", out, "--epochs", str(args.epochs),
        "--optimizer", "adamw", "--lr", "5e-4", "--criterion", "mse",
        "--gen-first", "--seed", str(args.train_seed), "-j", "4", "-p", "20",
        "--precision", args.precision,
    ] + data_opts(args.root, args.batch_size)
    extra = []
    if args.fused_attention:
        extra.append("--fused-attention")
    if resume:
        extra += ["--resume", "auto"]
    if args.device is not None:
        extra += ["--device", args.device]
    at = cli_args.index("--opts")
    cli_args[at:at] = extra
    code = (
        "from speech_enhancement_tpu_torch.cli import main_gan\n"
        f"main_gan.main({cli_args!r})\n"
    )
    return [sys.executable, "-c", code]


def _saved(ckpt_dir: str, epoch: int, log_offset: int) -> bool:
    """Whether ``checkpoint_<epoch>`` has landed: its ``variables.pt``
    exists and the log, past ``log_offset`` bytes, says it was saved."""
    name = f"checkpoint_{epoch:04d}"
    log = os.path.join(ckpt_dir, "log_rank0.txt")
    if not (os.path.exists(os.path.join(ckpt_dir, name, VARIABLES)) and os.path.exists(log)):
        return False
    with open(log, "rb") as f:
        f.seek(log_offset)
        return f"=> saved {name} ".encode() in f.read()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=default_root("full_recipe"))
    ap.add_argument("--train-pairs", type=int, default=320)
    ap.add_argument("--test-pairs", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--kill-after-epoch", type=int, default=24,
                    help="SIGKILL the trainer once this epoch's checkpoint lands (24 = "
                         "last epoch of lr cycle 1), then --resume auto across the cycle "
                         "boundary")
    ap.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    ap.add_argument("--fused-attention", action="store_true", default=True)
    ap.add_argument("--no-fused-attention", dest="fused_attention", action="store_false")
    ap.add_argument("--train-seed", type=int, default=3)
    ap.add_argument("--report", default=None, help="default <root>/full_recipe_run.md")
    ap.add_argument("--record", default=None,
                    help="JSON record path (default: --report with .json)")
    ap.add_argument("--device", default=None,
                    help="torch device of the CLIs; default cuda (raises without a card)")
    args = ap.parse_args(argv)
    args.root = os.path.abspath(args.root)
    if args.report is None:
        args.report = os.path.join(args.root, "full_recipe_run.md")
    if args.record is None:
        args.record = os.path.splitext(args.report)[0] + ".json"
    return args


def main(argv=None) -> int:
    """Corpus, training with the kill and the resume, the sweep, the
    report; returns the exit code (0: PASS)."""
    from speech_enhancement_tpu_torch.cli import inference_gan

    args = parse_args(argv)
    device = resolve_device(args.device)
    dev_opts = [] if args.device is None else ["--device", args.device]

    rng = np.random.default_rng(7)  # the corpus of every proxy run
    print("synthesizing corpus ...", flush=True)
    make_corpus(args.root, args.train_pairs, args.test_pairs, args.seconds, rng)

    out = os.path.join(args.root, "run")
    ckpt_dir = os.path.join(out, "scp", "default")
    log_path = os.path.join(ckpt_dir, "log_rank0.txt")  # appended to by both phases
    log_offset = os.path.getsize(log_path) if os.path.exists(log_path) else 0
    target = f"checkpoint_{args.kill_after_epoch:04d}"

    print(f"phase 1: training to epoch {args.kill_after_epoch}, then SIGKILL ...", flush=True)
    t0 = time.time()
    proc = subprocess.Popen(_train_cmd(args, out, resume=False), cwd=PACKAGE_ROOT)
    killed_at = None
    while proc.poll() is None:
        if _saved(ckpt_dir, args.kill_after_epoch, log_offset):
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            killed_at = time.time() - t0
            print(f"killed trainer {killed_at:.0f}s in, after {target}", flush=True)
            break
        time.sleep(POLL_SECONDS)
    if killed_at is None:
        # the trainer exited inside the last poll window: the target
        # checkpoint may have landed just before (a kill epoch near the
        # last epoch), and then the run is resumable, not lost
        proc.wait()
        if not _saved(ckpt_dir, args.kill_after_epoch, log_offset):
            raise SystemExit(f"trainer exited (rc={proc.returncode}) before {target} appeared")
        if proc.returncode != 0:
            print(f"trainer crashed (rc={proc.returncode}) after {target} landed; treating "
                  "it as the preemption and resuming", flush=True)
        else:
            print("trainer finished before the kill fired; continuing (phase 2's --resume "
                  "auto is then a no-op)", flush=True)

    print("phase 2: --resume auto across the cycle boundary ...", flush=True)
    rc = subprocess.run(_train_cmd(args, out, resume=True), cwd=PACKAGE_ROOT).returncode
    if rc != 0:
        raise SystemExit(f"resumed trainer failed rc={rc}")
    wall = time.time() - t0

    # evidence from the log: the resume epoch and the best-epoch decisions
    with open(log_path) as f:
        f.seek(log_offset)
        log_text = f.read()
    m = re.search(r"resumed from .*checkpoint_(\d+)", log_text)
    resume_epoch = int(m.group(1)) + 1 if m else None
    best_epochs = [int(e) for e in re.findall(r"checkpoint_(\d+) \(best=True\)", log_text)]

    missing = [e for e in range(args.epochs)
               if not os.path.isdir(os.path.join(ckpt_dir, f"checkpoint_{e:04d}"))]
    if missing:
        raise SystemExit(f"missing checkpoints after resume: {missing[:10]}")

    # the noisy baseline, and every checkpoint swept through the CLI
    noisy_paths, base = noisy_baseline(args.root)
    iargs, icfg = inference_gan.parse_option([
        "--output", os.path.join(args.root, "enhanced"), "--model_path", "unused",
        "--cfg", os.path.join(CONFIG_DIR, "scp.yaml"), "--batch-size", "24",
        "--precision", args.precision,
    ] + dev_opts + ["--opts", "DATA.TEST_CLEAN_DIR", f"{args.root}/test/clean",
                    "DATA.TEST_NOISY_DIR", f"{args.root}/test/noisy"])
    print("sweeping all checkpoints ...", flush=True)
    rows = []
    for epoch in range(args.epochs):
        mp = os.path.join(ckpt_dir, f"checkpoint_{epoch:04d}")
        m = inference_gan.inference(iargs, icfg, mp, noisy_paths)
        m /= len(noisy_paths)
        rows.append((epoch, m))
        print(f"epoch {epoch}: pesq {m[0]:.3f} stoi {m[5]:.3f}", flush=True)

    cycle = args.epochs // 4
    preamble = [
        "# Full 100-epoch reference recipe on the proxy corpus",
        "",
        f"Full-size SCP-GAN, the complete reference training recipe on "
        f"{device_phrase(device)} ({args.precision}, "
        f"{'fused' if args.fused_attention else 'plain'} attention, pipelined step mode): "
        f"{args.epochs} epochs, 4-cycle cosine lr with per-cycle halving and warmup 4 "
        f"(cycle boundaries at epochs {cycle}/{2 * cycle}/{3 * cycle}), gen-first GAN "
        f"flip at epoch {int(args.epochs * 0.3)}, best checkpoint by validation "
        "discriminator loss (reference utils/utils.py:78-90, main_gan.py:294-310).",
        "",
        f"Mid-run preemption drill: the trainer was SIGKILLed after {target} (the last "
        f"epoch of lr cycle 1) and resumed with `--resume auto`"
        + (f", which restarted at epoch {resume_epoch}, the first epoch of cycle 2"
           if resume_epoch is not None else "")
        + ". Schedule, loader and rng continuity across the kill are held bit for bit by "
        "tests/test_torch_cli_resume.py::test_resume_auto_is_bit_exact.",
        "",
        f"Best-by-valid-disc epoch: {best_epochs[-1] if best_epochs else 'n/a'} "
        f"(all best=True epochs this run: {best_epochs}).",
        f"Total wall time {wall / 60:.0f} min including the kill and the resume.",
        f"Synthetic proxy corpus ({args.train_pairs} pairs, pink noise, 0-10 dB): "
        "sustained-training evidence, not a VoiceBank quality claim.",
    ]
    return write_proxy_report(
        args.report, preamble, base, rows, "epoch", args.record,
        {"epochs": args.epochs, "precision": args.precision,
         "kill_after_epoch": args.kill_after_epoch,
         "resume_epoch": resume_epoch, "best_epochs": best_epochs,
         "wall_seconds": wall},
        "per_epoch", require_stoi=True,
    )


if __name__ == "__main__":
    raise SystemExit(main())
