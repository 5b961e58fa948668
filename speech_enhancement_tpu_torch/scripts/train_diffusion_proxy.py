"""Training-to-quality proxy of the diffusion families (port of
scripts/train_diffusion_proxy.py).

Trains ``cli.main_diffuse`` (``-a tsc-diffuse``, the spectrogram diffusion
TSCNet, or ``-a diffuse``, waveform DiffuSE) from scratch on the pink-noise
proxy corpus of ``train_quality_proxy``, sweeps every ``--eval-every``-th
checkpoint (and the last) through ``cli.inference_diffuse``'s reverse
sampler (the full 50-step schedule, or the 6-step one with ``--fast``) and
the six metrics, and writes the report and a JSON record; exits non-zero
unless the best swept PESQ beats the noisy input.  On a card the
tsc-diffuse sampler's STFTs and iSTFTs run through K4 and K5.

Usage (one card; ``--device cpu`` runs on the CPU):
  python -m speech_enhancement_tpu_torch.scripts.train_diffusion_proxy \\
      --root /path/to/diffusion_proxy
"""

from __future__ import annotations

import argparse
import os

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
from speech_enhancement_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    """Synthesize, train, sweep, report; returns the exit code (0: PASS)."""
    from speech_enhancement_tpu_torch.cli import inference_diffuse, main_diffuse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=default_root("diffusion_proxy"))
    ap.add_argument("--arch", default="tsc-diffuse", choices=["diffuse", "tsc-diffuse"])
    ap.add_argument("--train-pairs", type=int, default=320)
    ap.add_argument("--test-pairs", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--eval-every", type=int, default=10,
                    help="sweep every k-th checkpoint (plus the last)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--lr", default="2e-4", help="adamw lr (the CDiffuSE learner's)")
    ap.add_argument("--fast", action="store_true",
                    help="sweep with the 6-step schedule instead of the full 50-step one")
    ap.add_argument("--train-seed", type=int, default=3)
    ap.add_argument("--report", default=None,
                    help="default <root>/diffusion_proxy_run.md (tsc-diffuse) or "
                         "<root>/diffusion_waveform_proxy_run.md (diffuse)")
    ap.add_argument("--device", default=None,
                    help="torch device of the CLIs; default cuda (raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dev_opts = [] if args.device is None else ["--device", args.device]
    if args.report is None:
        args.report = os.path.join(args.root, "diffusion_proxy_run.md"
                                   if args.arch == "tsc-diffuse"
                                   else "diffusion_waveform_proxy_run.md")

    rng = np.random.default_rng(7)  # the GAN proxy's corpus
    print("synthesizing corpus ...", flush=True)
    make_corpus(args.root, args.train_pairs, args.test_pairs, args.seconds, rng)

    cfg = os.path.join(CONFIG_DIR, "baseline.yaml")
    out = os.path.join(args.root, "run")
    opts = data_opts(args.root, args.batch_size)

    print(f"training {args.arch} (full-size) ...", flush=True)
    main_diffuse.main([
        "-a", args.arch, "--cfg", cfg, "--output", out,
        "--epochs", str(args.epochs), "--optimizer", "adamw",
        "--lr", args.lr, "--seed", str(args.train_seed), "-j", "4",
        "-p", "20",
    ] + dev_opts + opts)

    noisy_paths, base = noisy_baseline(args.root)

    print("sweeping checkpoints ...", flush=True)
    iargs, icfg = inference_diffuse.parse_option([
        "-a", args.arch, "--output", os.path.join(args.root, "enhanced"),
        "--model_path", "unused", "--cfg", cfg,
    ] + (["--fast"] if args.fast else []) + dev_opts + opts)
    ckpt_dir = os.path.join(out, args.arch, "default")
    sweep = sorted(set(
        list(range(0, args.epochs, args.eval_every)) + [args.epochs - 1]
    ))
    rows = []
    for epoch in sweep:
        mp = os.path.join(ckpt_dir, f"checkpoint_{epoch:04d}")
        if not os.path.isdir(mp):
            continue
        m = inference_diffuse.inference(iargs, icfg, mp, noisy_paths)
        m /= len(noisy_paths)
        rows.append((epoch, m))
        print(f"epoch {epoch}: pesq {m[0]:.3f} stoi {m[5]:.3f}", flush=True)
    if not rows:
        raise SystemExit(
            f"no restorable checkpoints found under {ckpt_dir} for sweep "
            f"epochs {sweep} — training output layout mismatch?"
        )

    schedule = "6-step --fast" if args.fast else "full 50-step"
    lines = [
        "# Diffusion training-to-quality proxy run (synthetic corpus)",
        "",
        f"Full-size {args.arch} trained from scratch with "
        "`cli.main_diffuse` on the",
        f"synthetic speech-like corpus ({args.train_pairs} train pairs, "
        f"{args.seconds:.0f}s, 0-10 dB SNR pink noise,",
        f"{args.epochs} epochs x "
        f"{args.train_pairs // args.batch_size} steps, adamw lr {args.lr}),",
        f"sampled with the {schedule} reverse schedule via "
        "`cli.inference_diffuse`",
        "(reference inference_diffuse.py:117-269).  Generated by",
        "`python -m speech_enhancement_tpu_torch.scripts.train_diffusion_proxy` on "
        f"{device_phrase(device)}.",
    ]
    tag = "_fast" if args.fast else ""
    return write_proxy_report(
        args.report, lines, base, rows, "epoch",
        os.path.join(args.root, f"diffusion_{args.arch}{tag}.json"),
        {
            "arch": args.arch, "fast": bool(args.fast),
            "epochs": args.epochs, "seed": args.train_seed,
            "lr": args.lr, "batch_size": args.batch_size,
        },
        "per_epoch",
    )


if __name__ == "__main__":
    raise SystemExit(main())
