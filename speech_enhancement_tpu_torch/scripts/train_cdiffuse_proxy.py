"""Training-to-quality proxy of standalone CDiffuSE (port of
scripts/train_cdiffuse_proxy.py).

Trains the upstream DiffuSE variant (no GroupNorm) with ``cli.cdiffuse``'s
step-granular learner on the pink-noise proxy corpus of
``train_quality_proxy``, sweeps its step checkpoints (the first pass's,
every ``--eval-every`` steps and the last) through
``cli.cdiffuse_inference.predict`` (the reverse loop from the noisy
waveform, clamped at every step, blending gamma 0.2 of the noisy input at
the last) and the six metrics, and writes the report and a JSON record;
exits non-zero unless the best swept PESQ beats the noisy input.  On a
card the sampler's |STFT| conditioner runs through K4.

Usage (one card; ``--device cpu`` runs on the CPU):
  python -m speech_enhancement_tpu_torch.scripts.train_cdiffuse_proxy \\
      --root /path/to/cdiffuse_proxy [--max-steps 3000]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from speech_enhancement_tpu_torch.data import load_wav
from speech_enhancement_tpu_torch.metrics import compute_metrics
from speech_enhancement_tpu_torch.scripts.train_quality_proxy import (
    SR,
    default_root,
    device_phrase,
    make_corpus,
    noisy_baseline,
    write_proxy_report,
)
from speech_enhancement_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    """Synthesize, train, sweep, report; returns the exit code (0: PASS)."""
    from speech_enhancement_tpu_torch.cli import cdiffuse, cdiffuse_inference

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=default_root("cdiffuse_proxy"))
    ap.add_argument("--train-pairs", type=int, default=320)
    ap.add_argument("--test-pairs", type=int, default=24)
    ap.add_argument("--max-steps", type=int, default=6000)
    ap.add_argument("--eval-every", type=int, default=600,
                    help="sweep checkpoints every k steps (plus the first pass and the "
                         "last step); a multiple of the steps of a pass lands on saved "
                         "checkpoints")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fast", action="store_true",
                    help="sweep with the 6-step schedule instead of the full 50-step one")
    ap.add_argument("--train-seed", type=int, default=3)
    ap.add_argument("--report", default=None, help="default <root>/cdiffuse_proxy_run.md")
    ap.add_argument("--device", default=None,
                    help="torch device of the CLIs; default cuda (raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.report is None:
        args.report = os.path.join(args.root, "cdiffuse_proxy_run.md")

    rng = np.random.default_rng(7)  # the GAN and diffusion proxies' corpus
    print("synthesizing corpus ...", flush=True)
    make_corpus(args.root, args.train_pairs, args.test_pairs, args.seconds, rng)

    model_dir = os.path.join(args.root, "model")
    print("training cdiffuse (full-size, upstream no-GroupNorm variant) ...", flush=True)
    cdiffuse.main([
        model_dir, f"{args.root}/train/clean", f"{args.root}/train/noisy",
        "--max-steps", str(args.max_steps),
        "--batch-size", str(args.batch_size),
        "--seed", str(args.train_seed), "-j", "4",
    ] + ([] if args.device is None else ["--device", args.device]))

    noisy_paths, base = noisy_baseline(args.root)
    clean_dir = os.path.join(args.root, "test", "clean")
    pairs = [(load_wav(p, SR)[0], load_wav(os.path.join(clean_dir, os.path.basename(p)),
                                           SR)[0]) for p in noisy_paths]

    steps_per_pass = args.train_pairs // args.batch_size
    sweep = sorted(set(
        [steps_per_pass]
        + list(range(args.eval_every, args.max_steps + 1, args.eval_every))
        + [args.max_steps]
    ))
    print(f"sweeping step checkpoints {sweep} ...", flush=True)
    rows = []
    for step in sweep:
        ckpt = os.path.join(model_dir, f"checkpoint_{step:04d}")
        if not os.path.isdir(ckpt):
            print(f"  (no checkpoint at step {step}, skipping)", flush=True)
            continue
        m = np.zeros(6)
        for noisy, clean in pairs:
            est = cdiffuse_inference.predict(noisy, ckpt, fast=args.fast, device=device)
            m += np.array(compute_metrics(clean, est, SR, 0))
        # one model per swept checkpoint: the cache keeps none of them
        cdiffuse_inference._model_cache.clear()
        m /= len(noisy_paths)
        rows.append((step, m))
        print(f"step {step}: pesq {m[0]:.3f} stoi {m[5]:.3f}", flush=True)
    if not rows:
        raise SystemExit(
            f"no restorable checkpoints found under {model_dir} for sweep "
            f"steps {sweep} — learner checkpoint layout mismatch?"
        )

    schedule = "6-step --fast" if args.fast else "full 50-step"
    lines = [
        "# CDiffuSE standalone training-to-quality proxy run "
        "(synthetic corpus)",
        "",
        "Full-size upstream DiffuSE (30x64 residual stack, no GroupNorm) "
        "trained with the",
        "step-granular `cli.cdiffuse` learner on the synthetic speech-like "
        f"corpus ({args.train_pairs}",
        f"train pairs, {args.seconds:.0f}s, 0-10 dB SNR pink noise, "
        f"{args.max_steps} steps of batch {args.batch_size} x 1s crops,",
        "adam lr 2e-4 — cdiffuse/learner.py:182), sampled per utterance "
        "with the",
        f"{schedule} reverse schedule via `cli.cdiffuse_inference`: the "
        "loop starts FROM",
        "the noisy waveform, clamps at every step, and blends gamma=0.2 "
        "noisy at the",
        "final step (reference cdiffuse/inference.py:136-163).  Generated by",
        "`python -m speech_enhancement_tpu_torch.scripts.train_cdiffuse_proxy` on "
        f"{device_phrase(device)}.",
    ]
    tag = "_fast" if args.fast else ""
    return write_proxy_report(
        args.report, lines, base, rows, "step",
        os.path.join(args.root, f"cdiffuse{tag}.json"),
        {
            "fast": bool(args.fast), "max_steps": args.max_steps,
            "seed": args.train_seed, "batch_size": args.batch_size,
        },
        "per_step",
    )


if __name__ == "__main__":
    raise SystemExit(main())
