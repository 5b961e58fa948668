"""Training-to-quality proxy of the SCP-GAN recipe (port of
scripts/train_quality_proxy.py).

Synthesizes a speech-like corpus (harmonic carriers with a pitch contour,
formant emphasis and a syllabic envelope, degraded by noise at 0-10 dB
SNR), trains one GAN arm from scratch through ``cli.main_gan`` and sweeps
its per-epoch checkpoints through ``cli.inference_gan``, then writes the
six-metric report and a JSON record and exits non-zero unless enhanced
PESQ and STOI beat the noisy baseline.  For the same generator and flags
the corpus is the JAX script's byte for byte: the same draws in the same
order, written as the same 16-bit PCM.

Usage (one card; ``--device cpu`` runs on the CPU):
  python -m speech_enhancement_tpu_torch.scripts.train_quality_proxy \\
      --root /path/to/quality_proxy
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
from glob import glob

import numpy as np
import torch

from speech_enhancement_tpu_torch import config as config_pkg
from speech_enhancement_tpu_torch.data import load_wav, save_wav
from speech_enhancement_tpu_torch.metrics import compute_metrics
from speech_enhancement_tpu_torch.utils.device import resolve_device

SR = 16000
CONFIG_DIR = os.path.dirname(os.path.abspath(config_pkg.__file__))

# two synthetic "speakers": a low-pitch profile (the original corpus) and a
# higher-pitch one with shifted formant ranges, so that an arch ranking is
# not measured on one voice
SPEAKERS = (
    dict(f0=(90, 220), formants=([400, 900, 2200], [800, 1800, 3200])),
    dict(f0=(165, 330), formants=([550, 1100, 2500], [950, 2100, 3700])),
)


def synth_speech(rng: np.random.Generator, seconds: float,
                 speaker: int = 0) -> np.ndarray:
    """Speech-like carrier: harmonic pulse train with random f0 contour,
    formant-shaped spectrum, and a syllabic (2-6 Hz) amplitude envelope."""
    prof = SPEAKERS[speaker]
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(*prof["f0"]) * (
        1 + 0.08 * np.sin(2 * np.pi * rng.uniform(1, 3) * t)
    )
    phase = 2 * np.pi * np.cumsum(f0) / SR
    sig = np.zeros(n)
    formants = rng.uniform(*prof["formants"])
    for k in range(1, 40):
        fk = k * np.mean(f0)
        if fk > 4000:
            break
        # formant emphasis: resonance-shaped harmonic amplitudes
        amp = sum(1.0 / (1.0 + ((fk - F) / 220.0) ** 2) for F in formants)
        sig += (amp / k ** 0.5) * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    # syllabic envelope with soft pauses (never fully silent: the collator's
    # PESQ silence gate and normalize_batch need energy)
    env = 0.15 + 0.85 * np.clip(
        np.sin(2 * np.pi * rng.uniform(2, 6) * t + rng.uniform(0, 2 * np.pi)),
        0, None,
    )
    sig *= env
    return (0.05 * sig / (np.sqrt((sig ** 2).mean()) + 1e-9)).astype(np.float32)


NOISE_FAMILIES = ("pink", "white", "band", "babble")


def synth_noise(rng: np.random.Generator, n: int,
                family: str = "pink") -> np.ndarray:
    """One unit-RMS noise utterance of the given family: ``pink`` (one-pole
    lowpassed white, a scalar recursion), ``white``, ``band`` (a 4th-order
    Butterworth band of random passband) or ``babble`` (four competing
    synthetic voices)."""
    if family == "white":
        out = rng.standard_normal(n)
    elif family == "band":
        from scipy import signal as sps

        lo = rng.uniform(300, 1200)
        hi = lo + rng.uniform(800, 2800)
        b, a = sps.butter(4, [lo / (SR / 2), hi / (SR / 2)], "band")
        out = sps.lfilter(b, a, rng.standard_normal(n))
    elif family == "babble":
        out = np.zeros(n)
        for _ in range(4):
            v = synth_speech(rng, n / SR, speaker=int(rng.integers(2)))
            out[: len(v)] += v[:n]
    else:  # pink
        w = rng.standard_normal(n + 1)
        a = 0.9
        out = np.empty(n + 1)
        out[0] = w[0]
        for i in range(1, n + 1):
            out[i] = a * out[i - 1] + (1 - a) * w[i]
        out = out[1:]
    return (out / (np.sqrt((out ** 2).mean()) + 1e-9)).astype(np.float32)


def make_corpus(root: str, n_train: int, n_test: int, seconds: float,
                rng: np.random.Generator, corpus: str = "pink") -> None:
    """``root/{train,test}/{clean,noisy}/uNNNN.wav``.  ``corpus='pink'``:
    one speaker in pink noise; ``'rich'``: both speakers and all four noise
    families interleaved, so that train and test cover every (speaker,
    noise) cell."""
    for split, count in (("train", n_train), ("test", n_test)):
        cdir = os.path.join(root, split, "clean")
        ndir = os.path.join(root, split, "noisy")
        os.makedirs(cdir, exist_ok=True)
        os.makedirs(ndir, exist_ok=True)
        for i in range(count):
            if corpus == "rich":
                speaker = i % len(SPEAKERS)
                family = NOISE_FAMILIES[i % len(NOISE_FAMILIES)]
            else:
                speaker, family = 0, "pink"
            clean = synth_speech(rng, seconds, speaker=speaker)
            noise = synth_noise(rng, len(clean), family=family)
            snr_db = rng.uniform(0, 10)
            rms_c = np.sqrt((clean ** 2).mean())
            noise *= rms_c / (10 ** (snr_db / 20))
            save_wav(os.path.join(cdir, f"u{i:04d}.wav"), clean, SR)
            save_wav(os.path.join(ndir, f"u{i:04d}.wav"),
                     (clean + noise).astype(np.float32), SR)


def corpus_digest(root: str) -> str:
    """SHA-256 over the corpus's wavs: each file's path under ``root`` and
    its bytes, in sorted path order."""
    digest = hashlib.sha256()
    for path in sorted(glob(os.path.join(root, "*", "*", "*.wav"))):
        digest.update(os.path.relpath(path, root).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()


def write_proxy_report(report_path: str, preamble: list[str],
                       base: np.ndarray, rows: list, row_label: str,
                       record_path: str, record_fields: dict,
                       per_key: str, require_stoi: bool = False) -> int:
    """The report, summary and record writer of the three proxy scripts:
    the six-metric markdown table (the noisy baseline, then one row per
    swept checkpoint), the ``Best <label> N: PESQ X vs noisy Y (Δ Z); STOI
    ...`` summary line, and the JSON record; prints the summary and the
    PASS/FAIL gate (PESQ must beat noisy; ``require_stoi`` adds STOI >=
    noisy) and returns the process exit code.  An empty sweep raises
    ``SystemExit`` before anything is written."""
    if not rows:
        raise SystemExit(
            "no restorable checkpoints found to sweep — training output "
            "layout mismatch or an aborted run?"
        )
    lines = list(preamble) + [
        "",
        "| checkpoint | PESQ | CSIG | CBAK | COVL | SSNR | STOI |",
        "|---|---|---|---|---|---|---|",
        "| noisy (baseline) | " + " | ".join(f"{v:.3f}" for v in base) + " |",
    ]
    for key, m in rows:
        lines.append(f"| {row_label} {key} | " +
                     " | ".join(f"{v:.3f}" for v in m) + " |")
    best = max(rows, key=lambda r: r[1][0])
    lines += [
        "",
        f"Best {row_label} {best[0]}: PESQ {best[1][0]:.3f} vs noisy "
        f"{base[0]:.3f} (Δ {best[1][0] - base[0]:+.3f}); "
        f"STOI {best[1][5]:.3f} vs {base[5]:.3f} "
        f"(Δ {best[1][5] - base[5]:+.3f}).",
    ]
    report_dir = os.path.dirname(report_path)
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
    with open(report_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines[-2:]))

    record_dir = os.path.dirname(record_path)
    if record_dir:
        os.makedirs(record_dir, exist_ok=True)
    with open(record_path, "w") as f:
        json.dump({
            **record_fields,
            "noisy": [float(v) for v in base],
            per_key: {str(k): [float(v) for v in m] for k, m in rows},
        }, f, indent=1)

    ok = best[1][0] > base[0] and (not require_stoi or best[1][5] >= base[5])
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def noisy_baseline(root: str) -> tuple[list[str], np.ndarray]:
    """The sorted noisy test wavs of the corpus at ``root`` and their six
    metrics against the clean ones, averaged (files paired by basename)."""
    noisy_paths = sorted(glob(os.path.join(root, "test", "noisy", "*.wav")))
    base = np.zeros(6)
    for p in noisy_paths:
        # join on the basename: a root containing "noisy" stays whole
        clean, _ = load_wav(os.path.join(root, "test", "clean", os.path.basename(p)), SR)
        noisy, _ = load_wav(p, SR)
        base += np.array(compute_metrics(clean, noisy, SR, 0))
    return noisy_paths, base / len(noisy_paths)


def data_opts(root: str, batch_size: int) -> list[str]:
    """The CLIs' ``--opts`` pointing their config at the corpus."""
    return [
        "--opts",
        "DATA.TRAIN_CLEAN_DIR", f"{root}/train/clean",
        "DATA.TRAIN_NOISY_DIR", f"{root}/train/noisy",
        "DATA.TEST_CLEAN_DIR", f"{root}/test/clean",
        "DATA.TEST_NOISY_DIR", f"{root}/test/noisy",
        "DATA.BATCH_SIZE", str(batch_size),
    ]


def device_phrase(device: torch.device) -> str:
    """Where a run ran, for a report's preamble: ``one <card name>``, or
    ``the CPU``."""
    if device.type == "cuda":
        return f"one {torch.cuda.get_device_name(device)}"
    return "the CPU"


def default_root(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=default_root("quality_proxy"))
    ap.add_argument("--train-pairs", type=int, default=320)
    ap.add_argument("--test-pairs", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--report", default=None,
                    help="default <root>/quality_proxy_run.md")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--fused-attention", action="store_true",
                    help="train with the fused attention kernels (K1 forward, K2 "
                         "backward)")
    ap.add_argument("--arch", default="scp", choices=["scp", "cp", "sc", "cmgan"],
                    help="arch arm; the record goes to <root>/ab_<arch><tag>.json")
    ap.add_argument("--train-seed", type=int, default=3,
                    help="main_gan --seed (init and loader stream); the corpus stays "
                         "fixed (rng 7) so that runs share the data")
    ap.add_argument("--corpus", default="pink", choices=["pink", "rich"],
                    help="'pink': one speaker in pink noise; 'rich': 2 speakers x 4 noise "
                         "families (pink/white/band/babble)")
    ap.add_argument("--step-mode", default=None,
                    choices=["two-phase", "async", "pipelined", "fused"],
                    help="main_gan --step-mode passthrough")
    ap.add_argument("--device", default=None,
                    help="torch device of the CLIs; default cuda (raises without a card)")
    args = ap.parse_args(argv)
    if args.report is None:
        args.report = os.path.join(args.root, "quality_proxy_run.md")
    return args


def main(argv=None) -> int:
    """Synthesize, train, sweep, report; returns the exit code (0: PASS)."""
    from speech_enhancement_tpu_torch.cli import inference_gan, main_gan

    args = parse_args(argv)
    device = resolve_device(args.device)
    dev_opts = [] if args.device is None else ["--device", args.device]

    rng = np.random.default_rng(7)
    print("synthesizing corpus ...", flush=True)
    make_corpus(args.root, args.train_pairs, args.test_pairs, args.seconds,
                rng, corpus=args.corpus)

    cfg = os.path.join(CONFIG_DIR, "scp.yaml")
    out = os.path.join(args.root, "run")
    opts = data_opts(args.root, args.batch_size)

    print(f"training {args.arch}-GAN (full-size) ...", flush=True)
    main_gan.main([
        "-a", args.arch, "--cfg", cfg, "--output", out,
        "--epochs", str(args.epochs), "--optimizer", "adamw",
        "--lr", "5e-4", "--criterion", "mse", "--gen-first",
        "--seed", str(args.train_seed), "-j", "4", "-p", "20",
        "--precision", args.precision,
    ] + (["--fused-attention"] if args.fused_attention else [])
      + (["--step-mode", args.step_mode] if args.step_mode else []) + dev_opts + opts)

    noisy_paths, base = noisy_baseline(args.root)

    print("sweeping checkpoints ...", flush=True)
    iargs, icfg = inference_gan.parse_option([
        "--output", os.path.join(args.root, "enhanced"),
        "--model_path", "unused", "--cfg", cfg, "--batch-size", "24",
    ] + dev_opts + opts)
    ckpt_dir = os.path.join(out, args.arch, "default")
    rows = []
    for epoch in range(args.epochs):
        mp = os.path.join(ckpt_dir, f"checkpoint_{epoch:04d}")
        if not os.path.isdir(mp):
            continue
        m = inference_gan.inference(iargs, icfg, mp, noisy_paths)
        m /= len(noisy_paths)
        rows.append((epoch, m))
        print(f"epoch {epoch}: pesq {m[0]:.3f} stoi {m[5]:.3f}", flush=True)

    preamble = [
        "# Training-to-quality proxy run (synthetic corpus)",
        "",
        f"Full-size {args.arch.upper()}-GAN trained from scratch with "
        "`cli.main_gan` on a",
        f"synthetic speech-like corpus ({args.train_pairs} train pairs, "
        f"{args.seconds:.0f}s, 0-10 dB SNR, "
        + ("2 speakers x 4 noise families" if args.corpus == "rich"
           else "pink noise") + "), evaluated with the",
        "`cli.inference_gan` checkpoint sweep on held-out pairs",
        "(reference inference_gan.py:134-152). Generated by",
        "`python -m speech_enhancement_tpu_torch.scripts.train_quality_proxy` on "
        f"{device_phrase(device)} ({args.precision} training).",
    ]
    tag = f"_{args.step_mode}" if args.step_mode else ""
    if args.corpus != "pink":
        tag += f"_{args.corpus}"
    if args.train_seed != 3:  # seed-robustness arms keep the base record
        tag += f"_s{args.train_seed}"
    return write_proxy_report(
        args.report, preamble, base, rows, "epoch",
        os.path.join(args.root, f"ab_{args.arch}{tag}.json"),
        {
            "arch": args.arch, "precision": args.precision,
            "fused_attention": bool(args.fused_attention),
            "step_mode": args.step_mode, "corpus": args.corpus,
            "epochs": args.epochs, "seed": args.train_seed,
        },
        "per_epoch", require_stoi=True,
    )


if __name__ == "__main__":
    raise SystemExit(main())
