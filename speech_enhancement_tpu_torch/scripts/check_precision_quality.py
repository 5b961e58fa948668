"""Perceptual-transparency check of the fast serving modes (port of
scripts/check_precision_quality.py).

Enhances speech-like synthetic utterances with the full-size
``TSCNet(64, 201)`` from one set of seeded random weights, first in full
fp32 (the reference: unfused, ``matmul_precision=None``, so IEEE matmuls
and convolutions on the card), then in each fast mode, and scores PESQ
(reference output, fast output) with the native engine and the relative
waveform RMS.  The gate is PESQ >= 4.5.

Modes (the JAX script's, plus ``fp32``):
  fp32             the Enhancer's default precision ("bfloat16": TF32
                   matmuls and convolutions on the card), fused attention
                   and featurization (K1 fp32, K4, K5)
  bf16             bf16 compute, plain attention and featurization
  bf16_fused       bf16 compute, fused attention and featurization (K1
                   bf16, K4, K5)
  bf16_fused_int8  the same with the 15 encoder and decoder convs in int8
  fp32_int8        the Enhancer's default precision, plain attention,
                   int8 convs

Usage (one card; ``--device cpu`` runs on the CPU):
  python -m speech_enhancement_tpu_torch.scripts.check_precision_quality [--batch 8]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from speech_enhancement_tpu_torch.enhance import Enhancer
from speech_enhancement_tpu_torch.metrics.pesq import pesq
from speech_enhancement_tpu_torch.models import TSCNet
from speech_enhancement_tpu_torch.utils.device import resolve_device

SR = 16000
GATE_PESQ = 4.5
WEIGHT_SEED = 0

REFERENCE = dict(fused=False, quantized=False, dtype=None, matmul_precision=None)
MODES = {
    "fp32": dict(fused=True, quantized=False, dtype=None, matmul_precision="bfloat16"),
    "bf16": dict(fused=False, quantized=False, dtype=torch.bfloat16,
                 matmul_precision="bfloat16"),
    "bf16_fused": dict(fused=True, quantized=False, dtype=torch.bfloat16,
                       matmul_precision="bfloat16"),
    "bf16_fused_int8": dict(fused=True, quantized=True, dtype=torch.bfloat16,
                            matmul_precision="bfloat16"),
    "fp32_int8": dict(fused=False, quantized=True, dtype=None, matmul_precision="bfloat16"),
}
DEFAULT_MODES = ["bf16", "bf16_fused", "bf16_fused_int8", "fp32"]


def speechy_batch(batch: int, length: int) -> np.ndarray:
    """Voiced-sounding synthetic utterances (PESQ needs speech energy):
    AM-modulated harmonic stacks with per-row F0 jitter + noise floor."""
    rng = np.random.default_rng(7)
    t = np.arange(length) / SR
    rows = []
    for i in range(batch):
        f0 = 120.0 + 15.0 * (i % 5)
        x = sum(
            (0.4 / h) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6))
            for h in range(1, 6)
        )
        x *= 0.55 + 0.45 * np.sin(2 * np.pi * (2.5 + 0.3 * i) * t)
        x += 0.01 * rng.standard_normal(length)
        rows.append(0.3 * x / np.abs(x).max())
    return np.stack(rows).astype(np.float32)


def noisy_batch(batch: int, length: int) -> np.ndarray:
    """:func:`speechy_batch` plus white noise at 0.02 (rng 1)."""
    return speechy_batch(batch, length) + 0.02 * np.random.default_rng(
        1).standard_normal((batch, length)).astype(np.float32)


def seeded_weights(num_channel: int = 64) -> dict:
    """The one weight set of every mode: ``TSCNet(num_channel, 201)``
    initialized from a ``torch.Generator`` seeded :data:`WEIGHT_SEED`."""
    model = TSCNet(num_channel, 201, device="cpu",
                   generator=torch.Generator().manual_seed(WEIGHT_SEED))
    return model.state_dict()


def enhance(state_dict: dict, noisy: np.ndarray, mode: dict, device, batch: int,
            num_channel: int = 64) -> np.ndarray:
    """``noisy`` ``[B, L]`` enhanced by ``TSCNet(num_channel, 201)`` with
    ``state_dict``, routed and computed as ``mode`` says (a value of
    :data:`MODES`, or :data:`REFERENCE`)."""
    model = TSCNet(num_channel, 201, fused_attention=mode["fused"],
                   quantized_convs=mode["quantized"], device="cpu")
    model.load_state_dict(state_dict)
    enhancer = Enhancer(model, 400, 100, compute_dtype=mode["dtype"],
                        matmul_precision=mode["matmul_precision"], fused_stft=mode["fused"],
                        device=device)
    return np.stack(enhancer.enhance(list(noisy), batch_size=batch))


def score(ref: np.ndarray, out: np.ndarray) -> dict:
    """PESQ of each output row against the reference row (mean and min) and
    the relative RMS of the whole batch, rounded as the JSON lines print
    them."""
    scores = [pesq(SR, r, o) for r, o in zip(ref, out)]
    rel = float(np.sqrt(np.mean((ref - out) ** 2) / np.mean(ref ** 2)))
    return {
        "pesq_vs_fp32_mean": round(float(np.mean(scores)), 3),
        "pesq_vs_fp32_min": round(float(np.min(scores)), 3),
        "rel_rms": round(rel, 4),
    }


def main(argv=None) -> dict:
    """Prints one JSON line per mode and the summary line; returns the
    per-mode results."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--modes", nargs="+", default=DEFAULT_MODES, choices=list(MODES))
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"device: {name}; reference: fp32, matmul_precision None, unfused", flush=True)

    length = int(args.seconds * SR)
    weights = seeded_weights()
    noisy = noisy_batch(args.batch, length)
    ref = enhance(weights, noisy, REFERENCE, device, args.batch)
    results = {}
    for mode in args.modes:
        results[mode] = score(ref, enhance(weights, noisy, MODES[mode], device, args.batch))
        print(json.dumps({"mode": mode, **results[mode]}), flush=True)
    print(json.dumps({"gate_pesq": GATE_PESQ, "all": results}))
    return results


if __name__ == "__main__":
    main()
