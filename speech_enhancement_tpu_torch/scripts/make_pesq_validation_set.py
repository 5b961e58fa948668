"""The PESQ engine's validation set and conformance sweep (port of
scripts/make_pesq_validation_set.py).

The port's PESQ engine (``csrc/pesq.cc``, bound by ``metrics/pesq.py``) is
a from-scratch P.862-family implementation calibrated to published
anchors, not the ITU reference code of the `pesq` package.  This script
synthesizes deterministic degraded pairs from fixed seeds (additive
white, pink and babble-like noise, lowpass filtering, clipping and
enhancement-style residuals) and, with ``--score`` where the `pesq`
package is importable, scores them with ITU P.862.

``--conformance`` runs the MNRU sweep (ITU-T P.810 modulated noise
reference unit, y = x (1 + 10^(-Q/20) N) at Q = 5..45 dB over six seeds)
with the level and delay offsets around Q = 25 dB, scored by the native
engine (or by ITU P.862 with ``--score``), and writes the MOS values and
the behavioural summary (monotone violations in Q, the largest level and
delay deltas).  The generators, seeds and constants are the JAX script's,
so the sweep's signals are its signals bit for bit.

Outputs go under ``--out`` (default: a file in ``$TMPDIR/pesq_validation``),
never into the repository's test fixtures.

Usage (the engine runs on the host; ``--device`` is the contract of every
script here: default cuda, which raises without a card, or ``cpu``):
  python -m speech_enhancement_tpu_torch.scripts.make_pesq_validation_set \\
      [--conformance] [--score] [--n 102] [--out path.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from speech_enhancement_tpu_torch.scripts.train_quality_proxy import default_root
from speech_enhancement_tpu_torch.utils.device import resolve_device

SR = 16000
GENERATOR = "python -m speech_enhancement_tpu_torch.scripts.make_pesq_validation_set"


def _speech_like(rng: np.random.Generator, seconds: float = 4.0) -> np.ndarray:
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 230) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(1, 4) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    sig = np.zeros(n)
    formants = rng.uniform([350, 900, 2100], [850, 1900, 3300])
    for k in range(1, 44):
        fk = k * float(np.mean(f0))
        if fk > 4200:
            break
        amp = sum(1.0 / (1.0 + ((fk - F) / 200.0) ** 2) for F in formants)
        sig += (amp / k ** 0.5) * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    env = 0.1 + 0.9 * np.clip(
        np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 2 * np.pi)), 0, None)
    sig *= env
    return (0.05 * sig / np.sqrt((sig ** 2).mean() + 1e-12)).astype(np.float64)


def _degrade(rng: np.random.Generator, clean: np.ndarray, kind: str,
             severity: float) -> np.ndarray:
    n = len(clean)
    rms = np.sqrt((clean ** 2).mean())
    if kind == "white":
        noise = rng.standard_normal(n)
    elif kind == "pink":
        w = rng.standard_normal(n + 1)
        noise = np.empty(n + 1)
        noise[0] = w[0]
        for i in range(1, n + 1):
            noise[i] = 0.9 * noise[i - 1] + 0.1 * w[i]
        noise = noise[1:]
    elif kind == "babble":
        noise = sum(_speech_like(np.random.default_rng(int(rng.integers(1 << 30))), n / SR)
                    for _ in range(4))
        noise = noise[:n]
    elif kind == "lowpass":
        # one-pole lowpass of the signal itself, plus mild noise
        a = 0.5 + 0.45 * severity
        out = np.empty(n)
        out[0] = clean[0]
        for i in range(1, n):
            out[i] = a * out[i - 1] + (1 - a) * clean[i]
        return out + 0.01 * rms * rng.standard_normal(n)
    elif kind == "clip":
        th = np.quantile(np.abs(clean), 1.0 - 0.4 * severity)
        return np.clip(clean, -th, th)
    elif kind == "residual":
        # enhancement-style artifact: attenuated noise and a spectral ripple
        noise = rng.standard_normal(n)
        snr_db = 25 - 20 * severity
        noise *= rms / (10 ** (snr_db / 20))
        return clean * (1 + 0.05 * severity * np.sin(
            2 * np.pi * 3.0 * np.arange(n) / SR)) + 0.3 * noise
    else:
        raise ValueError(kind)
    snr_db = 30 - 30 * severity  # 30 .. 0 dB
    noise = noise / np.sqrt((noise ** 2).mean() + 1e-12)
    return clean + noise * rms / (10 ** (snr_db / 20))


KINDS = ["white", "pink", "babble", "lowpass", "clip", "residual"]

# the MNRU conformance sweep: Q in dB, the seeds of its clean signals, and
# the level and delay offsets applied around Q = 25 dB
MNRU_QS = list(range(5, 50, 5))
MNRU_SEEDS = [7001, 7002, 7003, 7004, 7005, 7006]
LEVEL_OFFSETS_DB = [-10.0, -5.0, 5.0, 10.0]
DELAY_MS = [4.0, 12.0, 32.0]


def _mnru(rng: np.random.Generator, clean: np.ndarray, q_db: float):
    return clean * (1.0 + 10 ** (-q_db / 20.0) * rng.standard_normal(len(clean)))


def build_conformance(score_fn) -> dict:
    """Run the sweep with ``score_fn(fs, ref, deg) -> MOS``."""
    mnru = []
    for seed in MNRU_SEEDS:
        clean = _speech_like(np.random.default_rng(seed))
        for q in MNRU_QS:
            deg = _mnru(np.random.default_rng(seed * 100 + q), clean, q)
            mnru.append({"seed": seed, "q_db": q,
                         "mos": round(float(score_fn(SR, clean, deg)), 6)})

    # level invariance: PESQ aligns levels, so scaling the degraded signal
    # must barely move the score
    level = []
    for seed in MNRU_SEEDS[:3]:
        clean = _speech_like(np.random.default_rng(seed))
        deg = _mnru(np.random.default_rng(seed * 100 + 25), clean, 25)
        base = float(score_fn(SR, clean, deg))
        for off in LEVEL_OFFSETS_DB:
            mos = float(score_fn(SR, clean, deg * 10 ** (off / 20.0)))
            level.append({"seed": seed, "offset_db": off, "delta_mos": round(mos - base, 6)})

    # delay invariance: the alignment stage must absorb a bulk delay
    delay = []
    for seed in MNRU_SEEDS[:3]:
        clean = _speech_like(np.random.default_rng(seed))
        deg = _mnru(np.random.default_rng(seed * 100 + 25), clean, 25)
        base = float(score_fn(SR, clean, deg))
        for ms in DELAY_MS:
            shift = int(ms * SR / 1000)
            shifted = np.concatenate([np.zeros(shift), deg[:-shift]])
            mos = float(score_fn(SR, clean, shifted))
            delay.append({"seed": seed, "delay_ms": ms, "delta_mos": round(mos - base, 6)})

    per_q = {q: [r["mos"] for r in mnru if r["q_db"] == q] for q in MNRU_QS}
    mean_curve = {q: round(float(np.mean(v)), 4) for q, v in per_q.items()}
    return {
        "sample_rate": SR, "mode": "wb",
        "generator": f"{GENERATOR} --conformance",
        "mnru": mnru,
        "mnru_mean_curve": mean_curve,
        "level_offsets": level,
        "delay_offsets": delay,
        "summary": {
            "monotone_violations": sum(
                1 for s in MNRU_SEEDS
                for a, b in zip(MNRU_QS[:-1], MNRU_QS[1:])
                if [r["mos"] for r in mnru if r["seed"] == s and r["q_db"] == a][0]
                >= [r["mos"] for r in mnru if r["seed"] == s and r["q_db"] == b][0]
            ),
            "max_abs_level_delta_mos": round(max(abs(r["delta_mos"]) for r in level), 4),
            "max_abs_delay_delta_mos": round(max(abs(r["delta_mos"]) for r in delay), 4),
        },
    }


def build_pairs(n: int):
    pairs = []
    for i in range(n):
        rng = np.random.default_rng(1000 + i)
        clean = _speech_like(rng)
        kind = KINDS[i % len(KINDS)]
        severity = float(rng.uniform(0.1, 1.0))
        deg = _degrade(rng, clean, kind, severity)
        pairs.append({"seed": 1000 + i, "kind": kind, "severity": round(severity, 4),
                      "clean": clean, "deg": deg})
    return pairs


def _write(path: str, data: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=102)
    ap.add_argument("--score", action="store_true",
                    help="score with the real `pesq` package and write the scores")
    ap.add_argument("--out", default=None,
                    help="the JSON written; default $TMPDIR/pesq_validation/ "
                         "pesq_reference_scores.json, or with --conformance "
                         "pesq_engine_conformance.json (pesq_itu_conformance.json with "
                         "--score)")
    ap.add_argument("--conformance", action="store_true",
                    help="run the MNRU/level/delay conformance sweep; with --score uses "
                         "ITU pesq, else the native engine")
    ap.add_argument("--device", default=None,
                    help="default cuda (raises without a card); the engine runs on the host")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    root = default_root("pesq_validation")

    if args.conformance:
        if args.score:
            try:
                from pesq import pesq as itu
            except ImportError:
                print("ERROR: `pesq` package not installed.", file=sys.stderr)
                return 1
            score_fn = lambda fs, r, d: itu(fs, r, d, "wb")  # noqa: E731
            out = args.out or os.path.join(root, "pesq_itu_conformance.json")
        else:
            from speech_enhancement_tpu_torch.metrics.pesq import pesq as score_fn
            out = args.out or os.path.join(root, "pesq_engine_conformance.json")
        result = build_conformance(score_fn)
        _write(out, result)
        print(f"wrote {out}")
        print("mean MNRU curve:", result["mnru_mean_curve"])
        print("summary:", result["summary"])
        return 0

    pairs = build_pairs(args.n)
    print(f"built {len(pairs)} deterministic pairs ({', '.join(KINDS)} x severities)")

    if not args.score:
        # sanity: run the native engine over the set
        from speech_enhancement_tpu_torch.metrics.pesq import pesq
        scores = [pesq(SR, p["clean"], p["deg"]) for p in pairs[:12]]
        print("native engine sample scores:", [round(s, 3) for s in scores])
        return 0

    try:
        from pesq import pesq as itu_pesq  # ITU P.862 via the pip package
    except ImportError:
        print("ERROR: the `pesq` package is not installed; run this on a "
              "machine with `pip install pesq`.", file=sys.stderr)
        return 1

    records = []
    for p in pairs:
        mos = float(itu_pesq(SR, p["clean"], p["deg"], "wb"))
        records.append({"seed": p["seed"], "kind": p["kind"], "severity": p["severity"],
                        "itu_pesq_wb": mos})
    out = args.out or os.path.join(root, "pesq_reference_scores.json")
    _write(out, {"sample_rate": SR, "mode": "wb", "n": len(records), "generator": GENERATOR,
                 "records": records})
    print(f"wrote {out} ({len(records)} reference scores)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
