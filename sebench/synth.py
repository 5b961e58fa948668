"""Traffic's audio, made from the seed: speech-like utterances (a harmonic
carrier with a pitch contour, formant emphasis and a syllabic envelope,
never fully silent) and noise mixed in at a chosen SNR.

A vectorized copy of ``synth_speech`` and ``synth_noise`` ("pink": a
one-pole lowpass of white noise) of the port's
``scripts/train_quality_proxy.py``: the per-utterance draws are made on
the host from the seed, the waveforms on the device in float64, a chunk
of utterances at a time.  The lengths are the caller's: the seed changes
the content, never the work.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch
from scipy import signal as sps

SR = 16000
F0 = (90.0, 220.0)
FORMANTS = ([400.0, 900.0, 2200.0], [800.0, 1800.0, 3200.0])
HARMONICS = 40


def lognormal_lengths(count: int, median_s: float, sigma: float, lo_s: float, hi_s: float,
                      sr: int = SR) -> list[int]:
    """``count`` lengths in samples at the mid-quantiles ``(i + 0.5) / count``
    of a log-normal (``median_s``, ``sigma``) clipped to [lo_s, hi_s]: the
    same set for every seed."""
    dist = statistics.NormalDist(np.log(median_s), sigma)
    return [int(round(sr * min(hi_s, max(lo_s, float(np.exp(dist.inv_cdf((i + 0.5) / count)))))))
            for i in range(count)]


def uniform_lengths(count: int, lo_s: float, hi_s: float, sr: int = SR) -> list[int]:
    """``count`` lengths evenly spread over [lo_s, hi_s]."""
    return [int(round(sr * (lo_s + (hi_s - lo_s) * (i + 0.5) / count))) for i in range(count)]


def speech(rng: np.random.Generator, lengths: list[int], device, chunk: int = 256
           ) -> list[np.ndarray]:
    """One float32 utterance of each length, RMS 0.05."""
    out: list[np.ndarray] = []
    for start in range(0, len(lengths), chunk):
        lens = lengths[start:start + chunk]
        b, n = len(lens), max(lens)
        base = torch.as_tensor(rng.uniform(*F0, b), device=device)
        vib = torch.as_tensor(rng.uniform(1.0, 3.0, b), device=device)
        formants = torch.as_tensor(rng.uniform(*FORMANTS, size=(b, 3)), device=device)
        phases = torch.as_tensor(rng.uniform(0, 2 * np.pi, (b, HARMONICS)), device=device)
        env_rate = torch.as_tensor(rng.uniform(2.0, 6.0, b), device=device)
        env_phase = torch.as_tensor(rng.uniform(0, 2 * np.pi, b), device=device)
        t = torch.arange(n, device=device, dtype=torch.float64)[None] / SR
        valid = t < torch.as_tensor(lens, device=device)[:, None] / SR
        f0 = base[:, None] * (1 + 0.08 * torch.sin(2 * np.pi * vib[:, None] * t))
        phase = 2 * np.pi * torch.cumsum(f0, dim=1) / SR
        mean_f0 = (f0 * valid).sum(1) / valid.sum(1)
        sig = torch.zeros_like(t.expand(b, n))
        for k in range(1, HARMONICS + 1):
            fk = k * mean_f0
            amp = (1.0 / (1.0 + ((fk[:, None] - formants) / 220.0) ** 2)).sum(1)
            amp = torch.where(fk > 4000, torch.zeros_like(amp), amp / k ** 0.5)
            sig += amp[:, None] * torch.sin(k * phase + phases[:, k - 1:k])
        env = 0.15 + 0.85 * torch.clamp(
            torch.sin(2 * np.pi * env_rate[:, None] * t + env_phase[:, None]), min=0)
        sig = sig * env * valid
        rms = torch.sqrt((sig ** 2).sum(1) / valid.sum(1))
        sig = (0.05 * sig / (rms[:, None] + 1e-9)).float().cpu().numpy()
        out += [sig[i, :lens[i]].copy() for i in range(b)]
    return out


def pink(rng: np.random.Generator, n: int, a: float = 0.9) -> np.ndarray:
    """Unit-RMS one-pole lowpassed white noise."""
    out = sps.lfilter([1 - a], [1, -a], rng.standard_normal(n))
    return (out / (np.sqrt((out ** 2).mean()) + 1e-9)).astype(np.float32)


def noisy(rng: np.random.Generator, clean: list[np.ndarray], snrs_db: list[float]
          ) -> list[np.ndarray]:
    """Each clean utterance plus pink noise at the SNRs in turn."""
    out = []
    for i, c in enumerate(clean):
        noise = pink(rng, len(c))
        rms = np.sqrt((c.astype(np.float64) ** 2).mean())
        out.append((c + noise * (rms / 10 ** (snrs_db[i % len(snrs_db)] / 20))).astype(np.float32))
    return out
