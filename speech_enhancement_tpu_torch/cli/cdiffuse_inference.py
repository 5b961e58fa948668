"""Standalone CDiffuSE inference (port of
speech_enhancement_tpu/cli/cdiffuse_inference.py).

Reverse sampling from the noisy waveform (``train.diffusion.sample_waveform``
with the per-step clamp and the final noisy blend gamma 0.2), with a model
cache keyed by the checkpoint's path.

Usage:
  python -m speech_enhancement_tpu_torch.cli.cdiffuse_inference \\
      --model-dir <dir> --noisy <wav or dir> -o out [--fast] \\
      [--conditioner auto|stft|se|mel] [--device cuda]

``--model-dir`` is a ``cli.cdiffuse`` run (its ``weights/``) or a
checkpoint directory (``variables.pt``, as ``cli.convert_checkpoint``
writes from an upstream ``weights.pt``, with ``params.json``).  The model's
sizes come from its weights (the hop from the upsampler's kernel, L x L),
its dilation cycle and noise schedules from ``params.json`` where there is
one, else ``PARAMS`` and the reference's schedules.  The conditioner is
the one the checkpoint was trained on (``--conditioner auto``): the native
``|STFT|`` at 201 bins and hop 100 (K4 on the card), the log1p ``se``
spectrogram of ``data/preprocess.make_spectrum`` at 129 bins or more, else
the ``mel`` stack; ``se`` and ``mel`` are computed on the host.  A forced
``stft`` frames at the model's hop: K4 where it takes the geometry
(``ops.fused_stft.supports``), else ``ops/stft.py``; the route is printed.
``--device`` defaults to ``cuda`` (raises without a card).
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob
from pathlib import Path

import numpy as np
import torch

from speech_enhancement_tpu_torch.cli.convert_checkpoint import (
    PARAMS_JSON,
    diffuse_from_state_dict,
)
from speech_enhancement_tpu_torch.data import load_wav, save_wav
from speech_enhancement_tpu_torch.data.preprocess import _mel_filterbank, make_spectrum
from speech_enhancement_tpu_torch.ops import fused_stft
from speech_enhancement_tpu_torch.train import inference_schedule, sample_waveform
from speech_enhancement_tpu_torch.utils.checkpoint import VARIABLES, load_variables
from speech_enhancement_tpu_torch.utils.device import resolve_device

PARAMS = dict(
    n_specs=201,
    n_fft=400,
    hop_samples=100,
    residual_layers=30,
    residual_channels=64,
    dilation_cycle_length=10,
)
NOISE_SCHEDULE = np.linspace(1e-4, 0.035, 50)
INFERENCE_NOISE_SCHEDULE = [0.0001, 0.001, 0.01, 0.05, 0.2, 0.35]

# (absolute path, device) -> (model, the params it was saved with)
_model_cache: dict[tuple, tuple] = {}


def load_model(model_dir: str, device=None) -> tuple:
    """``(model, params)`` of ``model_dir`` (its ``weights/`` if it has one),
    cached by its absolute path and the device: the weights of
    ``variables.pt``, the params of ``params.json`` (``{}`` without one)."""
    device = resolve_device(device)
    key = (os.path.abspath(model_dir), str(device))
    if key in _model_cache:
        return _model_cache[key]
    path = Path(model_dir)
    if (path / "weights").exists():
        path = path / "weights"
    if not (path / VARIABLES).exists():
        raise SystemExit(f"{model_dir}: no {VARIABLES}, in it or in its weights/")
    sd = load_variables(str(path))["model"]
    saved = path / PARAMS_JSON
    params = json.loads(saved.read_text()) if saved.exists() else {}
    params.setdefault("dilation_cycle_length", PARAMS["dilation_cycle_length"])
    model = diffuse_from_state_dict(sd, params)
    model.load_state_dict(sd)
    _model_cache[key] = (model.to(device).eval(), params)
    return _model_cache[key]


def _se_conditioner(noisy: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """The se-mode conditioner ``[1, 1 + L // hop, n_fft // 2 + 1]``:
    ``make_spectrum`` (peak-normalized, centered symmetric-Hamming STFT,
    log1p magnitude) in float64, transposed, as float32."""
    sxx, _, _ = make_spectrum(y=noisy.astype(np.float64), frame_length=n_fft, shift=hop)
    return sxx.T[None].astype(np.float32)


def _mel_conditioner(noisy: np.ndarray, n_fft: int, hop: int, n_mels: int,
                     sr: int = 16000) -> np.ndarray:
    """The mel-mode conditioner ``[1, 1 + L // hop, n_mels]``: a periodic
    Hann of ``min(4 hop, n_fft)`` centred in ``n_fft``, the magnitude over
    the window's norm (torchaudio's ``normalized=True``, power 1), the HTK
    filterbank from 20 Hz to ``sr / 2``, then ``clip((20 log10(clip(S,
    1e-5)) - 20 + 100) / 100, 0, 1)``.  Its framing differs from
    ``mel_transform``'s, as the reference's two paths do."""
    win_length = min(4 * hop, n_fft)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    lpad = (n_fft - win_length) // 2
    window = np.pad(window, (lpad, n_fft - win_length - lpad))
    y = np.pad(noisy.astype(np.float64), (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    mag = np.abs(np.fft.rfft(y[idx] * window, n=n_fft, axis=-1))
    mag = mag / np.sqrt(np.sum(window ** 2))
    mel = mag @ _mel_filterbank(sr, n_fft, n_mels, 20.0, sr / 2.0).T
    db = 20.0 * np.log10(np.clip(mel, 1e-5, None)) - 20.0
    return np.clip((db + 100.0) / 100.0, 0.0, 1.0)[None].astype(np.float32)


def _mode(model, mode: str) -> str:
    """``auto`` resolved by the model's widths: ``stft`` for 201 bins at hop
    100, ``se`` for 129 bins or more, else ``mel``."""
    if mode != "auto":
        return mode
    if model.n_specs == PARAMS["n_fft"] // 2 + 1 and model.hop_length == PARAMS["hop_samples"]:
        return "stft"
    return "se" if model.n_specs >= 129 else "mel"


def _conditioner_for(model, noisy: np.ndarray, mode: str = "auto"):
    """The conditioner ``[1, frames, bins]`` of ``mode`` for ``model``, or
    None for ``stft``, which ``sample_waveform`` computes itself."""
    mode = _mode(model, mode)
    if mode == "stft":
        return None
    if mode == "se":
        return _se_conditioner(noisy, (model.n_specs - 1) * 2, model.hop_length)
    return _mel_conditioner(noisy, PARAMS["n_fft"], model.hop_length, model.n_specs)


def conditioner_route(model, mode: str = "auto") -> str:
    """Where the conditioner of ``mode`` for ``model`` is computed, in
    words."""
    mode = _mode(model, mode)
    n_fft, hop = PARAMS["n_fft"], model.hop_length
    if mode == "stft":
        if fused_stft.supports(n_fft, hop, "none"):
            where = ("K4 (csrc/stft.cu)" if next(model.parameters()).is_cuda
                     else "K4's wrapper, which takes its plain version for CPU tensors")
            return f"stft: |STFT| at n_fft {n_fft}, hop {hop} through {where}"
        return (f"stft: |STFT| at n_fft {n_fft}, hop {hop} through ops/stft.py (K4 does not "
                f"take this geometry)")
    if mode == "se":
        return (f"se: make_spectrum at n_fft {(model.n_specs - 1) * 2}, hop {hop} on the "
                f"host")
    return f"mel: {model.n_specs} mels at n_fft {n_fft}, hop {hop} on the host"


def predict(noisy_signal: np.ndarray, model_dir: str, fast: bool = False, seed: int = 23,
            conditioner: str = "auto", noises=None, plain: bool = False,
            device=None) -> np.ndarray:
    """One utterance enhanced: the sampler from the noisy signal on the
    checkpoint's schedules (the 6-step fast one with ``fast``), framed at
    the model's hop, cut to the input's length.  The draws come from a
    generator seeded ``seed``, or from ``noises`` (one per step, the shape
    of the audio buffer ``[1, hop * frames]``); ``plain`` takes
    ``ops/stft.py`` for the ``stft`` conditioner."""
    device = resolve_device(device)
    model, params = load_model(model_dir, device)
    schedule = inference_schedule(
        np.asarray(params.get("noise_schedule", NOISE_SCHEDULE), np.float64),
        np.asarray(params.get("inference_noise_schedule", INFERENCE_NOISE_SCHEDULE),
                   np.float64), fast=fast)
    x = torch.from_numpy(np.asarray(noisy_signal, np.float32)[None]).to(device)
    cond = _conditioner_for(model, np.asarray(noisy_signal), conditioner)
    generator = torch.Generator(device=device).manual_seed(seed)
    audio = sample_waveform(model, x, schedule, generator, hop=model.hop_length,
                            n_fft=PARAMS["n_fft"], clamp_every_step=True, conditioner=cond,
                            noises=noises, plain=plain)
    return audio[0].cpu().numpy()[:len(noisy_signal)]


def main(argv=None) -> list[tuple[str, np.ndarray]]:
    """Enhance ``--noisy``; returns ``(output path, estimate)`` per file."""
    parser = argparse.ArgumentParser(description="CDiffuSE inference")
    parser.add_argument("--model-dir", required=True)
    parser.add_argument("--noisy", required=True, help="noisy wav file or directory")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--conditioner", default="auto", choices=["auto", "stft", "se", "mel"],
                        help="conditioner featurization (auto: from the checkpoint's widths: "
                             "|STFT| / se log1p spectrogram / mel)")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without a card)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model, _ = load_model(args.model_dir, device)
    print(f"conditioner {conditioner_route(model, args.conditioner)}; device {device}")
    paths = (sorted(glob(f"{args.noisy}/*.wav")) if os.path.isdir(args.noisy)
             else [args.noisy])
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for p in paths:
        noisy, sr = load_wav(p, 16000)
        est = predict(noisy, args.model_dir, fast=args.fast, conditioner=args.conditioner,
                      device=device)
        save_wav(out_dir / Path(p).name, est, sr)
        print(f"enhanced {p} -> {out_dir / Path(p).name}")
        results.append((str(out_dir / Path(p).name), est))
    return results


if __name__ == "__main__":
    main()
