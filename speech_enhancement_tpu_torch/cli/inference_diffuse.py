"""Diffusion inference: reverse sampling of a test directory and its six
metrics (port of speech_enhancement_tpu/cli/inference_diffuse.py).

Loads the arch's model (``cli.main_diffuse.build_model``) with the weights
of a checkpoint's ``variables.pt``, samples every noisy wav of the test
directory in length-sorted chunks of ``--sampler-batch`` utterances
(length buckets of about 0.5 s; ``--sampler-batch 1`` samples each
utterance alone, as the reference does), and reports PESQ, CSIG, CBAK,
COVL, SSNR and STOI averaged over the files; ``--fast`` takes the 6-step
``INFERENCE_NOISE_SCHEDULE``, ``--save`` writes the enhanced wavs,
``--validate-epochs`` sweeps the checkpoints of a run directory and names
the best epoch by PESQ.  Clean and noisy files are paired by basename.
Each chunk draws its reverse steps' noise from its own generator, seeded
from (23, chunk index).  On a card the samplers' STFTs and iSTFTs run
through K4 and K5.  ``--device`` defaults to ``cuda``.

Usage:
  python -m speech_enhancement_tpu_torch.cli.inference_diffuse -a tsc-diffuse \\
      --cfg speech_enhancement_tpu_torch/config/baseline.yaml \\
      -m out/tsc-diffuse/default/model_best -o enhanced --fast
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from pathlib import Path

import numpy as np
import torch

from speech_enhancement_tpu_torch.cli.main_diffuse import build_model
from speech_enhancement_tpu_torch.config import get_config
from speech_enhancement_tpu_torch.data import load_wav, save_wav
from speech_enhancement_tpu_torch.enhance import round_to_bucket, wrap_pad
from speech_enhancement_tpu_torch.metrics import compute_metrics
from speech_enhancement_tpu_torch.train import inference_schedule, sample_tsc, sample_waveform
from speech_enhancement_tpu_torch.utils import load_variables, sweep_checkpoints
from speech_enhancement_tpu_torch.utils.device import resolve_device

MODEL_NAMES = ["diffuse", "tsc-diffuse"]


def parse_option(argv=None):
    parser = argparse.ArgumentParser(description="diffusion inference")
    parser.add_argument("-a", "--arch", default="diffuse", choices=MODEL_NAMES)
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--validate-epochs", action="store_true")
    parser.add_argument("--start", default=None, type=int)
    parser.add_argument("--end", default=None, type=int)
    parser.add_argument("--comp-type", default="pow", choices=["norm", "log", "pow", "none"])
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--seed", default=0, type=int,
                        help="seed of the model's initial weights (replaced by the "
                             "checkpoint's)")
    parser.add_argument("--sampler-batch", default=8, type=int,
                        help="utterances sampled together (length-bucketed); 1 samples each "
                             "utterance alone with exact hop-multiple padding")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without a card)")
    parser.add_argument("--opts", default=None, nargs="+")
    args = parser.parse_args(argv)
    config = get_config(args)
    return args, config


def load_model(model_path: str, args, config, device=None) -> torch.nn.Module:
    """The arch's model with the weights of checkpoint directory
    ``model_path``."""
    model = build_model(args, config, device)
    model.load_state_dict(load_variables(model_path)["model"])
    return model


def _rms_gain(signal: np.ndarray) -> float:
    """Per-utterance RMS gain ``sqrt(T / sum(x^2))``, 1 for a silent
    utterance (the reference's unguarded gain is inf there, and its NaN
    would poison the whole sampled chunk)."""
    energy = float(np.sum(np.asarray(signal) ** 2.0))
    return float(np.sqrt(len(signal) / energy)) if energy > 0 else 1.0


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def predict(model, args, config, noisy_signal: np.ndarray, schedule, seed: int,
            device=None) -> np.ndarray:
    """One utterance with the reference's padding and normalization
    (``inference_diffuse.py:82-100``): the waveform model takes the raw
    signal (the sampler frames it to ``floor(L / hop)``); the TSCNet takes it
    RMS-normalized and wrap-padded to a hop multiple."""
    device = resolve_device(device)
    hop, length = config.HOP_SAMPLES, len(noisy_signal)
    if args.arch.startswith("diffuse"):
        x = torch.from_numpy(np.asarray(noisy_signal, np.float32)[None]).to(device)
        audio = sample_waveform(model, x, schedule, _generator(seed, device), hop=hop,
                                n_fft=config.N_FFT)
        return audio[0].cpu().numpy()[:length]
    c = _rms_gain(noisy_signal)
    padded = ((length + hop - 1) // hop) * hop
    x = torch.from_numpy(wrap_pad(np.asarray(noisy_signal * c, np.float32), padded)[None])
    audio = sample_tsc(model, x.to(device), schedule, _generator(seed, device),
                       n_fft=config.N_FFT, hop=hop, comp_type=args.comp_type)
    return (audio[0].cpu().numpy() / c)[:length]


def predict_batch(model, args, config, signals: list, schedule, seed: int,
                  device=None) -> list[np.ndarray]:
    """A chunk of utterances sampled together (``inference_diffuse.py:
    103-145``): the math of :func:`predict` per utterance on signals padded
    to a common bucket (multiples of ``max(hop, 8000 - 8000 % hop)``
    samples).  With ``--sampler-batch 1`` a singleton chunk is
    :func:`predict` exactly."""
    device = resolve_device(device)
    hop = config.HOP_SAMPLES
    lengths = [len(s) for s in signals]
    if len(signals) == 1 and args.sampler_batch == 1:
        return [predict(model, args, config, signals[0], schedule, seed, device)]
    bucket = round_to_bucket(max(lengths), quantum=max(hop, 8000 - 8000 % hop), hop=hop)
    generator = _generator(seed, device)
    if args.arch.startswith("diffuse"):
        # the sampler zero-fills past each utterance: a common length only
        x = np.stack([np.pad(np.asarray(s, np.float32), (0, bucket - len(s))) for s in signals])
        audio = sample_waveform(model, torch.from_numpy(x).to(device), schedule, generator,
                                hop=hop, n_fft=config.N_FFT).cpu().numpy()
        return [audio[i][:n] for i, n in enumerate(lengths)]
    gains = [_rms_gain(s) for s in signals]
    x = np.stack([wrap_pad(np.asarray(s, np.float32) * c, bucket) for s, c in zip(signals, gains)])
    audio = sample_tsc(model, torch.from_numpy(x).to(device), schedule, generator,
                       n_fft=config.N_FFT, hop=hop, comp_type=args.comp_type).cpu().numpy()
    return [(audio[i] / gains[i])[:n] for i, n in enumerate(lengths)]


def chunk_seed(index: int) -> int:
    """The seed of the ``index``-th chunk's generator: a function of (23,
    index) only."""
    return int(np.random.SeedSequence((23, index)).generate_state(1)[0])


def inference(args, config, model_path: str, data_paths: list) -> np.ndarray:
    """The six metrics summed over ``data_paths``."""
    device = resolve_device(args.device)
    model = load_model(model_path, args, config, device)
    schedule = inference_schedule(config.NOISE_SCHEDULE, config.INFERENCE_NOISE_SCHEDULE,
                                  fast=args.fast)
    noisies, cleans = [], []
    for path in data_paths:
        clean_path = os.path.join(config.DATA.TEST_CLEAN_DIR, os.path.basename(path))
        noisies.append(load_wav(path, config.SAMPLE_RATE)[0])
        cleans.append(load_wav(clean_path, config.SAMPLE_RATE)[0])

    # length-sorted chunks (a stable sort): which draws an utterance gets
    # follows the sorted order, not the file order
    chunk_size = max(1, args.sampler_batch)
    order = sorted(range(len(noisies)), key=lambda i: len(noisies[i]))
    ests: list = [None] * len(noisies)
    for k, i in enumerate(range(0, len(order), chunk_size)):
        chunk = order[i:i + chunk_size]
        outs = predict_batch(model, args, config, [noisies[j] for j in chunk], schedule,
                             chunk_seed(k), device)
        for j, est in zip(chunk, outs):
            ests[j] = est

    metrics_total = np.zeros(6)
    out_dir = Path(args.output) / Path(data_paths[0]).parent.name
    if args.save:
        out_dir.mkdir(parents=True, exist_ok=True)
    for path, clean, est in zip(data_paths, cleans, ests):
        metrics_total += np.array(compute_metrics(clean, est, config.SAMPLE_RATE, 0))
        if args.save:
            save_wav(out_dir / Path(path).name, est, config.SAMPLE_RATE)
    return metrics_total


def _report(m):
    print(f"pesq: {m[0]:.3f}\t csig: {m[1]:.3f}\t cbak: {m[2]:.3f}\t "
          f"covl: {m[3]:.3f}\t ssnr: {m[4]:.3f}\t stoi: {m[5]:.3f}")


def main(argv=None):
    """Returns the averaged metrics, or with ``--validate-epochs`` a list of
    ``(epoch, metrics)``."""
    args, config = parse_option(argv)
    data_paths = sorted(glob(f"{config.DATA.TEST_NOISY_DIR}/*.wav"))
    num = len(data_paths)
    if num == 0:
        raise SystemExit(f"no test wavs in {config.DATA.TEST_NOISY_DIR}")
    if not args.validate_epochs:
        m = inference(args, config, args.model_path, data_paths) / num
        _report(m)
        return m
    epochs = sweep_checkpoints(args.model_path, args.start, args.end)
    if not epochs:
        raise SystemExit(f"no restorable checkpoint_*/variables.pt under {args.model_path} "
                         "in the requested range")
    best_pesq, best_epoch, results = 0.0, 0, []
    for epoch, ckpt in epochs:
        m = inference(args, config, str(ckpt), data_paths) / num
        print(f"Epoch: {epoch}")
        _report(m)
        results.append((epoch, m))
        if m[0] > best_pesq:
            best_pesq, best_epoch = m[0], epoch
    print(f"Best epoch: {best_epoch}\t best PESQ: {best_pesq}")
    return results


if __name__ == "__main__":
    main()
