"""GAN enhancement inference and metric evaluation entry point (port of
speech_enhancement_tpu/cli/inference_gan.py).

Loads the generator from a checkpoint's ``variables.pt``, enhances every
noisy wav of the test directory with the batched, length-bucketed
``Enhancer``, and reports the six metrics (PESQ, CSIG, CBAK, COVL, SSNR,
STOI) averaged over the files; ``--save`` writes the enhanced wavs,
``--validate-epochs`` sweeps the checkpoints of a run directory and names
the best epoch by PESQ.  Clean and noisy files are paired by basename.
``--fused-attention`` (``auto``: on when the device is ``cuda``) routes
the time conformers' attention through K1 and the featurization through
K4 and K5.  ``--n-devices n`` splits every batch over n model replicas
(``Enhancer(devices=...)``), as the JAX CLI's mesh does.

Usage:
  python -m speech_enhancement_tpu_torch.cli.inference_gan \\
      --cfg speech_enhancement_tpu_torch/config/scp.yaml -m out/scp/default/model_best -o enhanced
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from pathlib import Path

import numpy as np
import torch

from speech_enhancement_tpu_torch.config import get_config
from speech_enhancement_tpu_torch.data import load_wav, save_wav
from speech_enhancement_tpu_torch.enhance import Enhancer
from speech_enhancement_tpu_torch.metrics import compute_metrics
from speech_enhancement_tpu_torch.models import TSCNet
from speech_enhancement_tpu_torch.parallel import rank_device
from speech_enhancement_tpu_torch.utils import load_variables, sweep_checkpoints
from speech_enhancement_tpu_torch.utils.device import resolve_device


def parse_option(argv=None):
    parser = argparse.ArgumentParser(description="enhancement inference")
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--validate-epochs", action="store_true")
    parser.add_argument("--start", default=None, type=int)
    parser.add_argument("--end", default=None, type=int)
    parser.add_argument("--batch-size", default=32, type=int)
    parser.add_argument("--fused-attention", default="auto", choices=["auto", "on", "off"],
                        help="the kernels' route (K1 attention, K4/K5 featurization); "
                             "'auto' = on for a CUDA device")
    parser.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                        help="serving compute dtype")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without a card)")
    parser.add_argument("--n-devices", default=None, type=int,
                        help="split each enhancement batch over this many devices, one "
                             "model replica each: the host's cards in turn (two replicas "
                             "share a card when there are more than cards; with --device "
                             "cpu all on the CPU); default one device")
    parser.add_argument("--opts", default=None, nargs="+")
    args = parser.parse_args(argv)
    config = get_config(args)
    return args, config


def _use_fused(mode: str, device: torch.device) -> bool:
    if mode == "auto":
        return device.type == "cuda"
    return mode == "on"


def load_model(model_path: str, config, fused: bool = False, device=None) -> TSCNet:
    """A ``TSCNet(64, N_FFT // 2 + 1)`` with the generator weights of
    checkpoint directory ``model_path``.  ``fused`` changes the attention's
    route only: every checkpoint loads either way."""
    gen = TSCNet(64, config.N_FFT // 2 + 1, fused_attention=fused, device=device)
    gen.load_state_dict(load_variables(model_path)["gen"])
    return gen


def inference(args, config, model_path, data_paths) -> np.ndarray:
    """The six metrics summed over ``data_paths``."""
    device = resolve_device(args.device)
    fused = _use_fused(args.fused_attention, device)
    gen = load_model(model_path, config, fused=fused, device=device)
    placement = dict(device=device)
    if args.n_devices and args.n_devices > 1:
        placement = dict(devices=[rank_device(args.device, i) for i in range(args.n_devices)])
    enhancer = Enhancer(gen, config.N_FFT, config.HOP_SAMPLES,
                        compute_dtype=torch.bfloat16 if args.precision == "bf16" else None,
                        fused_stft=fused, **placement)
    noisy_sigs, clean_sigs = [], []
    for noisy_path in data_paths:
        clean_path = os.path.join(config.DATA.TEST_CLEAN_DIR, os.path.basename(noisy_path))
        noisy_sigs.append(load_wav(noisy_path, config.SAMPLE_RATE)[0])
        clean_sigs.append(load_wav(clean_path, config.SAMPLE_RATE)[0])

    enhanced = enhancer.enhance(noisy_sigs, batch_size=args.batch_size)

    metrics_total = np.zeros(6)
    out_dir = Path(args.output) / Path(data_paths[0]).parent.name
    if args.save:
        out_dir.mkdir(parents=True, exist_ok=True)
    for path, clean, est in zip(data_paths, clean_sigs, enhanced):
        metrics_total += np.array(compute_metrics(clean, est, config.SAMPLE_RATE, 0))
        if args.save:
            save_wav(out_dir / Path(path).name, est, config.SAMPLE_RATE)
    return metrics_total


def _report(metrics_avg):
    print(f"pesq: {metrics_avg[0]:.3f}\t csig: {metrics_avg[1]:.3f}\t "
          f"cbak: {metrics_avg[2]:.3f}\t covl: {metrics_avg[3]:.3f}\t "
          f"ssnr: {metrics_avg[4]:.3f}\t stoi: {metrics_avg[5]:.3f}")


def main(argv=None):
    """Returns the averaged metrics, or with ``--validate-epochs`` a list of
    ``(epoch, metrics)``."""
    args, config = parse_option(argv)
    data_paths = sorted(glob(f"{config.DATA.TEST_NOISY_DIR}/*.wav"))
    num = len(data_paths)
    if num == 0:
        raise SystemExit(f"no test wavs in {config.DATA.TEST_NOISY_DIR}")

    if not args.validate_epochs:
        metrics_avg = inference(args, config, args.model_path, data_paths) / num
        _report(metrics_avg)
        return metrics_avg
    epochs = sweep_checkpoints(args.model_path, args.start, args.end)
    if not epochs:
        raise SystemExit(f"no restorable checkpoint_*/variables.pt under {args.model_path} "
                         "in the requested range")
    best_pesq, best_epoch, results = 0.0, 0, []
    for epoch, ckpt in epochs:
        metrics_avg = inference(args, config, str(ckpt), data_paths) / num
        print(f"Epoch: {epoch}")
        _report(metrics_avg)
        results.append((epoch, metrics_avg))
        if metrics_avg[0] > best_pesq:
            best_pesq, best_epoch = metrics_avg[0], epoch
    print(f"Best epoch: {best_epoch}\t best PESQ: {best_pesq}")
    return results


if __name__ == "__main__":
    main()
