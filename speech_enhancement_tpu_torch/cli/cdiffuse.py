"""Standalone CDiffuSE trainer (port of speech_enhancement_tpu/cli/cdiffuse.py).

Usage:
  python -m speech_enhancement_tpu_torch.cli.cdiffuse <model_dir> <clean_dir> \\
      <noisy_dir> [--max-steps N] [--batch-size 16] [--lr 2e-4] [--seed 0] [-j 4] \\
      [--device cuda]

Step-granular training (``train.learner.DiffuSELearner``) of the upstream
DiffuSE variant (no GroupNorm) at ``PARAMS``: 64 channels, 30 layers,
dilation cycle 10, 201 conditioner bins at hop 100, 160-frame (1 s) crops
at batch 16, Adam at lr 2e-4, the L1 loss and a linear schedule of 50
steps from 1e-4 to 0.035.  A run in an existing ``model_dir`` resumes from
its ``weights/`` (model, optimizer, step) and continues the data and the
draws of the run it restores.  One process trains on one device:
``--device`` (default ``cuda``, raising without a card; ``cpu`` runs on the
CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from speech_enhancement_tpu_torch.data import Collator, DataLoader, VoicebankDataset
from speech_enhancement_tpu_torch.models import DiffuSE
from speech_enhancement_tpu_torch.train import ModuleState, build_criterion
from speech_enhancement_tpu_torch.train.learner import DiffuSELearner
from speech_enhancement_tpu_torch.utils import create_logger
from speech_enhancement_tpu_torch.utils.device import resolve_device

PARAMS = dict(
    batch_size=16,
    learning_rate=2e-4,
    sample_rate=16000,
    n_specs=201,
    n_fft=400,
    hop_samples=100,
    crop_mel_frames=160,
    residual_layers=30,
    residual_channels=64,
    dilation_cycle_length=10,
)


def parse_option(argv=None):
    parser = argparse.ArgumentParser(description="train (or resume) CDiffuSE")
    parser.add_argument("model_dir")
    parser.add_argument("clean_dir")
    parser.add_argument("noisy_dir")
    parser.add_argument("--max-steps", default=None, type=int)
    parser.add_argument("--batch-size", default=PARAMS["batch_size"], type=int)
    parser.add_argument("--lr", default=PARAMS["learning_rate"], type=float)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("-j", "--workers", default=4, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without a card)")
    return parser.parse_args(argv)


def main(argv=None) -> DiffuSELearner:
    """Train (or resume) to ``--max-steps``; returns the learner."""
    args = parse_option(argv)
    device = resolve_device(args.device)
    logger = create_logger(args.model_dir, name="cdiffuse")
    noise_schedule = np.linspace(1e-4, 0.035, 50)
    model = DiffuSE(dilation_cycle_length=PARAMS["dilation_cycle_length"],
                    hop_length=PARAMS["hop_samples"], n_specs=PARAMS["n_specs"],
                    num_steps=len(noise_schedule),
                    residual_channels=PARAMS["residual_channels"],
                    residual_layers=PARAMS["residual_layers"], use_groupnorm=False,
                    device=device, generator=torch.Generator().manual_seed(args.seed))
    state = ModuleState(model, torch.optim.Adam(model.parameters(), lr=args.lr))
    dataset = VoicebankDataset(args.clean_dir, args.noisy_dir, PARAMS["hop_samples"],
                               PARAMS["crop_mel_frames"])
    loader = DataLoader(dataset, args.batch_size,
                        Collator(PARAMS["hop_samples"], PARAMS["crop_mel_frames"],
                                 rng=np.random.default_rng(args.seed), silence_check=False),
                        shuffle=True, seed=args.seed, num_workers=args.workers)
    learner = DiffuSELearner(args.model_dir, state, loader, noise_schedule,
                             build_criterion("l1"), n_fft=PARAMS["n_fft"],
                             hop=PARAMS["hop_samples"], logger=logger)
    if learner.restore_from_checkpoint():
        logger.info(f"resumed from {args.model_dir}/weights at step {learner.step}")
    learner.train(max_steps=args.max_steps, rng_seed=args.seed)
    learner.save_to_checkpoint()
    return learner


if __name__ == "__main__":
    main()
