"""Diffusion training entry point, archs 'diffuse' (waveform DiffuSE) and
'tsc-diffuse' (spectrogram diffusion TSCNet) (port of
speech_enhancement_tpu/cli/main_diffuse.py).

The same flags and defaults: the model from the config (``DiffuSE`` from
``RESIDUAL_*``, ``DILATION_CYCLE_LENGTH``, ``HOP_SAMPLES`` and
``N_SPECS``, or ``DiffusionTSCNet(64, N_FFT // 2 + 1)``, each with
``len(NOISE_SCHEDULE)`` steps), the config's crops, the cyclic cosine
schedule and the four optimizers, ``--compute-dtype bfloat16``,
``--resume auto`` and ``--init-from``, a non-finite loss raising, the
validation loss with the best checkpoint, and an emergency checkpoint on
SIGTERM/SIGINT.  Step ``idx`` of epoch ``epoch`` takes its seed from
``(seed, epoch, idx)`` only (validation batches continue the count), so
that a resumed run draws what a run straight through drew; the epoch and
the best loss are part of the checkpoint, so ``--resume auto`` starts at
the epoch after the saved one.  Every validation utterance counts (the
tail batch is kept, not dropped).  One process trains on one device:
``--device`` (default ``cuda``; ``cpu`` runs on the CPU); the
data-parallel flags (``--n-devices``, ``--coordinator``,
``--num-processes``, ``--process-id``) take one process on one device
only.  ``--debug`` turns on autograd's anomaly detection.

Usage:
  python -m speech_enhancement_tpu_torch.cli.main_diffuse -a tsc-diffuse \\
      --cfg speech_enhancement_tpu_torch/config/baseline.yaml --output out --epochs 100
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from speech_enhancement_tpu_torch.config import get_config
from speech_enhancement_tpu_torch.data import Collator, DataLoader, VoicebankDataset
from speech_enhancement_tpu_torch.models import DiffuSE, DiffusionTSCNet
from speech_enhancement_tpu_torch.train import (
    ModuleState,
    build_criterion,
    build_optimizer,
    cyclic_cosine_schedule,
    diffuse_step,
    tsc_diffusion_step,
)
from speech_enhancement_tpu_torch.train.loop import step_seed
from speech_enhancement_tpu_torch.utils import (
    AverageMeter,
    PreemptionGuard,
    create_logger,
    latest_checkpoint,
    load_checkpoint,
    load_variables,
    save_checkpoint,
)
from speech_enhancement_tpu_torch.utils.device import resolve_device

MODEL_NAMES = ["diffuse", "tsc-diffuse"]


def parse_option(argv=None):
    parser = argparse.ArgumentParser(description="diffusion training")
    parser.add_argument("-a", "--arch", default="diffuse", choices=MODEL_NAMES)
    parser.add_argument("--output", default="output", type=str)
    parser.add_argument("--tag", default=None)
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("-j", "--workers", default=8, type=int)
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("--start-epoch", default=0, type=int)
    parser.add_argument("-b", "--batch-size", default=None, type=int)
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--wd", "--weight-decay", default=0.01, type=float,
                        dest="weight_decay")
    parser.add_argument("--max-norm", default=0.0, type=float)
    parser.add_argument("-p", "--print-freq", default=10, type=int)
    parser.add_argument("--resume", default="", type=str,
                        help="a checkpoint directory, or 'auto' for the latest under the "
                             "output directory: restores the full training state")
    parser.add_argument("--init-from", default="", type=str,
                        help="a checkpoint directory whose variables.pt seeds the model "
                             "weights; the optimizer, epoch counter and best loss start fresh")
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw", "lars", "lamb"])
    parser.add_argument("--criterion", default="l1", choices=["mae", "l1", "mse", "l2"])
    parser.add_argument("--crop-len", default=1, type=int)
    parser.add_argument("--comp-type", default="pow", choices=["norm", "log", "pow", "none"])
    parser.add_argument("--compute-dtype", default=None, choices=[None, "bfloat16"],
                        help="bf16 model compute on fp32 master parameters; the STFTs, "
                             "noising and loss stay fp32")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without a card)")
    parser.add_argument("--debug", action="store_true",
                        help="autograd anomaly detection (the op that made a NaN raises)")
    parser.add_argument("--n-devices", default=None, type=int)
    parser.add_argument("--coordinator", default=None, type=str)
    parser.add_argument("--num-processes", default=None, type=int)
    parser.add_argument("--process-id", default=None, type=int)
    args = parser.parse_args(argv)
    if args.init_from and args.resume:
        parser.error("--init-from and --resume are mutually exclusive: one seeds weights "
                     "only, the other restores the full training state")
    if (args.n_devices not in (None, 1) or args.num_processes not in (None, 1)
            or args.process_id not in (None, 0) or args.coordinator):
        parser.error("data-parallel training is not ported yet: one process trains on one "
                     "device (--n-devices 1, --num-processes 1, --process-id 0, no "
                     "--coordinator)")
    config = get_config(args)
    return args, config


def build_model(args, config, device=None) -> torch.nn.Module:
    """The arch's model from the config (``cli/main_diffuse.py:101-116``),
    seeded weights on ``device``."""
    generator = torch.Generator().manual_seed(getattr(args, "seed", None) or 0)
    if args.arch == "diffuse":
        return DiffuSE(dilation_cycle_length=config.DILATION_CYCLE_LENGTH,
                       hop_length=config.HOP_SAMPLES, n_specs=config.N_SPECS,
                       num_steps=len(config.NOISE_SCHEDULE),
                       residual_channels=config.RESIDUAL_CHANNELS,
                       residual_layers=config.RESIDUAL_LAYERS, device=device,
                       generator=generator)
    return DiffusionTSCNet(64, config.N_FFT // 2 + 1, len(config.NOISE_SCHEDULE),
                           device=device, generator=generator)


def main(argv=None) -> list[dict]:
    """Train; returns one record per epoch run: ``{"epoch", "train_losses"
    (each step's), "train_loss", "valid_loss", "is_best"}``."""
    args, config = parse_option(argv)
    device = resolve_device(args.device)
    seed = args.seed or 0
    logger = create_logger(config.OUTPUT, dist_rank=0, name=args.arch)
    logger.info(f"device: {device}, arch: {args.arch}")

    model = build_model(args, config, device)
    criterion = build_criterion(args.criterion)
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else None
    noise_schedule = np.asarray(config.NOISE_SCHEDULE, np.float32)

    train_ds = VoicebankDataset(config.DATA.TRAIN_CLEAN_DIR, config.DATA.TRAIN_NOISY_DIR,
                                config.HOP_SAMPLES, config.CROP_FRAMES)
    valid_ds = VoicebankDataset(config.DATA.TEST_CLEAN_DIR, config.DATA.TEST_NOISY_DIR,
                                config.HOP_SAMPLES, config.CROP_FRAMES)

    def collator():
        return Collator(config.HOP_SAMPLES, config.CROP_FRAMES, config.CROP_LEN,
                        rng=np.random.default_rng(args.seed))

    train_loader = DataLoader(train_ds, config.DATA.BATCH_SIZE, collator(), shuffle=True,
                              seed=seed, num_workers=args.workers)
    valid_loader = DataLoader(valid_ds, config.DATA.BATCH_SIZE, collator(), shuffle=False,
                              num_workers=args.workers, drop_last=False)

    iters_per_epoch = max(len(train_loader), 1)
    sched = config.TRAIN.SCHEDULER
    lr = cyclic_cosine_schedule(sched.LR, sched.EPOCHS, iters_per_epoch, sched.CYCLE_LIMIT,
                                sched.WARMUP_EPOCHS)
    state = ModuleState(model, build_optimizer(args.optimizer, lr, model, args.momentum,
                                               args.weight_decay, args.max_norm))

    start_epoch = args.start_epoch
    if args.init_from:
        model.load_state_dict(load_variables(args.init_from)["model"])
        logger.info(f"=> model weights initialized from {args.init_from} "
                    "(fresh optimizer, epoch 0)")
    if args.resume:
        path = latest_checkpoint(config.OUTPUT) if args.resume == "auto" else args.resume
        if path:
            state.load_state_dict(load_checkpoint(path))
            start_epoch = state.epoch
            logger.info(f"=> resumed from {path} (epoch {start_epoch})")

    def run_step(clean, noisy, step_seed_, train):
        clean, noisy = (torch.from_numpy(a).to(device) for a in (clean, noisy))
        if args.arch == "diffuse":
            return diffuse_step(state, clean, noisy, noise_schedule, step_seed_,
                                criterion=criterion, n_fft=config.N_FFT, hop=config.HOP_SAMPLES,
                                train=train, compute_dtype=compute_dtype)
        return tsc_diffusion_step(state, clean, noisy, noise_schedule, step_seed_,
                                  comp_type=args.comp_type, n_fft=config.N_FFT,
                                  hop=config.HOP_SAMPLES, train=train,
                                  compute_dtype=compute_dtype)

    history = []
    guard = PreemptionGuard()
    try:
        with torch.autograd.set_detect_anomaly(args.debug):
            for epoch in range(start_epoch, args.epochs):
                train_loader.set_epoch(epoch)
                meter, batch_meter, losses = AverageMeter(), AverageMeter(), []
                t_end = time.time()
                idx = -1
                for idx, batch in enumerate(train_loader):
                    b = batch.audio.shape[0]
                    if b == 0:
                        continue
                    loss = float(run_step(batch.audio, batch.noisy,
                                          step_seed(seed, epoch, idx), True))
                    if not np.isfinite(loss):
                        raise RuntimeError(f"Detected NaN loss at step {idx}.")
                    losses.append(loss)
                    meter.update(loss, b)
                    batch_meter.update(time.time() - t_end)
                    t_end = time.time()
                    if guard.should_stop:
                        state.epoch = epoch  # the interrupted epoch runs again on resume
                        save_checkpoint(state.state_dict(), config.OUTPUT, epoch)
                        logger.info(f"=> preemption checkpoint_{epoch:04d} saved; resume "
                                    "with --resume auto")
                        return history
                    if idx % args.print_freq == 0:
                        logger.info(f"Train: [{epoch}/{args.epochs}][{idx}/{iters_per_epoch}]"
                                    f"\ttime {batch_meter.val:.4f} ({batch_meter.avg:.4f})\t"
                                    f"loss {meter}")

                vmeter = AverageMeter()
                for vidx, batch in enumerate(valid_loader, start=idx + 1):
                    b = batch.audio.shape[0]
                    if b == 0:
                        continue
                    vmeter.update(float(run_step(batch.audio, batch.noisy,
                                                 step_seed(seed, epoch, vidx), False)), b)

                is_best = vmeter.avg <= state.best_loss
                state.best_loss = min(vmeter.avg, state.best_loss)
                state.epoch = epoch + 1
                save_checkpoint(state.state_dict(), config.OUTPUT, epoch, is_best,
                                variables=state.variables())
                logger.info(f"=> saved checkpoint_{epoch:04d} (best={is_best})")
                logger.info(f"Train Loss {meter.avg:.4f}  Valid Loss {vmeter.avg:.4f}")
                history.append({"epoch": epoch, "train_losses": losses,
                                "train_loss": meter.avg, "valid_loss": vmeter.avg,
                                "is_best": is_best})
        return history
    finally:
        guard.restore()


if __name__ == "__main__":
    main()
