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
tail batch is kept, not dropped).  ``--device`` (default ``cuda``;
``cpu`` runs on the CPU).  ``--debug`` turns on autograd's anomaly
detection.

Data parallel: ``--n-devices n`` or ``--num-processes P`` (with
``--process-id`` and ``--coordinator`` for ranks started by hand) run one
rank per device, with the JAX run's global batch on the same flags
(``parallel/launch.py``), as ``cli/main_gan.py`` does: each rank trains on
its shard of the files and averages its gradients with the others'
(``train/diffusion.py``), a batch whose rows differ between the ranks is
skipped by all, validation splits every global batch over the ranks and
sums the losses' row sums, rank 0 writes the checkpoints, and a resumed or
``--init-from`` state is broadcast from rank 0.

Usage:
  python -m speech_enhancement_tpu_torch.cli.main_diffuse -a tsc-diffuse \\
      --cfg speech_enhancement_tpu_torch/config/baseline.yaml --output out --epochs 100
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from speech_enhancement_tpu_torch.config import get_config
from speech_enhancement_tpu_torch.data import Collator, DataLoader, VoicebankDataset
from speech_enhancement_tpu_torch.models import DiffuSE, DiffusionTSCNet
from speech_enhancement_tpu_torch.parallel import (
    any_rank,
    barrier,
    broadcast_state_,
    check_replicas,
    destroy,
    host_sum,
    init_distributed,
    launch,
    rank_device,
    same_on_all_ranks,
    shard_rows,
    spawn,
)
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
    launch.add_arguments(parser)
    args = parser.parse_args(argv)
    if args.init_from and args.resume:
        parser.error("--init-from and --resume are mutually exclusive: one seeds weights "
                     "only, the other restores the full training state")
    config = get_config(args)
    try:
        args.world, args.rank_batch = launch.layout(args, config.DATA.BATCH_SIZE)
    except ValueError as exc:
        parser.error(str(exc))
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


def _rank_main(process_id: int, world: int, coordinator: str, argv: list[str]):
    return main(launch.rank_argv(argv, process_id, coordinator))


def main(argv=None) -> list[dict]:
    """Train; returns one record per epoch run: ``{"epoch", "train_losses"
    (each step's), "train_loss", "valid_loss", "is_best"}`` (rank 0's, when
    this call started the ranks)."""
    args, config = parse_option(argv)
    if args.world > 1 and args.process_id is None:
        return spawn(_rank_main, args.world, list(sys.argv[1:] if argv is None else argv))
    rank = args.process_id or 0
    device = rank_device(args.device, rank) if args.world > 1 else resolve_device(args.device)
    backend = init_distributed(args.coordinator, args.world, rank, device)
    try:
        return train(args, config, device, rank, backend)
    finally:
        if backend is not None:
            destroy()


def train(args, config, device: torch.device, rank: int, backend: str | None) -> list[dict]:
    """The body of :func:`main` on this rank's ``device``."""
    seed = args.seed or 0
    logger = create_logger(config.OUTPUT, dist_rank=rank, name=args.arch)
    logger.info(f"device: {device}, arch: {args.arch}, ranks: {args.world} "
                f"({backend or 'one process'}), {args.rank_batch} rows a rank")

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

    # each rank trains on its shard of the files and validates its rows of
    # every global batch
    train_loader = DataLoader(train_ds, args.rank_batch, collator(), shuffle=True,
                              seed=seed, shard_id=rank, num_shards=args.world,
                              num_workers=args.workers)
    valid_loader = DataLoader(valid_ds, args.rank_batch * args.world, collator(),
                              shuffle=False, num_workers=args.workers, drop_last=False)

    iters_per_epoch = max(len(train_loader), 1)
    sched = config.TRAIN.SCHEDULER
    lr = cyclic_cosine_schedule(sched.LR, sched.EPOCHS, iters_per_epoch, sched.CYCLE_LIMIT,
                                sched.WARMUP_EPOCHS)
    state = ModuleState(model, build_optimizer(args.optimizer, lr, model, args.momentum,
                                               args.weight_decay, args.max_norm))

    state.epoch = args.start_epoch
    if args.init_from:
        model.load_state_dict(load_variables(args.init_from)["model"])
        logger.info(f"=> model weights initialized from {args.init_from} "
                    "(fresh optimizer, epoch 0)")
    if args.resume:
        path = latest_checkpoint(config.OUTPUT) if args.resume == "auto" else args.resume
        if path:
            state.load_state_dict(load_checkpoint(path))
            logger.info(f"=> resumed from {path} (epoch {state.epoch})")
    # every rank starts from rank 0's weights, optimizer state and counters
    broadcast_state_(state)
    barrier()
    start_epoch = state.epoch

    def checkpoint(epoch: int, **kw):
        """Rank 0 writes, every rank waits for it."""
        if rank == 0:
            save_checkpoint(state.state_dict(), config.OUTPUT, epoch, **kw)
        barrier()

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
                    if not same_on_all_ranks(b) or b == 0:
                        continue
                    loss = float(run_step(batch.audio, batch.noisy,
                                          step_seed(seed, epoch, idx), True))
                    if not np.isfinite(loss):
                        raise RuntimeError(f"Detected NaN loss at step {idx}.")
                    losses.append(loss)
                    meter.update(loss, b)
                    batch_meter.update(time.time() - t_end)
                    t_end = time.time()
                    if any_rank(guard.should_stop):
                        state.epoch = epoch  # the interrupted epoch runs again on resume
                        checkpoint(epoch)
                        logger.info(f"=> preemption checkpoint_{epoch:04d} saved; resume "
                                    "with --resume auto")
                        return history
                    if idx % args.print_freq == 0:
                        logger.info(f"Train: [{epoch}/{args.epochs}][{idx}/{iters_per_epoch}]"
                                    f"\ttime {batch_meter.val:.4f} ({batch_meter.avg:.4f})\t"
                                    f"loss {meter}")

                loss_sum = count = 0.0
                for vidx, batch in enumerate(valid_loader, start=idx + 1):
                    # this rank's rows of the global batch (rows that do not
                    # divide go to the first ranks; a rank may have none)
                    clean, noisy = shard_rows(batch.audio), shard_rows(batch.noisy)
                    b = clean.shape[0]
                    if b == 0:
                        continue
                    loss_sum += float(run_step(clean, noisy, step_seed(seed, epoch, vidx),
                                               False)) * b
                    count += b
                loss_sum, count = host_sum([loss_sum, count])
                valid_loss = loss_sum / max(count, 1)

                is_best = valid_loss <= state.best_loss
                state.best_loss = min(valid_loss, state.best_loss)
                state.epoch = epoch + 1
                if args.world > 1:
                    logger.info(f"replicas: {check_replicas(state.model)}")
                checkpoint(epoch, is_best=is_best, variables=state.variables())
                if rank == 0:
                    logger.info(f"=> saved checkpoint_{epoch:04d} (best={is_best})")
                logger.info(f"Train Loss {meter.avg:.4f}  Valid Loss {valid_loss:.4f}")
                history.append({"epoch": epoch, "train_losses": losses,
                                "train_loss": meter.avg, "valid_loss": valid_loss,
                                "is_best": is_best})
        return history
    finally:
        guard.restore()


if __name__ == "__main__":
    main()
