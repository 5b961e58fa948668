"""SCP-GAN / CMGAN training entry point (port of
speech_enhancement_tpu/cli/main_gan.py).

The same flags and defaults: arch choices ['scp', 'cp', 'sc', 'cmgan'],
``TSCNet(64, N_FFT // 2 + 1)`` and ``Discriminator(16)``, MSE, the cyclic
cosine schedule with the discriminator's learning rate at 2x, the four
step modes (``--step-mode``, default pipelined; ``--async-disc`` is
async), ``--gen-first`` gating, validation of every utterance with the
best-by-validation-discriminator-loss checkpoint, ``--resume auto`` and
``--init-from``, and an emergency checkpoint on SIGTERM/SIGINT.
``--device`` (default ``cuda``; ``cpu`` runs on the CPU).

Data parallel: ``--n-devices n`` or ``--num-processes P`` (with
``--process-id`` and ``--coordinator`` for ranks started by hand) run one
rank per device, with the JAX run's global batch on the same flags
(``parallel/launch.py`` gives the mapping).  Each rank loads its shard of
the training files; a batch whose rows differ between the ranks is
skipped by all; validation splits every global batch over the ranks;
rank 0 writes the checkpoints, the others wait; ``--resume`` and
``--init-from`` are read by every rank, then rank 0's state is broadcast.
After each epoch the ranks check that their replicas are bitwise equal and
log the digest.

Usage:
  python -m speech_enhancement_tpu_torch.cli.main_gan -a scp \\
      --cfg speech_enhancement_tpu_torch/config/scp.yaml --output out --epochs 100 \\
      --fused-attention
"""

from __future__ import annotations

import argparse
import math
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from speech_enhancement_tpu_torch.config import get_config
from speech_enhancement_tpu_torch.data import Collator, DataLoader, VoicebankDataset
from speech_enhancement_tpu_torch.metrics.pesq import batch_pesq_raw
from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
from speech_enhancement_tpu_torch.parallel import (
    barrier,
    broadcast_state_,
    check_replicas,
    destroy,
    host_sum,
    init_distributed,
    launch,
    rank_device,
    shard_rows,
    spawn,
    world_size,
)
from speech_enhancement_tpu_torch.train import (
    DISC_LAG,
    GanTrainState,
    build_criterion,
    build_optimizer,
    cyclic_cosine_schedule,
    gan_eval_step,
    run_gan_epoch,
)
from speech_enhancement_tpu_torch.utils import (
    PreemptionGuard,
    create_logger,
    latest_checkpoint,
    load_checkpoint,
    load_variables,
    save_checkpoint,
)
from speech_enhancement_tpu_torch.utils.device import resolve_device

MODEL_NAMES = ["scp", "cp", "sc", "cmgan"]


def host_validation_disc_loss(d_real, d_fake, q_est, crit_name: str = "mse") -> float:
    """The validation discriminator loss L_C + L_E, ``criterion(d_real, 1) +
    criterion(d_fake, q_est)``, in numpy on host arrays."""
    d_real = np.asarray(d_real, np.float32)
    d_fake = np.asarray(d_fake, np.float32)
    q = np.asarray(q_est, np.float32)
    if crit_name in ("mae", "l1"):
        return float(np.mean(np.abs(d_real - np.float32(1.0))) + np.mean(np.abs(d_fake - q)))
    if crit_name in ("mse", "l2"):
        return float(np.mean((d_real - np.float32(1.0)) ** 2) + np.mean((d_fake - q) ** 2))
    raise ValueError(f"invalid criterion {crit_name!r}")


def _validation_pad_rows(b: int, batch_size: int, mesh_size: int) -> int:
    """Rows a validation batch of ``b`` utterances is padded to: the batch
    size rounded up to a multiple of the device count, so that every
    validation batch has one shape."""
    return -(-max(b, batch_size) // mesh_size) * mesh_size


def parse_option(argv=None):
    parser = argparse.ArgumentParser(description="Speech enhancement training")
    parser.add_argument("-a", "--arch", default="cmgan", choices=MODEL_NAMES)
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
                             "weights; optimizers, epoch counter and best loss start fresh")
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw", "lars", "lamb"])
    parser.add_argument("--criterion", default="l1", choices=["mae", "l1", "mse", "l2"])
    parser.add_argument("--crop-len", default=1, type=int)
    parser.add_argument("--gen-first", action="store_true")
    parser.add_argument("--async-disc", action="store_true", help="alias for --step-mode async")
    parser.add_argument(
        "--step-mode", default=None, choices=list(DISC_LAG),
        help="'two-phase': generator step, host PESQ labels, discriminator step in turn; "
             "'async' / 'pipelined': the labels on a thread while the loop goes on, the "
             "discriminator update deferred by one / two steps; 'fused': "
             "make_fused_gan_train_step.  Default: pipelined")
    parser.add_argument("--comp-type", default="pow", choices=["norm", "log", "pow", "none"])
    parser.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                        help="bf16: the generator's forward and backward in bfloat16 on "
                             "fp32 master parameters, losses in fp32")
    parser.add_argument("--fused-attention", action="store_true",
                        help="the time conformers' attention through the fused kernels "
                             "(K1 forward, K2 backward)")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without a card)")
    parser.add_argument("--debug", action="store_true",
                        help="stop at the first generator loss that is not finite")
    launch.add_arguments(parser)
    args = parser.parse_args(argv)
    if args.step_mode is None:
        args.step_mode = "async" if args.async_disc else "pipelined"
    elif args.async_disc and args.step_mode != "async":
        parser.error(f"--async-disc conflicts with --step-mode {args.step_mode}")
    args.async_disc = args.step_mode in ("async", "pipelined")
    args.disc_lag = DISC_LAG[args.step_mode]
    if args.init_from and args.resume:
        parser.error("--init-from and --resume are mutually exclusive: one seeds weights "
                     "only, the other restores the full training state")
    config = get_config(args)
    try:
        args.world, args.rank_batch = launch.layout(args, config.DATA.BATCH_SIZE)
    except ValueError as exc:
        parser.error(str(exc))
    return args, config


def validate(state: GanTrainState, loader, *, batch_size: int, arch: str, criterion,
             crit_name: str, comp_type: str, gan_active: bool, loss_weights: tuple,
             sample_rate: int) -> tuple[float, float]:
    """(generator loss, discriminator loss) over every utterance: a ragged
    tail batch is padded with repeated rows, whose losses are masked out.
    Data parallel: every rank reads the whole batch (``batch_size`` is the
    global batch), pads it to a multiple of the world size, evaluates its
    contiguous rows and masks the pad rows; the masked sums and the
    counts are summed over the ranks at the end, so that the result is one
    process's."""
    device = next(state.gen.parameters()).device
    gen_sum = disc_sum = count = 0.0
    for batch in loader:
        b = batch.audio.shape[0]
        if b == 0:
            continue
        pos = shard_rows(np.arange(_validation_pad_rows(b, batch_size, world_size())))
        real = int((pos < b).sum())
        if real == 0:
            continue
        rows = pos % b  # cyclic repeats
        audio, noisy = batch.audio[rows], batch.noisy[rows]
        losses, aux = gan_eval_step(
            state, torch.from_numpy(audio).to(device), torch.from_numpy(noisy).to(device),
            arch=arch, criterion=criterion, comp_type=comp_type, gan_active=gan_active,
            loss_weights=loss_weights, per_example=True)
        # the real rows come first: pad positions follow every real one
        est = aux.est_audio[:real].float().cpu().numpy()
        q_est = (batch_pesq_raw(audio[:real, :est.shape[1]], est, sample_rate) - 1.0) / 3.5
        d_fake = aux.metrics["d_fake"][:real].cpu().numpy()
        d_real = aux.metrics["d_real"][:real].cpu().numpy()
        gen_sum += float(losses["loss"][:real].mean()) * real
        disc_sum += host_validation_disc_loss(d_real, d_fake, q_est, crit_name) * real
        count += real
    gen_sum, disc_sum, count = host_sum([gen_sum, disc_sum, count])
    return gen_sum / max(count, 1), disc_sum / max(count, 1)


def _rank_main(process_id: int, world: int, coordinator: str, argv: list[str]):
    return main(launch.rank_argv(argv, process_id, coordinator))


def main(argv=None) -> list[dict]:
    """Train; returns one record per epoch run: ``{"epoch", "train"
    (EpochStats), "valid_gen", "valid_disc", "is_best"}`` (rank 0's, when
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
    if args.seed is not None:
        np.random.seed(args.seed)
    seed = args.seed or 0
    logger = create_logger(config.OUTPUT, dist_rank=rank, name=args.arch)
    logger.info(f"device: {device}, arch: {args.arch}, step mode: {args.step_mode}, "
                f"ranks: {args.world} ({backend or 'one process'}), "
                f"{args.rank_batch} rows a rank")

    gen_model = TSCNet(64, config.N_FFT // 2 + 1, fused_attention=args.fused_attention,
                       device=device, generator=torch.Generator().manual_seed(seed))
    disc_model = Discriminator(16, device=device,
                               generator=torch.Generator().manual_seed(seed + 1))
    # the reference hardcodes MSE for the GAN path
    crit_name = "mse"
    criterion = build_criterion(crit_name)
    compute_dtype = torch.bfloat16 if args.precision == "bf16" else None

    train_ds = VoicebankDataset(config.DATA.TRAIN_CLEAN_DIR, config.DATA.TRAIN_NOISY_DIR,
                                config.HOP_SAMPLES, config.CROP_FRAMES)
    valid_ds = VoicebankDataset(config.DATA.TEST_CLEAN_DIR, config.DATA.TEST_NOISY_DIR,
                                config.HOP_SAMPLES, config.CROP_FRAMES)
    global_batch = args.rank_batch * args.world

    def collator(labels: bool):
        return Collator(config.HOP_SAMPLES, config.CROP_FRAMES, config.CROP_LEN,
                        rng=np.random.default_rng(args.seed), precompute_labels=labels,
                        sample_rate=config.SAMPLE_RATE)

    # each rank loads its shard of the training files
    train_loader = DataLoader(train_ds, args.rank_batch, collator(True), shuffle=True,
                              seed=seed, shard_id=rank, num_shards=args.world,
                              num_workers=args.workers)
    # every utterance is validated: every rank reads the global batches and
    # evaluates its rows, the tail batch is padded and masked
    # (validation computes its estimate's labels itself)
    valid_loader = DataLoader(valid_ds, global_batch, collator(False), shuffle=False,
                              num_workers=args.workers, drop_last=False)

    iters_per_epoch = max(len(train_loader), 1)
    sched = config.TRAIN.SCHEDULER
    schedules = [cyclic_cosine_schedule(sched.LR, sched.EPOCHS, iters_per_epoch,
                                        sched.CYCLE_LIMIT, sched.WARMUP_EPOCHS, scale=scale)
                 for scale in (1.0, 2.0)]  # disc lr = 2x
    gen_opt, disc_opt = (build_optimizer(args.optimizer, schedule, model, args.momentum,
                                         args.weight_decay, args.max_norm)
                         for schedule, model in zip(schedules, (gen_model, disc_model)))
    state = GanTrainState(gen_model, disc_model, gen_opt, disc_opt)

    if args.init_from:
        variables = load_variables(args.init_from)
        gen_model.load_state_dict(variables["gen"])
        disc_model.load_state_dict(variables["disc"])
        logger.info(f"=> model weights initialized from {args.init_from} "
                    "(fresh optimizers, epoch 0)")
    state.epoch = args.start_epoch
    if args.resume:
        path = latest_checkpoint(config.OUTPUT) if args.resume == "auto" else args.resume
        if path:
            state.load_state_dict(load_checkpoint(path))
            logger.info(f"=> resumed from {path} (epoch {state.epoch})")
    # every rank starts from rank 0's weights, optimizer state and counters
    broadcast_state_(state)
    barrier()
    start_epoch = state.epoch

    loss_weights = tuple(config.LOSS_WEIGHTS)
    history = []
    # pipelined mode keeps two label jobs in flight
    label_pool = ThreadPoolExecutor(max_workers=max(1, args.disc_lag))
    guard = PreemptionGuard()

    def checkpoint(epoch: int, **kw):
        """Rank 0 writes, every rank waits for it."""
        if rank == 0:
            save_checkpoint(state.state_dict(), config.OUTPUT, epoch, **kw)
        barrier()

    try:
        for epoch in range(start_epoch, args.epochs):
            train_loader.set_epoch(epoch)
            gan_active = epoch >= int(args.epochs * 0.3) or not args.gen_first

            def on_step(idx, stats):
                if args.debug and not math.isfinite(stats.gen_losses[-1]):
                    raise FloatingPointError(f"epoch {epoch} step {idx}: generator loss "
                                             f"{stats.gen_losses[-1]}")
                if idx % args.print_freq == 0:
                    logger.info(f"Train: [{epoch}/{args.epochs}][{idx}/{iters_per_epoch}]\t"
                                f"time {stats.batch_time.val:.4f} ({stats.batch_time.avg:.4f})"
                                f"\tgenerator loss {stats.gen}\tdiscriminator loss "
                                f"{stats.disc}")
                return guard.should_stop

            stats = run_gan_epoch(
                state, train_loader, epoch=epoch, seed=seed, criterion=criterion,
                step_mode=args.step_mode, arch=args.arch, comp_type=args.comp_type,
                n_fft=config.N_FFT, hop=config.HOP_SAMPLES, gan_active=gan_active,
                loss_weights=loss_weights, compute_dtype=compute_dtype,
                sample_rate=config.SAMPLE_RATE, label_pool=label_pool, on_step=on_step)
            if stats.stopped:
                state.epoch = epoch  # the interrupted epoch runs again on resume
                checkpoint(epoch)
                logger.info(f"=> preemption checkpoint_{epoch:04d} saved; resume with "
                            "--resume auto")
                return history

            valid_gen, valid_disc = validate(
                state, valid_loader, batch_size=global_batch, arch=args.arch,
                criterion=criterion, crit_name=crit_name, comp_type=args.comp_type,
                gan_active=gan_active, loss_weights=loss_weights,
                sample_rate=config.SAMPLE_RATE)
            is_best = valid_disc <= state.best_loss
            state.best_loss = min(valid_disc, state.best_loss)
            state.epoch = epoch + 1
            if args.world > 1:
                logger.info(f"replicas: generator {check_replicas(state.gen)} "
                            f"discriminator {check_replicas(state.disc)}")
            checkpoint(epoch, is_best=is_best, variables=state.variables())
            if rank == 0:
                logger.info(f"=> saved checkpoint_{epoch:04d} (best={is_best})")
            logger.info(f"Train Gen {stats.gen.avg:.3f}  Train Disc {stats.disc.avg:.3f}  "
                        f"Valid Gen {valid_gen:.3f}  Valid Disc {valid_disc:.3f}")
            history.append({"epoch": epoch, "train": stats, "valid_gen": valid_gen,
                            "valid_disc": valid_disc, "is_best": is_best})
        return history
    finally:
        label_pool.shutdown(wait=True, cancel_futures=True)
        guard.restore()


if __name__ == "__main__":
    main()
