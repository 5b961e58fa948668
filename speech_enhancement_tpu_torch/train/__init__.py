"""GAN training: criteria, optimizers and schedule, train state, the
generator / discriminator / eval steps, and the epoch loop with its step
modes."""

from speech_enhancement_tpu_torch.train.criterion import build_criterion, l1_loss, l2_loss
from speech_enhancement_tpu_torch.train.gan import (
    GenAux,
    gan_discriminator_step,
    gan_eval_step,
    gan_generator_step,
    make_fused_gan_train_step,
    phase_seeds,
    self_correcting_weights,
)
from speech_enhancement_tpu_torch.train.loop import DISC_LAG, EpochStats, run_gan_epoch
from speech_enhancement_tpu_torch.train.optim import (
    Optimizer,
    build_optimizer,
    cyclic_cosine_schedule,
)
from speech_enhancement_tpu_torch.train.state import GanTrainState, create_gan_state

__all__ = [
    "DISC_LAG",
    "EpochStats",
    "GanTrainState",
    "GenAux",
    "Optimizer",
    "build_criterion",
    "build_optimizer",
    "create_gan_state",
    "cyclic_cosine_schedule",
    "gan_discriminator_step",
    "gan_eval_step",
    "gan_generator_step",
    "l1_loss",
    "l2_loss",
    "make_fused_gan_train_step",
    "phase_seeds",
    "run_gan_epoch",
    "self_correcting_weights",
]
