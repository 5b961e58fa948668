"""Training: criteria, optimizers and schedule, train states, the GAN
generator / discriminator / eval steps and the epoch loop with its step
modes, and the diffusion families' forward process, reverse schedule,
train steps and reverse samplers."""

from speech_enhancement_tpu_torch.train.criterion import build_criterion, l1_loss, l2_loss
from speech_enhancement_tpu_torch.train.diffusion import (
    ReverseSchedule,
    add_noise,
    diffuse_step,
    diffuse_train_loss,
    inference_schedule,
    linear_noise_schedule,
    sample_tsc,
    sample_waveform,
    tsc_diffusion_step,
)
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
from speech_enhancement_tpu_torch.train.state import GanTrainState, ModuleState, create_gan_state

__all__ = [
    "DISC_LAG",
    "EpochStats",
    "GanTrainState",
    "GenAux",
    "ModuleState",
    "Optimizer",
    "ReverseSchedule",
    "add_noise",
    "build_criterion",
    "build_optimizer",
    "create_gan_state",
    "cyclic_cosine_schedule",
    "diffuse_step",
    "diffuse_train_loss",
    "gan_discriminator_step",
    "gan_eval_step",
    "gan_generator_step",
    "inference_schedule",
    "l1_loss",
    "l2_loss",
    "linear_noise_schedule",
    "make_fused_gan_train_step",
    "phase_seeds",
    "run_gan_epoch",
    "sample_tsc",
    "sample_waveform",
    "self_correcting_weights",
    "tsc_diffusion_step",
]
