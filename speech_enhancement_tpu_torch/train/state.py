"""Train states (port of speech_enhancement_tpu/train/state.py).

Plain containers.  :class:`GanTrainState`: the generator and
discriminator modules, their optimizers (each carrying its learning-rate
schedule and update count), step counters, ``best_loss`` and ``epoch``.
:class:`ModuleState`: one model (the diffusion families) with its
optimizer, step counter, ``best_loss`` and ``epoch``.  The train steps
update the modules and optimizers in place; ``state_dict`` /
``load_state_dict`` carry all of it through a checkpoint.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from speech_enhancement_tpu_torch.train.optim import Optimizer, Schedule, build_optimizer


@dataclasses.dataclass
class GanTrainState:
    gen: nn.Module
    disc: nn.Module
    gen_opt: Optimizer
    disc_opt: Optimizer
    gen_step: int = 0
    disc_step: int = 0
    best_loss: float = 1e8
    epoch: int = 0

    def variables(self) -> dict:
        """The inference-ready weights: both models' ``state_dict``s."""
        return {"gen": self.gen.state_dict(), "disc": self.disc.state_dict()}

    def state_dict(self) -> dict:
        """Everything a resumed run needs: both models, both optimizers, the
        step counters, ``best_loss`` and ``epoch``."""
        return {**self.variables(), "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict(), "gen_step": self.gen_step,
                "disc_step": self.disc_step, "best_loss": self.best_loss, "epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output in place (strict for the
        models)."""
        self.gen.load_state_dict(state["gen"])
        self.disc.load_state_dict(state["disc"])
        self.gen_opt.load_state_dict(state["gen_opt"])
        self.disc_opt.load_state_dict(state["disc_opt"])
        self.gen_step, self.disc_step = int(state["gen_step"]), int(state["disc_step"])
        self.best_loss, self.epoch = float(state["best_loss"]), int(state["epoch"])


@dataclasses.dataclass
class ModuleState:
    model: nn.Module
    opt: Optimizer | None = None
    step: int = 0
    best_loss: float = 1e8
    epoch: int = 0

    def variables(self) -> dict:
        """The inference-ready weights: ``{"model": state_dict}``."""
        return {"model": self.model.state_dict()}

    def state_dict(self) -> dict:
        """Everything a resumed run needs: the model, the optimizer, the step
        counter, ``best_loss`` and ``epoch``."""
        return {**self.variables(), "opt": self.opt.state_dict(), "step": self.step,
                "best_loss": self.best_loss, "epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output in place (strict for the
        model)."""
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])
        self.step, self.best_loss = int(state["step"]), float(state["best_loss"])
        self.epoch = int(state["epoch"])


def create_gan_state(gen_model: nn.Module, disc_model: nn.Module,
                     optimizer: str = "sgd", learning_rate: Schedule | float = 1e-3,
                     momentum: float = 0.9, weight_decay: float = 0.01,
                     max_norm: float = 0.0) -> GanTrainState:
    """Both models with one optimizer each, built by
    :func:`~speech_enhancement_tpu_torch.train.optim.build_optimizer`.  The
    discriminator's learning rate is twice the generator's
    (``cli/main_gan.py:250``)."""
    if callable(learning_rate):
        disc_learning_rate = lambda step: 2.0 * learning_rate(step)  # noqa: E731
    else:
        disc_learning_rate = 2.0 * learning_rate
    kw = dict(momentum=momentum, weight_decay=weight_decay, max_norm=max_norm)
    return GanTrainState(
        gen=gen_model, disc=disc_model,
        gen_opt=build_optimizer(optimizer, learning_rate, gen_model, **kw),
        disc_opt=build_optimizer(optimizer, disc_learning_rate, disc_model, **kw),
    )
