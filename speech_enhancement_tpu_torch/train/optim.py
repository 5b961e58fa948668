"""Optimizers and LR schedule (port of speech_enhancement_tpu/train/optim.py).

The same four choices as the JAX package's optax chains, update for
update: SGD with Nesterov momentum and AdamW from ``torch.optim``; LARS and
LAMB written here to match ``optax.lars`` and ``optax.lamb``.  The same
no-decay rule (1-D parameters and anything named ``bias``), optional
global-norm clipping before the update, LAMB's built-in pre-clip at 1.0,
and the cyclic half-cosine schedule with per-cycle halving, evaluated at
the update count as optax evaluates a schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
from torch import nn

Schedule = Callable[[int], float]


def cyclic_cosine_schedule(base_lr: float, epochs: int, iters_per_epoch: int,
                           cycle_limit: int = 4, warmup_epochs: int = 4,
                           scale: float = 1.0) -> Schedule:
    """Warmup + half-cycle cosine with per-cycle halving (``optim.py:20-59``).

    cycle_length = epochs // cycle_limit; within cycle q at offset r:
      warmup:  lr = 0.5^q * LR * r / warmup
      cosine:  lr = LR * 0.5^(q+1) * (1 + cos(pi*(r-warmup)/(cycle-warmup)))

    With the JAX function's guards: a cycle of at least one epoch, and a
    warmup shorter than the cycle.  ``scale`` gives the discriminator's
    2x lr.
    """
    cycle_length = max(epochs // cycle_limit, 1)
    warmup_epochs = min(warmup_epochs, cycle_length - 1) if cycle_length > 1 else 0
    denom = max(cycle_length - warmup_epochs, 1e-9)

    def schedule(step: int) -> float:
        epoch = step / float(iters_per_epoch)
        q = math.floor(epoch / cycle_length)
        r = epoch - q * cycle_length
        if r < warmup_epochs:
            lr = 0.5 ** q * base_lr * r / warmup_epochs
        else:
            lr = base_lr * 0.5 ** (q + 1) * (
                1.0 + math.cos(math.pi * (r - warmup_epochs) / denom))
        return scale * lr

    return schedule


def decays(name: str, param: torch.Tensor) -> bool:
    """True where weight decay applies: not for 1-D parameters nor for
    anything named ``bias`` (``optim.py:62-71``)."""
    return param.ndim > 1 and not any(part.endswith("bias") for part in name.split("."))


class Lars(torch.optim.Optimizer):
    """``optax.lars``: decay (masked), then the trust ratio
    ``trust_coefficient * |p| / |u|`` (masked; 1 where either norm is 0),
    then ``-lr``, then momentum on the scaled update (no Nesterov).  A
    group's ``decay`` flag is both masks, as the JAX package passes the
    same mask for both."""

    trust_coefficient = 0.001  # optax.lars's default

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      decay=True))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if group["decay"]:
                    u = u + group["weight_decay"] * p
                    u = u * _trust_ratio(p, u, self.trust_coefficient)
                u = -group["lr"] * u
                state = self.state[p]
                trace = state.get("trace")
                trace = u if trace is None else u + group["momentum"] * trace
                state["trace"] = trace
                p.add_(trace)


class Lamb(torch.optim.Optimizer):
    """``optax.lamb``: Adam moments with bias correction (eps outside the
    root), decay (masked by the group's ``decay`` flag), the trust ratio
    ``|p| / |u|`` (unmasked; 1 where either norm is 0), then ``-lr``."""

    b1, b2, eps = 0.9, 0.999, 1e-6  # optax.lamb's defaults

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, decay=True))

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = self.b1, self.b2
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["count"] += 1
                mu, nu, count = state["mu"], state["nu"], state["count"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).add_(g * g, alpha=1 - b2)
                u = (mu / (1 - b1 ** count)) / (torch.sqrt(nu / (1 - b2 ** count))
                                                + self.eps)
                if group["decay"]:
                    u = u + group["weight_decay"] * p
                u = u * _trust_ratio(p, u, 1.0)
                p.add_(u, alpha=-group["lr"])


def _trust_ratio(p: torch.Tensor, u: torch.Tensor, coefficient: float) -> torch.Tensor:
    p_norm = torch.linalg.vector_norm(p)
    u_norm = torch.linalg.vector_norm(u)
    ratio = coefficient * p_norm / u_norm
    return torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio), ratio)


class Optimizer:
    """One optimizer over a module's parameters, as an optax chain: clip
    the global gradient norm (when ``max_norm`` > 0), set the learning
    rate from the schedule at the update count, step the rule.

    ``step()`` reads ``p.grad``; ``count`` is the number of updates so far
    (the step of the JAX package's optimizer state)."""

    def __init__(self, rule: torch.optim.Optimizer, learning_rate: Schedule | float,
                 params: Iterable[torch.Tensor], max_norm: float = 0.0):
        self.rule = rule
        self.learning_rate = learning_rate
        self.params = list(params)
        self.max_norm = max_norm
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        if self.max_norm > 0.0:
            clip_by_global_norm_(self.params, self.max_norm)
        lr = self.learning_rate
        lr = float(lr(self.count)) if callable(lr) else float(lr)
        for group in self.rule.param_groups:
            group["lr"] = lr
        self.rule.step()
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: when the global gradient norm is at
    least ``max_norm``, scale every gradient by ``max_norm / norm``.
    Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    if norm >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


def build_optimizer(name: str, learning_rate: Schedule | float, module: nn.Module,
                    momentum: float = 0.9, weight_decay: float = 0.01,
                    max_norm: float = 0.0) -> Optimizer:
    """sgd (Nesterov) / adamw / lars / lamb over ``module``'s parameters,
    with the no-decay rule and optional global-norm clipping
    (``optim.py:74-118``).  LAMB always pre-clips, at ``max_norm`` or 1.0."""
    named = list(module.named_parameters())
    decay = [p for n, p in named if decays(n, p)]
    no_decay = [p for n, p in named if not decays(n, p)]
    name = name.lower()
    if name == "sgd":
        groups = [dict(params=decay, weight_decay=weight_decay),
                  dict(params=no_decay, weight_decay=0.0)]
        rule = torch.optim.SGD(groups, lr=0.0, momentum=momentum, nesterov=True)
    elif name == "adamw":
        groups = [dict(params=decay, weight_decay=weight_decay),
                  dict(params=no_decay, weight_decay=0.0)]
        rule = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    elif name == "lars":
        groups = [dict(params=decay, decay=True), dict(params=no_decay, decay=False)]
        rule = Lars(groups, lr=0.0, momentum=momentum, weight_decay=weight_decay)
    elif name == "lamb":
        groups = [dict(params=decay, decay=True), dict(params=no_decay, decay=False)]
        rule = Lamb(groups, lr=0.0, weight_decay=weight_decay)
        max_norm = max_norm if max_norm else 1.0
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(rule, learning_rate, [p for _, p in named], max_norm)
