"""Checkpoints (port of speech_enhancement_tpu/utils/checkpoint.py, which
saves with orbax).

The same layout: ``<out>/checkpoint_{epoch:04d}/`` per epoch and a full
copy to ``<out>/model_best/`` on improvement.  Inside a directory
``torch.save`` writes ``state.pt``, the train state to resume from
(``GanTrainState.state_dict()``: both models, both optimizers, the step
counters, ``epoch`` and ``best_loss``), and, when given, ``variables.pt``,
the inference-ready ``{"gen": state_dict, "disc": state_dict}``.  An
emergency (preemption) checkpoint has ``state.pt`` only.  Loading maps
every tensor to the CPU and unpickles tensors and plain containers only
(``weights_only``).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any

import torch

STATE, VARIABLES = "state.pt", "variables.pt"


def save_checkpoint(state: dict, path: str, epoch: int, is_best: bool = False,
                    keep_name: str = "model_best", variables: dict | None = None) -> str:
    """Save ``state`` to ``<path>/checkpoint_<epoch:04d>/state.pt`` (and
    ``variables`` beside it as ``variables.pt``); copy the directory to
    ``<path>/<keep_name>`` when ``is_best``.  Returns the directory."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    target = path / f"checkpoint_{epoch:04d}"
    if target.exists():
        shutil.rmtree(target)
    target.mkdir()
    torch.save(state, target / STATE)
    if variables is not None:
        torch.save(variables, target / VARIABLES)
    if is_best:
        best = path / keep_name
        if best.exists():
            shutil.rmtree(best)
        shutil.copytree(target, best)
    return str(target)


def load_checkpoint(path: str) -> dict[str, Any]:
    """The train state saved by :func:`save_checkpoint` in directory
    ``path``."""
    return torch.load(Path(path) / STATE, map_location="cpu", weights_only=True)


def load_variables(path: str) -> dict[str, Any]:
    """The inference-ready variables of checkpoint directory ``path``."""
    return torch.load(Path(path) / VARIABLES, map_location="cpu", weights_only=True)


def sweep_checkpoints(path: str, start: int | None = None,
                      end: int | None = None) -> list[tuple[int, Path]]:
    """Restorable ``(epoch, checkpoint_dir)`` pairs for an inference sweep
    (``--validate-epochs``).

    A directory without ``variables.pt`` (an emergency save) is skipped
    with a message.  An explicit ``[start, end)`` probes the zero-padded
    names this package writes; otherwise the checkpoints present are
    found, each glob path kept as it is, so that a foreign unpadded name
    (``checkpoint_5``) restores from its real directory.  One entry per
    epoch: of a padded and an unpadded twin, the restorable one (the
    padded one when both are)."""
    root = Path(path)

    def restorable(epoch: int, p: Path) -> bool:
        if (p / VARIABLES).exists():
            return True
        print(f"skipping epoch {epoch}: no restorable {VARIABLES} under {p}")
        return False

    if start is not None and end is not None:
        pairs = [(e, root / f"checkpoint_{e:04d}") for e in range(start, end)]
    else:
        found = sorted(((int(p.name.split("_", 1)[1]), p) for p in root.glob("checkpoint_*")
                        if p.name.split("_", 1)[1].isdigit()),
                       key=lambda ep: (ep[0], ep[1].name))
        in_range = [(e, p) for e, p in found
                    if (start is None or e >= start) and (end is None or e < end)]
        pairs = []
        for e in sorted({e for e, _ in in_range}):
            twins = [q for ee, q in in_range if ee == e]
            pairs.append((e, next((q for q in twins if (q / VARIABLES).exists()), twins[0])))
    return [(e, p) for e, p in pairs if restorable(e, p)]


def latest_checkpoint(path: str) -> str | None:
    """The ``checkpoint_<n>`` directory of ``path`` with the largest n
    (numerically: ``checkpoint_10500`` comes after ``checkpoint_9500``), or
    None."""
    p = Path(path)
    if not p.exists():
        return None
    cands = sorted((d for d in os.listdir(p)
                    if d.startswith("checkpoint_") and d.split("_", 1)[1].isdigit()),
                   key=lambda d: int(d.split("_", 1)[1]))
    return str(p / cands[-1]) if cands else None
