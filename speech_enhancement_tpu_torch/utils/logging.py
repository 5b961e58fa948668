"""Logger and console meters (the port's copy of
speech_enhancement_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path


class AverageMeter:
    """Running value and average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.val:.4f} ({self.avg:.4f})"


class ProgressMeter:
    """Console progress lines."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        num_digits = len(str(num_batches))
        self.fmt = "[{:" + str(num_digits) + "d}/" + f"{num_batches}]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.fmt.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries))


def create_logger(output_dir: str, dist_rank: int = 0, name: str = ""):
    """The logger ``name`` writing to ``<output_dir>/log_rank<rank>.txt``,
    and to stdout on rank 0.  Each call configures it anew: the handlers of
    an earlier call are closed and replaced, so that runs in one process
    neither repeat each other's lines nor write to each other's files."""
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    fmt = logging.Formatter(
        fmt="[%(asctime)s %(name)s] (%(filename)s %(lineno)d): %(levelname)s %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    if dist_rank == 0:
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(logging.DEBUG)
        console.setFormatter(fmt)
        logger.addHandler(console)
    fh = logging.FileHandler(os.path.join(output_dir, f"log_rank{dist_rank}.txt"), mode="a")
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger
