"""The training CLIs' data-parallel flags, as the JAX CLIs name them:
``--n-devices``, ``--num-processes``, ``--process-id`` and
``--coordinator``.

The global batch of a port run is the JAX run's on the same flags.  The
JAX CLI runs one process per host, each loading ``batch_size`` rows and
sharding them over its devices; the port runs one process per device:

* ``--n-devices n`` (one JAX process over n devices, global batch B): n
  ranks of B / n rows each (n must divide B);
* ``--num-processes P`` (P JAX processes of B rows each, global P * B): P
  ranks of B rows each.

Without ``--process-id`` the CLI starts its ranks itself on this host
(``parallel.spawn``) and returns rank 0's result; with it, this process is
that rank, and ``--coordinator host:port`` names rank 0's TCP store.  A
rank's device is ``parallel.rank_device(--device, rank)``: the ranks take
the host's cards in turn, and share one over gloo when there are more
ranks than cards.
"""

from __future__ import annotations

import argparse


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--n-devices", default=None, type=int,
                        help="data parallel over n local ranks, the config's batch split "
                             "over them (B / n rows a rank)")
    parser.add_argument("--coordinator", default=None, type=str,
                        help="host:port of rank 0's TCP store (with --process-id)")
    parser.add_argument("--num-processes", default=None, type=int,
                        help="data parallel over P ranks of the config's batch each; "
                             "without --process-id all P start on this host")
    parser.add_argument("--process-id", default=None, type=int,
                        help="this process's rank (the ranks started by hand)")


def layout(args, batch_size: int) -> tuple[int, int]:
    """``(world size, rows per rank)`` of the flags and the config's
    ``batch_size``; raises ``ValueError`` on flags that name no layout."""
    n, p = args.n_devices, args.num_processes
    for name, v in (("--n-devices", n), ("--num-processes", p)):
        if v is not None and v < 1:
            raise ValueError(f"{name} {v}: at least 1")
    if n is not None and p is not None and n != p:
        raise ValueError(f"--n-devices {n} and --num-processes {p} name two layouts: "
                         "one rank per device")
    if p is not None:
        world, rows = p, batch_size
    elif n is not None:
        if batch_size % n:
            raise ValueError(f"--n-devices {n} does not divide the batch of {batch_size}")
        world, rows = n, batch_size // n
    else:
        world, rows = 1, batch_size
    if world == 1 and (args.process_id not in (None, 0) or args.coordinator):
        raise ValueError("--process-id and --coordinator need --num-processes or --n-devices")
    if args.process_id is not None and not 0 <= args.process_id < world:
        raise ValueError(f"--process-id {args.process_id} is not a rank of {world}")
    if world > 1 and args.process_id is not None and args.coordinator is None:
        raise ValueError("--process-id needs --coordinator (rank 0's host:port)")
    return world, rows


def rank_argv(argv: list[str], process_id: int, coordinator: str) -> list[str]:
    """``argv`` of one rank that the CLI starts itself."""
    return [*argv, "--process-id", str(process_id), "--coordinator", coordinator]
