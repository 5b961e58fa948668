"""Data parallelism (port of speech_enhancement_tpu/parallel/mesh.py).

The JAX package shards a batch over a device mesh and lets XLA insert the
gradient all-reduce.  Here it is torch's idiom: one process per rank, one
process group, and the collectives written out where the JAX package gets
them from SPMD: the train steps average their gradients
(:func:`all_reduce_mean_`), ``models.layers.BatchNorm1d`` takes global
batch statistics, and every rank starts from rank 0's state
(:func:`broadcast_state_`).  Only ``all_reduce`` and ``broadcast`` are
used, so that gloo serves ranks that share a card as well as ranks on the
CPU.

The backend follows the rank-to-device layout (:func:`init_distributed`):
NCCL when every rank has a card of its own, gloo on the CPU and when two
ranks share a card (NCCL refuses two ranks on one device).  With one
process nothing is set up, and every function here is a no-op or the
identity.
"""

from __future__ import annotations

import datetime
import hashlib
import socket
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from speech_enhancement_tpu_torch.utils.device import resolve_device

# the device of this rank: host-side values (flags, sums, sizes) go
# through the collectives on it
_device: torch.device = torch.device("cpu")


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_seed(seed: int) -> int:
    """``seed`` with this rank folded in when more than one rank runs (each
    rank draws its own dropout masks and diffusion draws for its rows), and
    ``seed`` itself for one process."""
    if world_size() == 1:
        return seed
    return int(np.random.SeedSequence((seed, rank())).generate_state(1)[0])


def _address(coordinator: str) -> tuple[str, int]:
    host, _, port = coordinator.removeprefix("tcp://").rpartition(":")
    return host or "127.0.0.1", int(port)


def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device_key(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    return f"cuda:{torch.cuda.get_device_properties(device).uuid}"


def rank_device(device, process_id: int) -> torch.device:
    """The device of rank ``process_id`` (``utils.device.resolve_device``
    first: None is ``cuda``): ``cuda`` without an index becomes
    ``cuda:{process_id % device_count}``, so that the ranks of one host
    take its cards in turn and two ranks share a card when there are more
    ranks than cards; an explicit index and the CPU are kept."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return device


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     timeout_s: float = 600.0) -> str | None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, through the TCP store at ``coordinator``
    (``host:port``, rank 0 serves it).  No-op for one process.

    Every rank posts its device to the store first (the card's UUID, or
    ``cpu``), and all of them pick the backend from the whole layout:
    ``nccl`` when every rank has a card of its own, ``gloo`` when a rank
    is on the CPU or two ranks share a card.  Returns the backend (None
    for one process)."""
    global _device
    if num_processes is None or num_processes <= 1:
        return None
    if process_id is None or coordinator is None:
        raise ValueError("a process group of more than one rank needs --process-id and "
                         "--coordinator")
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    host, port = _address(coordinator)
    store = dist.TCPStore(host, port, num_processes, is_master=process_id == 0,
                          timeout=timeout)
    layout = dist.PrefixStore("layout", store)
    layout.set(str(process_id), _device_key(device))
    keys = [layout.get(str(r)).decode() for r in range(num_processes)]
    own_cards = all(k.startswith("cuda:") for k in keys) and len(set(keys)) == len(keys)
    backend = "nccl" if own_cards else "gloo"
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout, **kw)
    _device = device
    return backend


def destroy() -> None:
    """Leave the process group (no-op without one)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = torch.device("cpu")


def barrier() -> None:
    """Every rank waits for the others here (no-op for one process)."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[_device.index])
        else:
            dist.barrier()


def shard_rows(array, rank_: int | None = None, world: int | None = None):
    """This rank's contiguous rows of a global batch (``shard_batch``'s
    split): row blocks in rank order, as ``np.array_split`` cuts them, so
    that rows that do not divide evenly go one each to the first ranks."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world
    n = len(array)
    bounds = np.cumsum([0] + [n // w + (i < n % w) for i in range(w)])
    return array[bounds[r]:bounds[r + 1]]


def _all_reduce_(tensors: Sequence[torch.Tensor], op, scale: float | None = None):
    """All-reduce ``tensors`` in place through one flattened fp32 buffer."""
    tensors = list(tensors)
    if world_size() == 1 or not tensors:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=op)
    if scale is not None:
        flat.mul_(scale)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view(t.shape))
        offset += n
    return tensors


def all_reduce_mean_(tensors: Sequence[torch.Tensor]):
    """Average ``tensors`` (gradients, loss metrics) over the ranks, in
    place: one all-reduce of one flattened fp32 buffer, then a division
    by the world size.  Returns the list."""
    return _all_reduce_(tensors, dist.ReduceOp.SUM, 1.0 / world_size())


def host_sum(values: Sequence[float]) -> list[float]:
    """The sums over the ranks of host numbers (float64)."""
    if world_size() == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=_device)
    dist.all_reduce(t)
    return t.tolist()


def host_max(values: Sequence[float]) -> list[float]:
    """The maxima over the ranks of host numbers (float64)."""
    if world_size() == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=_device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any: a decision that
    every rank must take alike (a stop)."""
    return bool(host_max([float(flag)])[0])


def same_on_all_ranks(value: int) -> bool:
    """Whether every rank passed the same ``value`` (a batch's row count)."""
    hi, neg_lo = host_max([value, -value])
    return hi == -neg_lo


def _leaves(tree, tensors: list, numbers: list):
    """The tensors and the int / float numbers of a state_dict, in order."""
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, tensors, numbers)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, tensors, numbers)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        numbers.append(tree)


def _rebuild(tree, tensors, numbers):
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, dict):
        return {k: _rebuild(v, tensors, numbers) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, tensors, numbers) for v in tree)
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return type(tree)(next(numbers))
    return tree


@torch.no_grad()
def broadcast_state_(obj, src: int = 0):
    """Give every rank rank ``src``'s state of ``obj`` (a module, or an
    optimizer or train state with ``state_dict`` / ``load_state_dict``):
    every tensor of its ``state_dict`` and every number in it
    (``replicate_state``).  Every rank must hold a state of the same
    structure (fresh, or loaded from the same checkpoint); a rank whose
    structure differs raises.  Returns ``obj``."""
    if world_size() == 1:
        return obj
    state = obj.state_dict()
    tensors, numbers = [], []
    _leaves(state, tensors, numbers)
    shape = [len(tensors), sum(t.numel() for t in tensors), len(numbers)]
    if host_max(shape) != [float(s) for s in shape] or \
            host_max([-s for s in shape]) != [float(-s) for s in shape]:
        raise RuntimeError(f"rank {rank()}: state of {type(obj).__name__} differs in "
                           f"structure between the ranks ({shape} here)")
    out = []
    for t in tensors:
        t = t.detach().contiguous().clone()
        dist.broadcast(t, src)
        out.append(t)
    nums = torch.tensor([float(n) for n in numbers] or [0.0], dtype=torch.float64,
                        device=_device)
    dist.broadcast(nums, src)
    obj.load_state_dict(_rebuild(state, iter(out), iter(nums.tolist())))
    return obj


def check_replicas(module: torch.nn.Module) -> str:
    """The SHA-256 of the bytes of ``module``'s parameters and buffers (in
    ``state_dict`` order), after checking that every rank has the same
    one; raises when a replica has drifted."""
    h = hashlib.sha256()
    for t in module.state_dict().values():
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    digest = h.hexdigest()
    word = int(digest[:12], 16)  # 48 bits: exact in float64
    if not same_on_all_ranks(word):
        raise RuntimeError(f"rank {rank()}: the replicas of {type(module).__name__} differ "
                           f"(digest {digest})")
    return digest


def _spawned(process_id: int, fn: Callable, world: int, coordinator: str, results, args):
    out = fn(process_id, world, coordinator, *args)
    if process_id == 0:
        results.put(out)


def spawn(fn: Callable, world: int, *args):
    """Run ``fn(process_id, world, coordinator, *args)`` in ``world`` local
    processes started with ``spawn`` (never ``fork``: the parent may have
    CUDA up), with a free port of 127.0.0.1 as the coordinator.  Returns
    rank 0's result; a rank that raises ends the others and raises here."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    coordinator = f"127.0.0.1:{free_port()}"
    procs = torch.multiprocessing.spawn(_spawned, (fn, world, coordinator, results, args),
                                        nprocs=world, join=False)
    out = None
    # read while the ranks run: a result larger than the pipe's buffer
    # would block rank 0's put until it is read
    while not procs.join(timeout=0.2):
        while not results.empty():
            out = results.get()
    while not results.empty():
        out = results.get()
    return out
