"""Data parallelism: the process group, its collectives and the row
split of a global batch (``mesh.py``), and the training CLIs' flags
(``launch.py``)."""

from speech_enhancement_tpu_torch.parallel import launch

from speech_enhancement_tpu_torch.parallel.mesh import (
    all_reduce_mean_,
    any_rank,
    barrier,
    broadcast_state_,
    check_replicas,
    destroy,
    free_port,
    host_max,
    host_sum,
    init_distributed,
    rank,
    rank_device,
    rank_seed,
    same_on_all_ranks,
    shard_rows,
    spawn,
    world_size,
)

__all__ = [
    "launch",
    "all_reduce_mean_",
    "any_rank",
    "barrier",
    "broadcast_state_",
    "check_replicas",
    "destroy",
    "free_port",
    "host_max",
    "host_sum",
    "init_distributed",
    "rank",
    "rank_device",
    "rank_seed",
    "same_on_all_ranks",
    "shard_rows",
    "spawn",
    "world_size",
]
