"""Two ranks on one card over NCCL: what NCCL says.

    python -m speech_enhancement_tpu_torch.probes.nccl_shared_card

Starts two ranks (``parallel.spawn``) that both take ``cuda:0`` and join an
NCCL group, then all-reduce one tensor; prints the error NCCL raises, or
the sum when it does not.  This is why ``parallel.init_distributed``
picks gloo when two ranks share a card.  Each rank's group times out
after 60 s; run it under a time limit.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from speech_enhancement_tpu_torch import parallel


def _rank(process_id: int, world: int, coordinator: str):
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=60)
    store = dist.TCPStore(host, int(port), world, is_master=process_id == 0, timeout=timeout)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=store, rank=process_id, world_size=world,
                            timeout=timeout, device_id=torch.device("cuda:0"))
    try:
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        return t.tolist()
    finally:
        dist.destroy_process_group()


def main() -> int:
    try:
        out = parallel.spawn(_rank, 2)
        print(f"two ranks on cuda:0 over NCCL all-reduced: {out}")
    except Exception as exc:  # the finding: NCCL's own error text
        print(f"two ranks on cuda:0 over NCCL: {type(exc).__name__}: {exc}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
