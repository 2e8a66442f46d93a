"""Multi-process helpers, the port's counterpart of
`reflecting_reality_tpu/parallel/multihost.py` (reference: Accelerate's
process group, train_brushnet_mirror.py:902-907, and its
`wait_for_everyone`, evaluate_metrics.py:376).

- `initialize()`: `torch.distributed.init_process_group` from the
  launcher's environment (torchrun sets RANK, WORLD_SIZE, MASTER_ADDR,
  MASTER_PORT and LOCAL_RANK, even for one process); a no-op without it and
  once a group exists.  A run that was asked for and cannot start raises.
- `rank_and_world()`, `is_main_process()`, `local_device()`.
- `barrier(name)`: a rendezvous on the group's key-value store, not a
  device collective, so a rank that is still loading a checkpoint or
  building its kernels does not trip it (JAX uses its coordination
  service's KV barrier for the same reason).
- `local_shard(items)`: this process's part of a work list.
- `all_reduce_mean(tensors)`, `broadcast_from_main(tensors)`: the two
  collectives data-parallel training needs, bucketed.  They and `barrier`
  run whenever a group exists, one of a single rank too (torchrun with one
  process), and are no-ops without one.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
BARRIER_TIMEOUT_S = 600.0
BUCKET_ELEMENTS = 1 << 24           # 64 MB of fp32 a bucket


def initialize(backend: Optional[str] = None, device: str = "cuda", **kwargs) -> None:
    """Start the default process group when the launcher's environment (or
    an explicit `init_method=` ...) asks for one; otherwise do nothing.

    The backend defaults to NCCL for a CUDA `device` and gloo for the CPU.
    Under NCCL each rank binds `cuda:LOCAL_RANK` first.  Fails loudly: a bad
    MASTER_ADDR or an unreachable peer raises (after `timeout=`, 30 minutes
    by default) and never degrades the run to one process."""
    if dist.is_initialized():
        return
    if not kwargs and not all(k in os.environ for k in LAUNCH_ENV):
        return                      # a plain single-process run
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend=backend, **kwargs)


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if _grouped():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return rank_and_world()[0] == 0


def local_device(device: str = "cuda") -> torch.device:
    """The device a rank computes on: `cuda:LOCAL_RANK` for a CUDA
    `device` inside a multi-process run, `device` otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and rank_and_world()[1] > 1:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


_barrier_seq: dict = {}


def barrier(name: str = "barrier", timeout_s: float = BARRIER_TIMEOUT_S) -> None:
    """Wait until every rank reaches this barrier; a no-op without a group.
    Each rank adds one to a counter key on the group's store and the last
    one sets a release key the others wait on; repeated names take a
    sequence suffix, as JAX's use-once barrier ids do."""
    if not _grouped():
        return
    world = dist.get_world_size()
    seq = _barrier_seq[name] = _barrier_seq.get(name, -1) + 1
    key = f"rrtpu:{name}:{seq}"
    store = dist.distributed_c10d._get_default_store()
    if store.add(key, 1) == world:
        store.set(key + ":go", "1")
    store.wait([key + ":go"], datetime.timedelta(seconds=timeout_s))


def local_shard(items: Sequence) -> list:
    from reflecting_reality_tpu_torch.parallel.mesh import split_between_processes

    return split_between_processes(items)


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    out, cur, n = [], [], 0
    for t in tensors:
        if cur and (n + t.numel() > BUCKET_ELEMENTS or t.dtype != cur[0].dtype
                    or t.device != cur[0].device):
            out.append(cur)
            cur, n = [], 0
        cur.append(t)
        n += t.numel()
    if cur:
        out.append(cur)
    return out


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: flattened
    into buckets of up to BUCKET_ELEMENTS, one `all_reduce` a bucket.  A
    no-op without a group."""
    if not _grouped():
        return
    world = dist.get_world_size()
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat /= world
        torch._foreach_copy_(bucket, [v.view_as(t) for v, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])


@torch.no_grad()
def broadcast_from_main(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite each tensor with rank 0's, in place (DDP's start-up
    broadcast of the parameters); a no-op without a group."""
    if not _grouped():
        return
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.broadcast(flat, src=0)
        torch._foreach_copy_(bucket, [v.view_as(t) for v, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])
