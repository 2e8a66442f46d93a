"""Device "meshes" of the port, the counterpart of
`reflecting_reality_tpu/parallel/mesh.py` (reference: train_brushnet_mirror.py
DDP, test_brushnet.py:163-168 PartialState.split_between_processes).

The reference's two kinds of parallelism map to:
- data-parallel training: one process per card under torchrun, gradients
  averaged by `torch.distributed` (`parallel/multihost.py`,
  `training/train_step.py`), where JAX runs one jitted program over a 1-D
  "data" mesh;
- data-parallel inference and the sharded VAE decodes inside one process:
  a mesh here is an ordered tuple of `torch.device`s (`make_mesh`), each
  entry holding one replica of the modules (`replicated`) and one part of
  the batch (`batch_sharding`, `shard_batch`); an entry may repeat a device,
  which then runs several parts in turn;
- work split across processes: `split_between_processes`, by the
  `torch.distributed` rank.

`put_tree`, `replicate_tree`, `fetch_tree` and `TransferStalled` of the JAX
module are not ported: they bound the in-flight transfers of a relayed TPU
link (like `core/jit_cache.py`, the JAX runtime's own machinery), and a
local card needs none.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              device_type: str = "cuda") -> Mesh:
    """The first `n_devices` visible devices of `device_type` (default: all
    of them; the CPU is one device), or the given `devices` in order
    (repeats allowed, e.g. ("cuda:0", "cuda:0") or ("cpu", "cpu")).  Raises
    when no card is visible and none is named."""
    if devices is None:
        if device_type == "cpu":
            devices = ["cpu"]
        else:
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=")
            devices = [f"cuda:{i}" for i in range(count)]
        if n_devices is not None:
            devices = devices[:n_devices]
    mesh = tuple(torch.device(d) for d in devices)
    if n_devices is not None and len(mesh) != n_devices:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, {len(mesh)} given")
    if not mesh:
        raise ValueError("make_mesh: an empty mesh")
    return tuple(torch.device(d.type, 0) if d.type == "cuda" and d.index is None else d
                 for d in mesh)


def batch_sharding(mesh: Mesh, batch_size: int) -> List[slice]:
    """The batch rows of each mesh entry: equal contiguous parts, in order.
    Raises unless `batch_size` divides by the mesh size."""
    n = len(mesh)
    if batch_size % n:
        raise ValueError(f"batch {batch_size} is not divisible by the mesh size ({n})")
    b = batch_size // n
    return [slice(i * b, (i + 1) * b) for i in range(n)]


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """A tensor split along dim 0 into the mesh's parts, each moved to its
    entry's device."""
    return [batch[s].to(d) for s, d in zip(batch_sharding(mesh, batch.shape[0]), mesh)]


def replicated(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One replica of `module` per mesh entry: the module itself on the
    entries of its own device, one copy per other device (shared by the
    entries that repeat it)."""
    own = next(module.parameters()).device
    copies: Dict[torch.device, torch.nn.Module] = {own: module}
    for d in mesh:
        if d not in copies:
            copies[d] = copy.deepcopy(module).to(d)
    return [copies[d] for d in mesh]


def split_between_processes(items: Sequence, process_index: Optional[int] = None,
                            process_count: Optional[int] = None) -> list:
    """Contiguous split of a work list across processes (the reference's
    PartialState.split_between_processes: near-equal contiguous chunks,
    earlier ranks take the remainder).  Rank and count come from
    `torch.distributed` when a group is initialized (rank 0 of 1
    otherwise); explicit arguments win."""
    from reflecting_reality_tpu_torch.parallel.multihost import rank_and_world

    rank, world = rank_and_world()
    idx = rank if process_index is None else process_index
    n = world if process_count is None else process_count
    items = list(items)
    base, rem = divmod(len(items), n)
    start = idx * base + min(idx, rem)
    end = start + base + (1 if idx < rem else 0)
    return items[start:end]
