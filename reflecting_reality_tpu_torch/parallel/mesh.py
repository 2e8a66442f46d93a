"""The port's counterpart of `reflecting_reality_tpu/parallel/mesh.py`, so far
only `split_between_processes` (JAX :202-213).  A process is rank 0 of 1
unless the caller says otherwise; reading a `torch.distributed` rank comes
with multi-process runs (ROADMAP.md queue A, item 16)."""

from __future__ import annotations

from typing import Optional, Sequence


def split_between_processes(items: Sequence, process_index: Optional[int] = None,
                            process_count: Optional[int] = None) -> list:
    """Contiguous split of a work list across processes (the reference's
    PartialState.split_between_processes: near-equal contiguous chunks,
    earlier ranks take the remainder)."""
    idx = 0 if process_index is None else process_index
    n = 1 if process_count is None else process_count
    items = list(items)
    base, rem = divmod(len(items), n)
    start = idx * base + min(idx, rem)
    end = start + base + (1 if idx < rem else 0)
    return items[start:end]
