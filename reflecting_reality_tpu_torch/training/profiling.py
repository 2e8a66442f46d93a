"""Profiling and step-timing utilities, the port's counterpart of
`reflecting_reality_tpu/training/profiling.py`.

- `trace(logdir)`: `torch.profiler` around the wrapped steps (the card's
  kernels too, where there is one); writes a Chrome/Perfetto trace into
  `logdir` and yields the profiler for `key_averages()`.
- `StepTimer`: rolling steps/sec for the train loop.
- `device_memory_stats()`: per-card allocated / peak / reserved memory
  (`torch.cuda.memory_allocated`, `max_memory_allocated`, `memory_reserved`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class StepTimer:
    def __init__(self, window: int = 50):
        self.window = window
        self._t0 = time.time()
        self._count = 0
        self.steps_per_sec = 0.0

    def tick(self, n: int = 1) -> Optional[float]:
        """Call once per step; returns steps/sec when a window completes."""
        self._count += n
        if self._count >= self.window:
            dt = time.time() - self._t0
            self.steps_per_sec = self._count / dt
            self._t0 = time.time()
            self._count = 0
            return self.steps_per_sec
        return None


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """{"cuda:i": {bytes_in_use_gib, peak_bytes_in_use_gib, bytes_reserved_gib,
    bytes_limit_gib}}; empty without a card."""
    if not torch.cuda.is_available():
        return {}
    gib = 1024 ** 3
    out = {}
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use_gib": torch.cuda.memory_allocated(i) / gib,
            "peak_bytes_in_use_gib": torch.cuda.max_memory_allocated(i) / gib,
            "bytes_reserved_gib": torch.cuda.memory_reserved(i) / gib,
            "bytes_limit_gib": torch.cuda.get_device_properties(i).total_memory / gib,
        }
    return out
