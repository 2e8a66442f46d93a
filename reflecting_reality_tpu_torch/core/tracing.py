"""The port's spans and its device-memory readout (the counterpart of
`reflecting_reality_tpu/training/profiling.py`).

Spans mark the program's layer boundaries: the server's queue and batches,
the pipeline's phases, BrushNet and the UNet, the training step's parts and
the loader's wait.  Recording is off by default; whoever embeds the program
(a benchmark, an operator) switches it on in code with `enable()` and
collects what was recorded with `take()`.  It is meant for profiling runs.

- Off, with no profiler running, `span(name, **attrs)` costs one
  module-level bool check and one call into torch (about 0.1 us), and
  returns one shared no-op object.
- Off, under a running `torch.profiler`, a span opens only the profiler
  range `name#id` and records nothing, so that a trace holds the program's
  layers whoever started the profiler.
- On, a span records `name`, `id`, the `parent` span's id (the innermost
  span open on the same thread), the thread's native id `tid`, `t0_ns` and
  `t1_ns` on `time.perf_counter_ns()` and its `attrs`, and it opens
  `torch.profiler.record_function(f"{name}#{id}")`.  Through that `#id` a
  reader pairs each record with its range in a profiler trace: the median
  of (range start - `t0_ns`) over the pairs maps the host clock onto the
  trace's, so spans kept in memory only (`record`) lie on the kernels'
  timeline too.
- `record(name, t0_ns, t1_ns, ...)` keeps a span that began on one thread
  and ended on another (a request's queue wait); it opens no range.
- The store keeps the last `MAX_RECORDS` records: past that the oldest are
  dropped, so a process that leaves recording on calls `take()` at least
  that often (a server at about 60 spans a second: every half hour).

`device_memory_stats()` gives each card's allocated, peak and reserved
memory.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

MAX_RECORDS = 100_000

_on = False
_records: "collections.deque[dict]" = collections.deque(maxlen=MAX_RECORDS)
_profiling = torch.autograd._profiler_enabled
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Record spans from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until `take()`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(rec: dict) -> None:
    with _lock:
        _records.append(rec)


class _NoSpan:
    """What `span` returns while tracing is off."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoSpan()


class _Range(_NoSpan):
    """What `span` returns while recording is off and a profiler runs: the
    range `name#id` alone."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = torch.profiler.record_function(f"{name}#{next(_ids)}")

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return None


class _Span:
    __slots__ = ("name", "id", "parent", "attrs", "t0_ns", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)

    def set(self, **attrs) -> None:
        """Attributes known only once the span has begun (a batch's id)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self._range = torch.profiler.record_function(f"{self.name}#{self.id}")
        self._range.__enter__()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _stack().pop()
        _keep({"name": self.name, "id": self.id, "parent": self.parent,
               "tid": threading.get_native_id(), "t0_ns": self.t0_ns, "t1_ns": t1_ns,
               "attrs": self.attrs})
        return None


def span(name: str, **attrs):
    """A context manager around one layer's work (see the module's doc)."""
    if _on:
        return _Span(name, attrs)
    return _Range(name) if _profiling() else _NOOP


def record(name: str, t0_ns: int, t1_ns: int, parent: Optional[int] = None, **attrs) -> None:
    """A span that began and ended on different threads, kept in memory only."""
    if not _on:
        return
    _keep({"name": name, "id": next(_ids), "parent": parent,
           "tid": threading.get_native_id(), "t0_ns": int(t0_ns), "t1_ns": int(t1_ns),
           "attrs": attrs})


def take() -> Dict[str, List[dict]]:
    """-> {"spans": [...]}: every span recorded since the last call, in the
    order they ended; the store is emptied."""
    with _lock:
        out = list(_records)
        _records.clear()
    return {"spans": out}


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
