"""The device trace: a `torch.profiler` window started and stopped from
the thread that drives the card, exported as a Chrome trace and read here.

- busy: the union of the device's operation intervals (kernels, copies,
  sets); the idle share is 1 - busy / the traced wall time.
- launches: the CUDA runtime and driver calls that launch a kernel or a
  graph.
- ranges: `record_function` ranges named `bench.<what>.<i>`; a range's
  device time is the time of every device operation whose launch (matched
  by the profiler's correlation id) falls inside it on its thread.
- breakdown: the device operations that took most time, and the longest
  idle gaps summed by the host call that launched the operation ending the
  gap.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Total length (in the intervals' unit) of the union of [start, end)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Trace:
    """A parsed Chrome trace (times in microseconds)."""

    def __init__(self, events: List[dict], wall_s: float):
        self.wall_s = wall_s
        self.device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.host_calls = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        self.cpu_ops = [e for e in events if e.get("ph") == "X"
                        and e.get("cat") in ("cpu_op", "user_annotation")]
        self.by_corr = defaultdict(list)
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                self.by_corr[corr].append(e)

    @classmethod
    def load(cls, path: str, wall_s: float) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data, wall_s)

    def busy_s(self) -> float:
        return union_seconds([(e["ts"], e["ts"] + e["dur"]) for e in self.device]) / 1e6

    def idle_share(self) -> Optional[float]:
        if not self.device or self.wall_s <= 0:
            return None
        return 1.0 - self.busy_s() / self.wall_s

    def launches(self) -> int:
        return sum(1 for e in self.host_calls if e["name"] in LAUNCH_NAMES)

    def range_device_s(self, prefix: str) -> Dict[str, float]:
        """{range name: device seconds of what it launched} for the ranges
        whose name starts with `prefix`."""
        ranges = [e for e in self.cpu_ops if e["name"].startswith(prefix)]
        by_tid = defaultdict(list)
        for e in self.host_calls:
            by_tid[(e.get("pid"), e.get("tid"))].append(e)
        for calls in by_tid.values():
            calls.sort(key=lambda e: e["ts"])
        out = {}
        for r in ranges:
            t0, t1 = r["ts"], r["ts"] + r["dur"]
            dev = 0.0
            for c in by_tid.get((r.get("pid"), r.get("tid")), ()):
                if c["ts"] < t0:
                    continue
                if c["ts"] > t1:
                    break
                corr = c.get("args", {}).get("correlation")
                dev += sum(k["dur"] for k in self.by_corr.get(corr, ()))
            out[r["name"]] = out.get(r["name"], 0.0) + dev / 1e6
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for e in self.device:
            ops[e["name"]] += e["dur"] / 1e6
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        # idle gaps, by the host call that launched the operation ending each
        launcher = {c.get("args", {}).get("correlation"): c for c in self.host_calls}
        ops_by_tid = defaultdict(list)
        for e in self.cpu_ops:
            ops_by_tid[(e.get("pid"), e.get("tid"))].append(e)
        starts = {}
        for key, ops in ops_by_tid.items():
            ops.sort(key=lambda e: e["ts"])
            starts[key] = [e["ts"] for e in ops]

        def host_label(kernel) -> str:
            call = launcher.get(kernel.get("args", {}).get("correlation"))
            if call is None:
                return "unattributed"
            key = (call.get("pid"), call.get("tid"))
            ops = ops_by_tid.get(key, [])
            # the latest-starting op that still spans the call is the innermost
            i = bisect.bisect_right(starts.get(key, []), call["ts"]) - 1
            for op in ops[max(i - 256, 0):i + 1][::-1]:
                if op["ts"] + op["dur"] >= call["ts"]:
                    return op["name"]
            return call["name"]

        gaps = []
        end = None
        for e in sorted(self.device, key=lambda e: e["ts"]):
            if end is not None and e["ts"] > end:
                gaps.append((e["ts"] - end, e))
            end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
        gaps.sort(key=lambda g: -g[0])
        by_label = defaultdict(float)
        for gap_us, kernel in gaps[:5000]:
            by_label[host_label(kernel)] += gap_us / 1e6
        idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in device_ops],
                "idle_gaps": [[n[:120], s] for n, s in idle]}


class ThreadProfiler:
    """A profiler window opened by `tick()` from the thread that drives the
    card (a module hook calls it), between `start_at` and `stop_at` on the
    host clock, or at most `max_ticks` ticks after it opened."""

    def __init__(self, start_at: float, stop_at: float, max_ticks: int = 10 ** 9):
        self.start_at, self.stop_at, self.max_ticks = start_at, stop_at, max_ticks
        self.prof = None
        self.t0 = self.t1 = None
        self.ticks = 0
        self.done = False

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def tick(self) -> None:
        if self.done:
            return
        now = time.perf_counter()
        if self.prof is None and now >= self.start_at:
            import torch
            from torch.profiler import ProfilerActivity, profile

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.prof is not None:
            self.ticks += 1
            if now >= self.stop_at or self.ticks >= self.max_ticks:
                self.stop()

    def stop(self) -> None:
        """Close the window; call it from the thread that opened it."""
        if self.prof is None or self.done:
            self.done = True
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.done = True

    def read(self) -> Optional[Trace]:
        """The window's trace, exported and parsed here: call it after the
        measured window, so that the export stalls nothing measured."""
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_h100_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return Trace.load(path, self.t1 - self.t0)
        finally:
            os.unlink(path)
            self.prof = None
