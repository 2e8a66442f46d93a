"""The program's spans (`reflecting_reality_tpu_torch.core.tracing`) read
against the device trace, and a tool that runs a one-card cell with them:

    python3 -m bench_h100.spans --workload CELL --seed N --seconds S --trace 0|1

runs the cell as `bench_h100.run` does, with the program's span records
switched on from the end of warm-up (the run's "warm-up" mark) to the end
of the run, and prints one line in the entry's format.  With `--trace 0` it
holds the cell's end-to-end metrics, so that runs of the two entries give
what the records cost without a profiler; with `--trace 1` the cell's
per-layer metrics, the span metrics below and, in `breakdown`,
`idle_by_span` beside `idle_gaps`.  The cells' run modules are used
unchanged: the tool hands them a `ThreadProfiler` that keeps itself, for
the profiler's start and stop.

The metrics that need only the spans' profiler ranges, which a span opens
under any running profiler, are the benchmark's own (`metrics/
pipeline.brushnet_ms.img.py`, `metrics/train.optimizer_ms.train.py`).  The
ones here need the in-memory records, which only this tool switches on
(`SPAN_METRICS`; each None where its spans are missing):

- `serve.queue_wait_p50_s.lat` (s): median `rr.serve.queue_wait` over the
  requests whose batch started in the window before the profiler opened
  (the profiler slows the host and queues requests); its count goes to
  standard error.
- `serve.service_p50_s.lat` (s): median `rr.serve.batch` over those batches.
- `serve.request_p50_s.lat` (s): median `rr.serve.request`, the server's own
  time for a request from its arrival to its reply built, over the requests
  of those batches.
- `serve.encode_p50_ms.lat` (ms): median `rr.serve.encode`, a reply's PNG
  encodes, over the same requests.
- `device.idle_in_call_share.lat` (%): device idle inside the union of the
  `rr.pipeline.call` intervals within the traced window, over that union's
  length: the host-bound part of a call.
- `loader.wait_span_share.train` (%): the `rr.loader.wait` time inside the
  measured window over its length (`loader.wait_share.train` times
  `next()` from outside).

Clock: every span's profiler range is named `name#id`; the median of (range
start - the record's `t0_ns`) over the pairs maps the records onto the
trace's microseconds, so spans the trace lacks (opened before the profiler
started, or kept in memory only) lie on the kernels' timeline too.
"""

from __future__ import annotations

import bisect
import statistics
import sys
from collections import defaultdict
from typing import List, Optional, Tuple

from bench_h100 import harness
from bench_h100.run import Run, parse
from bench_h100.trace import ThreadProfiler

MEMORY_ONLY = ("rr.serve.queue_wait",)      # `tracing.record`: no range, crosses threads
CALLS = ("rr.pipeline.call", "rr.train.step")
BETWEEN, UNSPANNED = "(between calls)", "(unspanned)"
KINDS = ("serve_open_loop", "pipeline_closed_loop", "train_loop")


def clock_offset_us(trace, spans: List[dict]) -> Optional[float]:
    """Trace microseconds minus record microseconds, the median over the
    spans whose `name#id` range the trace holds; None without a pair."""
    starts = {e["name"]: e["ts"] for e in trace.cpu_ops if e["name"].startswith("rr.")}
    diffs = [starts[key] - s["t0_ns"] / 1e3 for s in spans
             if (key := f"{s['name']}#{s['id']}") in starts]
    return statistics.median(diffs) if diffs else None


def intervals(spans: List[dict], names, offset: float) -> List[Tuple[float, float]]:
    """The spans named in `names`, on the trace's clock (microseconds)."""
    return [(s["t0_ns"] / 1e3 + offset, s["t1_ns"] / 1e3 + offset)
            for s in spans if s["name"] in names]


def _merged(ivs) -> List[List[float]]:
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_within(trace, ivs, window: Tuple[float, float]) -> Tuple[float, float]:
    """-> (seconds the device was idle, seconds in all) within the union of
    the intervals `ivs` (trace microseconds) cut to `window`."""
    lo, hi = window
    region = _merged((max(s, lo), min(e, hi)) for s, e in ivs if min(e, hi) > max(s, lo))
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in trace.device)
    length = sum(e - s for s, e in region)
    overlap, j = 0.0, 0
    for s, e in region:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            overlap += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return (length - overlap) / 1e6, length / 1e6


def gaps(trace, top: int = 5000) -> List[Tuple[float, float, dict]]:
    """The device's idle gaps, longest first, as `Trace.breakdown` takes
    them: (start us, end us, the operation that ends the gap)."""
    out, end = [], None
    for e in sorted(trace.device, key=lambda e: e["ts"]):
        if end is not None and e["ts"] > end:
            out.append((end, e["ts"], e))
        end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
    out.sort(key=lambda g: g[0] - g[1])
    return out[:top]


class _Threads:
    """The records by thread on the trace's clock, for the innermost span
    open at a time on a thread."""

    def __init__(self, spans: List[dict], offset: float):
        self.by_id = {s["id"]: s for s in spans}
        self.by_tid = defaultdict(list)
        for s in spans:
            if s["name"] not in MEMORY_ONLY:
                self.by_tid[s["tid"]].append(s)
        self.starts = {}
        for tid, recs in self.by_tid.items():
            recs.sort(key=lambda s: s["t0_ns"])
            self.starts[tid] = [s["t0_ns"] / 1e3 + offset for s in recs]
        self.offset = offset

    def innermost(self, tid, t: float) -> Optional[dict]:
        """The innermost span of thread `tid` open at `t` (trace us): the
        latest-starting span that began by `t`, or the first of its
        ancestors that is still open (spans of one thread nest)."""
        i = bisect.bisect_right(self.starts.get(tid, []), t) - 1
        rec = self.by_tid[tid][i] if i >= 0 else None
        while rec is not None and rec["t1_ns"] / 1e3 + self.offset < t:
            rec = self.by_id.get(rec["parent"])
        return rec


def idle_by_span(trace, spans: List[dict], offset: float, top: int = 10) -> List[list]:
    """`idle_gaps`' gaps summed by the innermost program span open, on the
    launching thread, at the launch of the operation that ends each gap.
    A launch on a thread with no span open (autograd's backward thread, the
    loader's copy thread) goes to the innermost span then open on the
    thread that holds the enclosing `rr.pipeline.call`/`rr.train.step`.
    Without either: `(between calls)` where the gap overlaps no call or
    step, else `(unspanned)`.  Labels drop the `#id`."""
    threads = _Threads(spans, offset)
    # the trace's thread ids as the records' native ids, through the pairs
    native = {}
    by_key = {f"{s['name']}#{s['id']}": s for s in spans}
    for e in trace.cpu_ops:
        s = by_key.get(e["name"])
        if s is not None:
            native[(e.get("pid"), e.get("tid"))] = s["tid"]
    calls = sorted((s["t0_ns"] / 1e3 + offset, s["t1_ns"] / 1e3 + offset, s["tid"])
                   for s in spans if s["name"] in CALLS)
    launcher = {c.get("args", {}).get("correlation"): c for c in trace.host_calls}
    by_label = defaultdict(float)
    for start, end, op in gaps(trace):
        call = launcher.get(op.get("args", {}).get("correlation"))
        rec = None
        if call is not None:
            t = call["ts"]
            key = (call.get("pid"), call.get("tid"))
            rec = threads.innermost(native.get(key, call.get("tid")), t)
            if rec is None:
                holder = [c for c in calls if c[0] <= t <= c[1]]
                rec = threads.innermost(holder[0][2], t) if holder else None
        if rec is not None:
            label = rec["name"]
        elif any(c[0] < end and start < c[1] for c in calls):
            label = UNSPANNED
        else:
            label = BETWEEN
        by_label[label] += (end - start) / 1e6
    return [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]


def pre_profiler_batches(ctx) -> List[dict]:
    """The `rr.serve.batch` records that started in the window before the
    profiler opened."""
    lo, hi = ctx.window_t0_s * 1e9, ctx.profiler_t0_s * 1e9
    return [s for s in ctx.spans if s["name"] == "rr.serve.batch" and lo <= s["t0_ns"] < hi]


def queue_wait_p50_s(ctx) -> Optional[float]:
    batches = {s["attrs"]["batch"] for s in pre_profiler_batches(ctx)}
    waits = [(s["t1_ns"] - s["t0_ns"]) / 1e9 for s in ctx.spans
             if s["name"] == "rr.serve.queue_wait" and s["attrs"]["batch"] in batches]
    print(f"serve.queue_wait_p50_s.lat: {len(waits)} requests in {len(batches)} batches "
          f"before the profiler opened", file=sys.stderr)
    return statistics.median(waits) if waits else None


def service_p50_s(ctx) -> Optional[float]:
    batches = pre_profiler_batches(ctx)
    if not batches:
        return None
    return statistics.median((s["t1_ns"] - s["t0_ns"]) / 1e9 for s in batches)


def _pre_profiler_requests(ctx) -> List[dict]:
    batches = {s["attrs"]["batch"] for s in pre_profiler_batches(ctx)}
    return [s for s in ctx.spans
            if s["name"] == "rr.serve.request" and s["attrs"].get("batch") in batches]


def request_p50_s(ctx) -> Optional[float]:
    reqs = _pre_profiler_requests(ctx)
    return statistics.median((s["t1_ns"] - s["t0_ns"]) / 1e9 for s in reqs) if reqs else None


def encode_p50_ms(ctx) -> Optional[float]:
    reqs = {s["id"] for s in _pre_profiler_requests(ctx)}
    ms = [(s["t1_ns"] - s["t0_ns"]) / 1e6 for s in ctx.spans
          if s["name"] == "rr.serve.encode" and s["parent"] in reqs]
    return statistics.median(ms) if ms else None


def idle_in_call_share(ctx) -> Optional[float]:
    if ctx.window_us is None or not ctx.trace.device:
        return None
    idle, length = idle_within(ctx.trace, intervals(ctx.spans, ("rr.pipeline.call",), ctx.offset),
                               ctx.window_us)
    return 100.0 * idle / length if length > 0 else None


def loader_wait_share(ctx) -> Optional[float]:
    if not ctx.window_s:
        return None
    lo = ctx.window_t0_s * 1e9
    hi = lo + ctx.window_s * 1e9
    waits = [(max(s["t0_ns"], lo), min(s["t1_ns"], hi)) for s in ctx.spans
             if s["name"] == "rr.loader.wait"]
    if not waits:
        return None
    return 100.0 * sum(max(0.0, t1 - t0) for t0, t1 in waits) / (hi - lo)


SPAN_METRICS = {
    "serve.queue_wait_p50_s.lat": ("s", queue_wait_p50_s, ("serve_open_loop",)),
    "serve.service_p50_s.lat": ("s", service_p50_s, ("serve_open_loop",)),
    "serve.request_p50_s.lat": ("s", request_p50_s, ("serve_open_loop",)),
    "serve.encode_p50_ms.lat": ("ms", encode_p50_ms, ("serve_open_loop",)),
    "device.idle_in_call_share.lat": ("%", idle_in_call_share, ("serve_open_loop",)),
    "loader.wait_span_share.train": ("%", loader_wait_share, ("train_loop",)),
}


class Spans:
    """What the span metrics read: the records, the trace, the clock offset,
    the traced window on the trace's clock, and the measured window's start
    (`perf_counter` seconds) and length."""

    def __init__(self, spans: List[dict], trace, profiler, window_t0_s: float,
                 window_s: Optional[float] = None):
        self.spans, self.trace = spans, trace
        self.offset = clock_offset_us(trace, spans) if trace is not None else None
        opened = profiler is not None and profiler.t0 is not None
        self.window_us = None
        if self.offset is not None and opened:
            self.window_us = (profiler.t0 * 1e6 + self.offset, profiler.t1 * 1e6 + self.offset)
        self.window_t0_s, self.window_s = window_t0_s, window_s
        self.profiler_t0_s = profiler.t0 if opened else float("inf")


class _KeptProfiler(ThreadProfiler):
    """The cells' profiler, which keeps the last one made for the tool."""

    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _KeptProfiler.last = self


class _SpanRun(Run):
    """A run whose program records spans from the end of warm-up on."""

    def mark(self, phase: str) -> None:
        super().mark(phase)
        if phase == "warm-up":
            from reflecting_reality_tpu_torch.core import tracing

            tracing.take()
            tracing.enable()


def main(argv=None, device=None, cfg: Optional[dict] = None, cell: Optional[dict] = None) -> int:
    """`device`, `cfg` and `cell` are for the CPU tests, as in `bench_h100.run`."""
    args = parse(argv)
    harness.use_caches()
    import torch

    from reflecting_reality_tpu_torch.core import tracing

    cell = cell or harness.load_cell(args.workload)
    if cell["kind"] not in KINDS:
        print(f"{args.workload}: the tool runs one-card cells of {KINDS}", file=sys.stderr)
        return 2
    if device is None:
        if not torch.cuda.is_available():
            print(f"{args.workload} needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    bench = harness.benchmark_json()
    run = _SpanRun(cell, cfg or harness.load_config(cell["config"]), args.seed, args.seconds,
                   bool(args.trace), torch.device(device))
    run.control = None
    drv = harness.driver(cell["kind"])
    _KeptProfiler.last = None
    saved = {m: m.ThreadProfiler for m in map(harness.driver, KINDS)}
    try:
        for m in saved:
            m.ThreadProfiler = _KeptProfiler
        drv.run(run)
    finally:
        for m, cls in saved.items():
            m.ThreadProfiler = cls
        tracing.disable()
    spans = tracing.take()["spans"]

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics, breakdown, extra = {}, None, {}
    if args.trace:
        for name in harness.per_layer_names(cell["name"], bench):
            value = harness.metric_reader(name)(run)
            if value is not None:
                metrics[name] = (value, units[name])
        ctx = Spans(spans, run.trace_obj, _KeptProfiler.last,
                    run.t_start + run.data.get("setup_s", 0.0), run.data.get("window_s"))
        for name, (unit, read, kinds) in SPAN_METRICS.items():
            value = read(ctx) if cell["kind"] in kinds else None
            if value is not None:
                metrics[name] = (value, unit)
        if run.trace_obj is not None:
            breakdown = run.trace_obj.breakdown()
            if ctx.offset is not None:
                breakdown["idle_by_span"] = idle_by_span(run.trace_obj, spans, ctx.offset)
            extra = {"busy_s": run.trace_obj.busy_s(), "window_s": run.trace_obj.wall_s}
    else:
        for name in harness.end_to_end_names(cell["name"], bench):
            if name in run.e2e:
                metrics[name] = (run.e2e[name], units[name])
    print(f"spans recorded: {len(spans)}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    info = (harness.device_info(torch, run.chips) if run.device.type == "cuda"
            else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    info.update(run.device_extra)
    harness.emit(run.correct, run.attempted, run.failed, metrics, info, run.checks, breakdown,
                 extra)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
