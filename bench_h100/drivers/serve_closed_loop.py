"""Serving under backlog: the program's HTTP server
(`cli/serve.py`'s `BatchingPipelineServer`, CUDA graphs on as the server
turns them on) fed by `bench_h100.loadgen_closed` in a child process: the
cell's `callers` each send their next request when their reply arrives, so
with more callers than `max_batch` the server always finds a full batch
waiting.  The server's build, its warm-up and the image check are
`serve_open_loop`'s.

End to end: `images_per_s` over a window of whole batches.  The callers all
start at once, so the first batch holds whatever had arrived; the window
opens at that batch's last reply, when the loop is full, and closes at the
last reply of the first later batch whose last reply comes `--seconds` or
more after the opening.  Its images are the replies of the batches between
(the first left out, the closing one whole), which the benchmark tells
apart by a wrapper on the server's `_execute` that notes each batch's
requests and times.  The callers go on sending for `tail_s` past
`--seconds`, so every batch up to the close is as full as the backlog
makes it.  A failed request counts in `failed` and the check's
`failed_requests`.  `setup_s` runs to the callers' start, which waits for
the client to build its payloads.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

from bench_h100 import harness, traffic
from bench_h100.drivers.serve_open_loop import (
    WAIT_S, StepClock, build_pipeline, check, start_server, warm, warm_http,
)
from bench_h100.trace import ThreadProfiler


def start_client(url: str, params: dict, seed: int, seconds: float, keep) -> subprocess.Popen:
    """The closed-loop client, building its payloads while set-up goes on."""
    return subprocess.Popen(
        [sys.executable, "-m", "bench_h100.loadgen_closed", url, json.dumps(params), str(seed),
         repr(float(seconds)), ",".join(map(str, keep))],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=str(harness.ROOT))


def callers_window(client: subprocess.Popen, t0: float, seconds: float, on_start) -> list:
    """Start the ready client's callers at t0, wait for every reply -> its
    records."""
    try:
        client.stdin.write(f"{t0!r}\n")
        client.stdin.flush()
        while time.perf_counter() < t0:
            time.sleep(0.001)
        on_start()
        out, _ = client.communicate(timeout=seconds + WAIT_S + 60)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
    return json.loads(out.strip().splitlines()[-1])["requests"]


class BatchLog:
    """Each batch the server runs while `on`: its start and end on the
    host's clock and its requests, by (seed, prompt)."""

    def __init__(self, server):
        self.batches, self.on = [], False
        real = server._execute

        def execute(batch):
            t = time.perf_counter()
            try:
                real(batch)
            finally:
                if self.on:
                    self.batches.append({"start": t, "end": time.perf_counter(),
                                         "keys": [(r.parsed["seed"], r.parsed["prompt"])
                                                  for r in batch]})
        server._execute = execute


def window_of(results: list, batches: list, reqs: list, seconds: float):
    """-> (the window's opening, its close, images replied in it, failed
    requests).  The window opens at the last reply of the first batch and
    closes at the last reply of the first later batch whose last reply is
    `seconds` or more past the opening (the last batch where none is); its
    images are the replies of the batches after the first up to the
    closing one, whole."""
    by_key = {(reqs[r["id"]]["seed"], reqs[r["id"]]["prompt"]): r for r in results}
    replies = []                         # a batch: (its last reply, its replies that succeeded)
    for b in batches:
        recs = [by_key[k] for k in b["keys"] if k in by_key]
        if recs:
            replies.append((max(r["done"] for r in recs),
                            sum(1 for r in recs if r.get("status") == 200)))
    if len(replies) < 2:
        raise RuntimeError(f"the window needs two batches; the callers' requests made "
                           f"{len(replies)}")
    failed = sum(1 for r in results if r.get("status") != 200)
    start = close = replies[0][0]
    images = 0
    for done, ok in replies[1:]:
        close, images = done, images + ok
        if done >= start + seconds:
            break
    return start, close, images, failed


def run(run) -> None:
    import torch

    params = run.cell["params"]
    px = int(params["resolution"])
    dtype = getattr(torch, run.cfg["dtype"])
    on_card = run.device.type == "cuda"
    if on_card:
        harness.build_kernels()
    run.mark("kernels")
    pipe = build_pipeline(run, dtype)
    run.mark("weights")
    server, httpd, url = start_server(pipe, params)

    reqs = traffic.requests(params, run.seed, int(params["requests"]))
    # the images kept for the check come from the callers' first requests,
    # which every run sends: the longest prompt among them and others at random
    first = range(min(len(reqs), int(params["callers"])))
    rng = traffic.rng_for(run.seed, 3)
    longest = max(first, key=lambda i: len(reqs[i]["prompt"].split()))
    others = [i for i in first if i != longest]
    keep = sorted({longest, *rng.choice(others, size=min(len(others),
                                                         int(params["check_requests"]) - 1),
                                        replace=False).tolist()})
    sending_s = run.seconds + float(params["tail_s"])
    client = start_client(url, params, run.seed, sending_s, keep)
    warm(pipe, params, px)
    warm_http(server, px)
    log = BatchLog(server)
    # the client's payloads are set-up too: its callers start once they are built
    if client.stdout.readline().strip() != "ready":
        client.kill()
        raise RuntimeError("the load generator did not start")
    run.mark("warm-up")

    t0 = time.perf_counter() + 0.2
    profiler = None
    if run.trace:
        start = t0 + float(params["trace_offset_s"])
        profiler = ThreadProfiler(start, start + float(params["trace_seconds"]))
    clock = StepClock(pipe, profiler, events=run.trace and on_card)
    before = (server.batches, server.batched_requests)
    run.data["setup_s"] = t0 - run.t_start

    def on_start():
        clock.recording = log.on = True

    results = callers_window(client, t0, sending_s, on_start)
    clock.recording = log.on = False
    after = (server.batches, server.batched_requests)
    if profiler is not None and not profiler.done:
        warm_http(server, px)        # one more request through the worker closes it

    w0, w1, images, failed = window_of(results, log.batches, reqs, run.seconds)
    inside = [b for b in log.batches if w0 < b["end"] <= w1]
    service = sorted(b["end"] - b["start"] for b in inside)
    gaps = sorted(b["start"] - a["end"] for a, b in zip(inside, inside[1:]))
    print(f"{len(results)} requests from {params['callers']} callers, {failed} failed; "
          f"window from {w0 - t0:.3f} s: {images} replied in {w1 - w0:.3f} s by "
          f"{len(inside)} batches (mean {images / max(len(inside), 1):.3f}); a batch "
          f"{service[0]:.3f}-{service[-1]:.3f} s (median {service[len(service) // 2]:.3f}), "
          f"the worker idle between batches {sum(gaps):.3f} s; first batch "
          f"{len(log.batches[0]['keys'])}", file=sys.stderr)
    if w1 < w0 + run.seconds:
        print(f"the window closed early, at {w1 - w0:.3f} s: too short a tail_s",
              file=sys.stderr)
    for r in results:
        if r.get("status") != 200:
            print(f"request {r['id']} failed: {r.get('error')}", file=sys.stderr)
    run.attempted, run.failed = len(results), failed
    run.e2e = {"images_per_s": images / (w1 - w0), "setup_s": run.data["setup_s"]}
    run.data.update(window_s=w1 - w0, images=images, step_ms=clock.step_ms(),
                    batches=after[0] - before[0], batched_requests=after[1] - before[1])
    if profiler is not None:
        run.trace_obj = profiler.read()
    clock.remove()
    if on_card:
        run.device_extra["memory_peak_bytes"] = torch.cuda.max_memory_allocated(run.device)

    httpd.shutdown()
    httpd.server_close()
    server.close()
    del pipe, server, httpd
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check(run, reqs, {r["id"]: r for r in results}, keep, params)
