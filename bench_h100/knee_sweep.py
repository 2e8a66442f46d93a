"""The knee of a serving cell, found once by a sweep on the card:

    python3 -m bench_h100.knee_sweep --workload sd15-serve-poisson --seed N \
        --seconds 40 --rates 0.6,0.8,1.0,1.2,1.4

One set-up, then the cell's open-loop traffic at each rate in turn, each
for `--seconds`.  For each rate one JSON line: requests, failures, the
median and 90th-percentile latency, and the backlog's growth, the median
latency of the window's last third over its first third (about 1 while
the server keeps up; it grows with the queue past the knee).  The knee is
the highest rate whose backlog does not grow; the cell's fixed rate is
0.8 of it, written into the cell's file by hand.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from bench_h100 import harness
from bench_h100.drivers import serve_open_loop as serve


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="sd15-serve-poisson")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    harness.use_caches()
    import torch

    cell = harness.load_cell(args.workload)

    class Ctx:
        cfg, seed, device = harness.load_config(cell["config"]), args.seed, torch.device("cuda", 0)

    params = cell["params"]
    harness.build_kernels()
    pipe = serve.build_pipeline(Ctx, getattr(torch, Ctx.cfg["dtype"]))
    server, httpd, url = serve.start_server(pipe, params)
    serve.warm(pipe, params, int(params["resolution"]))
    serve.warm_http(server, int(params["resolution"]))
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        rp = dict(params, rate=rate)
        client = serve.start_client(url, rp, args.seed + k, args.seconds, [])
        before = (server.batches, server.batched_requests)
        results = serve.client_window(client, time.perf_counter() + 2.0, args.seconds)
        lat, failed = serve.latencies_of(results, args.seconds)
        due = sorted(zip((r["due"] for r in results), lat))
        third = max(1, len(due) // 3)
        growth = (statistics.median(x for _, x in due[-third:])
                  / statistics.median(x for _, x in due[:third]))
        batches = server.batches - before[0]
        print(json.dumps({"rate": rate, "requests": len(results), "failed": failed,
                          "p50_s": serve.quantile(lat, 0.5), "p90_s": serve.quantile(lat, 0.9),
                          "backlog_growth": growth,
                          "mean_batch": (server.batched_requests - before[1]) / max(batches, 1),
                          "gpu": torch.cuda.get_device_name(0)}), flush=True)
    httpd.shutdown()
    server.close()
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
