"""Median latency over the same requests as `latency_p90_s`, each from its
due time to its full reply: a steadier statistic beside the tail."""

from bench_h100.drivers.serve_open_loop import quantile


def read(run):
    lat = run.data.get("latencies")
    return quantile(lat, 0.5) if lat else None
