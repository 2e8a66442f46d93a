"""% of the program's `rr.unet#<id>` ranges in the traced window (one a
denoise step) that hold a CUDA graph launch (`cudaGraphLaunch` or
`cuGraphLaunch`) on their thread: the steps whose UNet ran as a replayed
graph.  0 on a program that launches the UNet eagerly; None without the
ranges."""

import bisect
from collections import defaultdict

GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def read(run):
    if run.trace_obj is None:
        return None
    ranges = [e for e in run.trace_obj.cpu_ops if e["name"].startswith("rr.unet#")]
    if not ranges:
        return None
    launches = defaultdict(list)
    for c in run.trace_obj.host_calls:
        if c["name"] in GRAPH_LAUNCHES:
            launches[(c.get("pid"), c.get("tid"))].append(c["ts"])
    for ts in launches.values():
        ts.sort()
    held = 0
    for r in ranges:
        ts = launches.get((r.get("pid"), r.get("tid")), [])
        i = bisect.bisect_left(ts, r["ts"])
        held += i < len(ts) and ts[i] <= r["ts"] + r["dur"]
    return 100.0 * held / len(ranges)
