"""The closed-loop client, run as a child process of a saturated serving
cell:

    python -m bench_h100.loadgen_closed URL PARAMS_JSON SEED SECONDS KEEP_IDS

It builds the JSON payloads of `params["requests"]` requests first (the
same payloads as `loadgen.py`), prints `ready` and reads the window's
start on the shared monotonic clock from its standard input.  Then
`params["callers"]` threads each send a request, wait for its reply and
send the next (the requests taken in order from one shared counter), until
the window's `SECONDS` have passed; the replies of requests in flight then
are awaited.  It prints one JSON object: for each request sent, its caller,
send and done times and HTTP status, and the served images of the requests
in KEEP_IDS.
"""

from __future__ import annotations

import http.client
import itertools
import json
import sys
import threading
import time
from urllib.parse import urlparse

from bench_h100 import traffic
from bench_h100.loadgen import WAIT_AFTER_CLOSE_S, payload


def main(argv) -> int:
    url, params, seed, seconds, keep = argv
    params, seed, seconds = json.loads(params), int(seed), float(seconds)
    keep = {int(i) for i in keep.split(",") if i}
    host = urlparse(url)
    reqs = traffic.requests(params, seed, int(params["requests"]))
    bodies = [payload(r, params) for r in reqs]
    print("ready", flush=True)
    t0 = float(sys.stdin.readline())
    ids, lock = itertools.count(), threading.Lock()
    results = []

    def caller(c: int) -> None:
        conn = http.client.HTTPConnection(host.hostname, host.port,
                                          timeout=seconds + WAIT_AFTER_CLOSE_S)
        while time.perf_counter() < t0 + seconds:
            with lock:
                i = next(ids)
            if i >= len(reqs):
                print(f"caller {c}: the {len(reqs)} requests ran out", file=sys.stderr)
                break
            rec = {"id": i, "caller": c, "sent": time.perf_counter(), "status": None}
            try:
                conn.request("POST", "/generate", body=bodies[i],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                rec["done"], rec["status"] = time.perf_counter(), resp.status
                if resp.status == 200 and i in keep:
                    rec["images"] = json.loads(body)["images"]
                elif resp.status != 200:
                    rec["error"] = body[:300].decode(errors="replace")
            except Exception as e:               # counted as failed
                rec["done"], rec["error"] = time.perf_counter(), f"{type(e).__name__}: {e}"
                conn.close()
                conn = http.client.HTTPConnection(host.hostname, host.port,
                                                  timeout=seconds + WAIT_AFTER_CLOSE_S)
            with lock:
                results.append(rec)
        conn.close()

    while time.perf_counter() < t0:
        time.sleep(0.001)
    threads = [threading.Thread(target=caller, args=(c,), daemon=True)
               for c in range(int(params["callers"]))]
    for t in threads:
        t.start()
    deadline = t0 + seconds + WAIT_AFTER_CLOSE_S
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    with lock:
        out = sorted(results, key=lambda r: r["id"])
    print(json.dumps({"requests": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
