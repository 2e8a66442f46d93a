"""The open-loop client, run as a child process of the serving cell:

    python -m bench_h100.loadgen URL PARAMS_JSON SEED SECONDS KEEP_IDS

It builds every request's JSON payload first (PNG image, mask and 16-bit
depth, from `traffic.py`), prints `ready`, reads the window's start on the
shared monotonic clock from its standard input, and sends each request at
its due time from a thread of its own, whether or not earlier ones have
finished.  When every reply is in (or has failed), it prints one JSON
object: for each request its due, send and done times and HTTP status, and
the served images of the requests in KEEP_IDS.
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from urllib.parse import urlparse

from bench_h100 import traffic

WAIT_AFTER_CLOSE_S = 60.0


def payload(req: dict, params: dict) -> bytes:
    arrs = traffic.request_arrays(req, int(params["resolution"]))
    return json.dumps({
        "prompt": req["prompt"], "image": traffic.png_b64(arrs["image"]),
        "mask": traffic.png_b64(arrs["mask"]), "depth": traffic.png_b64(arrs["depth"]),
        "seed": req["seed"], "num_inference_steps": int(params["num_inference_steps"]),
        "guidance_scale": float(params["guidance_scale"]),
        "deterministic_vae_encode": True,
    }).encode()


def main(argv) -> int:
    url, params, seed, seconds, keep = argv
    params, seed, seconds = json.loads(params), int(seed), float(seconds)
    keep = {int(i) for i in keep.split(",") if i}
    host = urlparse(url)
    reqs = traffic.open_loop_schedule(params, seed, seconds)
    bodies = [payload(r, params) for r in reqs]
    print("ready", flush=True)
    t0 = float(sys.stdin.readline())
    results = [None] * len(reqs)

    def send(i: int, due: float) -> None:
        rec = {"id": i, "due": due, "sent": time.perf_counter(), "status": None}
        try:
            conn = http.client.HTTPConnection(host.hostname, host.port,
                                              timeout=seconds + WAIT_AFTER_CLOSE_S)
            conn.request("POST", "/generate", body=bodies[i],
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            rec["done"] = time.perf_counter()
            rec["status"] = resp.status
            if resp.status == 200 and i in keep:
                rec["images"] = json.loads(body)["images"]
            elif resp.status != 200:
                rec["error"] = body[:300].decode(errors="replace")
            conn.close()
        except Exception as e:               # counted as failed
            rec["done"] = time.perf_counter()
            rec["error"] = f"{type(e).__name__}: {e}"
        results[i] = rec

    threads = []
    for i, r in enumerate(reqs):
        due = t0 + r["offset"]
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=send, args=(i, due), daemon=True)
        t.start()
        threads.append(t)
    deadline = t0 + seconds + WAIT_AFTER_CLOSE_S
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    out = [r if r is not None else {"id": i, "due": t0 + reqs[i]["offset"], "status": None,
                                    "error": "no reply a minute past the close"}
           for i, r in enumerate(results)]
    print(json.dumps({"requests": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
