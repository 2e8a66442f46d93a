"""Serving under open-loop load: the program's HTTP server
(`cli/serve.py`'s `BatchingPipelineServer` behind `make_handler`, on an
ephemeral port) fed by `bench_h100.loadgen` in a child process at the
cell's fixed rate.

End to end: `latency_p90_s`, the 90th percentile over every request due in
the window, each timed from its due time to its full reply (a failed one
counts as the longest wait).  The check: a sample of the served images,
drawn from the seed with the longest prompt in it, against the reference
run on the same inputs.
"""

from __future__ import annotations

import base64
import gc
import json
import subprocess
import sys
import threading
import time

import numpy as np

from bench_h100 import harness, traffic
from bench_h100.trace import ThreadProfiler

WAIT_S = 60.0


def quantile(xs, q: float) -> float:
    """Linear-interpolated quantile of the sorted values (numpy's default)."""
    xs = sorted(xs)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def build_pipeline(run, dtype):
    import torch

    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    cfg = run.cfg
    mods = harness.program_modules(cfg, run.seed, run.device, dtype)
    pipe = StableDiffusionBrushNetPipeline(
        vae=mods["vae"], text_encoder=mods["text_encoder"],
        tokenizer=HashTokenizer(vocab_size=cfg["text_encoder"]["vocab_size"]),
        unet=mods["unet"], brushnet=mods["brushnet"], depth_conditioning_mode="concat",
        scaling_factor=cfg["scaling_factor"], dtype=dtype, device=run.device)
    if getattr(run, "control", None) == "int8":      # the control: the program's int8 path
        pipe.enable_int8()
    return pipe


def warm(pipe, params: dict, px: int) -> None:
    """The cell's own shapes: batches 1..max_batch at the served size, two
    steps each, as the server's worker calls the pipeline."""
    import torch

    for b in range(1, int(params["max_batch"]) + 1):
        gens = [torch.Generator(pipe.device).manual_seed(k) for k in range(b)]
        noise = torch.cat([torch.randn((1, 4, px // 8, px // 8), generator=g, device=pipe.device)
                           for g in gens])
        z = np.zeros((b, px, px, 3), np.float32)
        pipe(prompt=["warm up"] * b, image=z, mask=np.ones_like(z), depth=z[..., :1],
             num_inference_steps=2, guidance_scale=float(params["guidance_scale"]),
             generator=gens[0], latents=noise.permute(0, 2, 3, 1),
             deterministic_vae_encode=True)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()


class StepClock:
    """UNet forward pre-hook: ticks the profiler and, in a traced run,
    records a CUDA event at each step's start; the VAE decode's pre-hook
    closes a pipeline call."""

    def __init__(self, pipe, profiler=None, events: bool = False):
        self.profiler, self.events_on = profiler, events
        self.call, self.events = 0, []
        self.recording = False
        self.handles = [pipe.unet.register_forward_pre_hook(self._step),
                        pipe.vae.decoder.register_forward_pre_hook(self._decode)]

    def _step(self, module, args):
        if self.profiler is not None:
            self.profiler.tick()
        if self.events_on and self.recording:
            import torch

            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append((self.call, e))

    def _decode(self, module, args):
        self.call += 1

    def step_ms(self):
        """Device-timeline ms between consecutive step starts of one call."""
        import torch

        if not self.events:
            return []
        torch.cuda.synchronize()
        return [a[1].elapsed_time(b[1]) for a, b in zip(self.events, self.events[1:])
                if a[0] == b[0]]

    def remove(self):
        for h in self.handles:
            h.remove()


def start_server(pipe, params: dict):
    """The program's server on an ephemeral port -> (server, httpd, url)."""
    from http.server import ThreadingHTTPServer

    from reflecting_reality_tpu_torch.cli.serve import BatchingPipelineServer, make_handler

    server = BatchingPipelineServer(pipe, default_steps=int(params["num_inference_steps"]),
                                    max_batch=int(params["max_batch"]),
                                    batch_window_s=float(params["batch_window_s"]))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return server, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def start_client(url: str, params: dict, seed: int, seconds: float, keep) -> subprocess.Popen:
    """The load generator, building its payloads while set-up goes on."""
    return subprocess.Popen(
        [sys.executable, "-m", "bench_h100.loadgen", url, json.dumps(params), str(seed),
         repr(float(seconds)), ",".join(map(str, keep))],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=str(harness.ROOT))


def client_window(client: subprocess.Popen, t0: float, seconds: float, on_start=None) -> list:
    """Start the client's schedule at t0, wait for every reply -> its records."""
    try:
        if client.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        client.stdin.write(f"{t0!r}\n")
        client.stdin.flush()
        while time.perf_counter() < t0:
            time.sleep(0.001)
        if on_start is not None:
            on_start()
        out, _ = client.communicate(timeout=seconds + WAIT_S + 60)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
    return json.loads(out.strip().splitlines()[-1])["requests"]


def warm_http(server, px: int) -> None:
    """The HTTP path once: handler, PNG decode and encode."""
    server.generate({"prompt": "warm up", "image": traffic.png_b64(np.zeros((px, px, 3), np.uint8)),
                     "mask": traffic.png_b64(np.full((px, px), 255, np.uint8)),
                     "depth": traffic.png_b64(np.zeros((px, px), np.uint16)),
                     "num_inference_steps": 2, "deterministic_vae_encode": True})


def latencies_of(results: list, seconds: float):
    """-> (latency of each request from its due time, failed count); a
    failed request counts as the longest wait."""
    latencies, failed = [], 0
    for r in results:
        if r.get("status") == 200:
            latencies.append(r["done"] - r["due"])
        else:
            failed += 1
            latencies.append(seconds + WAIT_S)
            print(f"request {r['id']} failed: {r.get('error')}", file=sys.stderr)
    return latencies, failed


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

    reqs = traffic.open_loop_schedule(params, run.seed, run.seconds)
    rng = traffic.rng_for(run.seed, 3)
    longest = max(range(len(reqs)), key=lambda i: len(reqs[i]["prompt"].split()))
    others = [i for i in range(len(reqs)) if i != longest]
    keep = sorted({longest, *rng.choice(others, size=min(len(others),
                                                         int(params["check_requests"]) - 1),
                                        replace=False).tolist()})
    client = start_client(url, params, run.seed, run.seconds, keep)
    warm(pipe, params, px)
    warm_http(server, px)
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
        clock.recording = True

    results = client_window(client, t0, run.seconds, on_start)
    clock.recording = False
    after = (server.batches, server.batched_requests)
    if profiler is not None and not profiler.done:
        # the profiler stops in the thread that started it: one more short
        # request through the worker, whose first step's hook closes it
        warm_http(server, px)

    latencies, failed = latencies_of(results, run.seconds)
    late = max((r["sent"] - r["due"] for r in results if "sent" in r), default=0.0)
    print(f"load generator ran at most {late * 1e3:.1f} ms late; {len(results)} requests, "
          f"{failed} failed", file=sys.stderr)
    run.attempted, run.failed = len(results), failed
    run.e2e = {"latency_p90_s": quantile(latencies, 0.9), "setup_s": run.data["setup_s"]}
    run.data.update(latencies=latencies, batches=after[0] - before[0],
                    batched_requests=after[1] - before[1], step_ms=clock.step_ms(),
                    profiler_steps=profiler.ticks if profiler else 0)
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


def check(run, reqs, by_id, keep, params) -> None:
    """The kept requests' served images against the reference's."""
    import torch

    limits = run.cell["limits"]
    run.check("failed_requests", run.failed, 0)
    px = int(params["resolution"])
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = harness.reference_modules(run.cfg, run.seed, run.device, torch.float32)
        worst = 0.0
        for i in keep:
            rec = by_id.get(i, {})
            if rec.get("status") != 200:
                worst = float("inf")
                continue
            served = traffic.png_decode(base64.b64decode(rec["images"][0]))
            arrs = traffic.request_arrays(reqs[i], px)
            image = ref_image(ref, reqs[i], arrs, params, run)
            gaps = traffic.image_gaps(served, image)
            sat = float(np.mean((image == 0) | (image == 255)))
            print(f"reading request {i}: {json.dumps(gaps)} (words "
                  f"{len(reqs[i]['prompt'].split())}; reference image mean "
                  f"{float(image.mean())!r} std {float(image.std())!r}, saturated {sat!r})",
                  file=sys.stderr)
            worst = max(worst, gaps["image_off4"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    run.check("image_off4", worst, limits["image_off4"])


def ref_image(ref, req, arrs, params, run) -> np.ndarray:
    from bench_h100.reference.sampling import generate_sd15

    mask = np.repeat(arrs["mask"][..., None], 3, -1).astype(np.float32) / 255.0
    img = generate_sd15(ref, req["prompt"], arrs["image"].astype(np.float32) / 255.0, mask,
                        arrs["depth"][..., None].astype(np.float32) / 65535.0, req["seed"],
                        int(params["num_inference_steps"]), float(params["guidance_scale"]),
                        run.device, run.cfg["scaling_factor"], run.cfg["text_encoder"]["vocab_size"])
    return img.cpu().numpy()
