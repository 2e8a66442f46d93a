"""Serving entry point of the port: a minimal HTTP inference server around
the MirrorFusion pipeline (counterpart of `reflecting_reality_tpu/cli/serve.py`).
Pure stdlib (http.server) in front of `StableDiffusionBrushNetPipeline` on
the card (kernels B1 and B2).

One server for every --max_batch: handler threads (ThreadingHTTPServer)
enqueue requests and one worker drains up to --max_batch compatible ones
into ONE batched pipeline call (see BatchingPipelineServer); --max_batch 1
(the default) serves one request at a time, and --max_queue's 503 holds at
every batch size.  The batch runs as it is: JAX pads it to a power-of-2
bucket to bound its compiles, and the port compiles nothing per shape.

API (JSON in, JSON out; images as base64 PNG or nested float lists):

  GET  /healthz           -> {"status": "ok", "device": "<card name>", "requests": N, ...}
  POST /generate          body: {
      "prompt": str,                       required
      "image": b64 PNG | [[..]],          required (masked image)
      "mask": b64 PNG | [[..]],           required (white = mirror region)
      "depth": b64 PNG | [[..]],          when the model is depth-conditioned
      "normals": ...,                      per normals_conditioning_mode
                                           (ip_adapter: the (1, 3) mean normal)
      "num_inference_steps": int = 50, "guidance_scale": float = 7.5,
      "seed": int = 0, "num_images_per_prompt": int = 1,
      "scheduler": "unipc" | "ddim", "dispatch": "scan" | "per_step",
      "deterministic_vae_encode": bool = false,
    }                      -> {"images": [b64 PNG, ...], "latency_s": float}

Start on the card:
    python -m reflecting_reality_tpu_torch.cli.serve \
        --base_model_path BASE --brushnet_path CKPT/brushnet \
        --depth_conditioning_mode concat [--max_batch 4] [--port 8000] [--warmup 512]
and query it:
    curl http://127.0.0.1:8000/healthz

Every flag of the JAX parser is kept.  `--device` is added (default
`cuda`, raising without a card; `cpu` runs the plain PyTorch paths).
`--int8` serves the W8A8 int8 mode (`ops/quant.py`, the default selection
policy; approximate); every request of a batch shares one activation scale
per layer, as in JAX.  `--data_parallel` (JAX :453-458) splits each
batched call over the visible cards (`enable_data_parallel(make_mesh())`;
the CPU is one device), the batch padded with copies of its last request
until it divides by the card count and the padded images dropped (JAX
:318-331).  `--attention_backend xla` puts every attention of the UNet,
BrushNet and VAE on the plain einsum-softmax path (set on those modules, so
it holds for every request thread and replica; the default `flash` sends
the long self-attentions to kernel B1 on the card).
`--compilation_cache_dir` builds and loads the kernel libraries there
(`core/jit_cache.py`).
"""

from __future__ import annotations

import argparse
import base64
import io
import itertools
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from reflecting_reality_tpu_torch.core import tracing

logger = logging.getLogger(__name__)



def _decode_image(value, channels: Optional[int] = None) -> np.ndarray:
    """b64-PNG string, nested lists, or ndarray -> float32 HWC in [0, 1]
    ([-1, 1] arrays pass through untouched).  A 16-bit PNG is divided by
    65535, other integer images by their dtype's maximum."""
    if isinstance(value, str):
        from PIL import Image

        img = Image.open(io.BytesIO(base64.b64decode(value)))
        arr = np.asarray(img)
        if img.mode in ("I", "I;16", "I;16B", "I;16L", "I;16N"):
            arr = arr.astype(np.float32) / 65535.0
        elif np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32) / float(np.iinfo(arr.dtype).max)
        else:
            arr = arr.astype(np.float32)
    else:
        arr = np.asarray(value, np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if channels is not None and arr.shape[-1] != channels:
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, channels, axis=-1)
        else:
            arr = arr[..., :channels]
    return arr


def _encode_png(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


DISPATCHES = ("scan", "per_step")


def _parse_payload(payload: dict, pipe, default_steps: int,
                   default_dispatch: str = "scan") -> dict:
    """A /generate request -> pipeline kwargs (in the handler thread, so the
    PNG decode overlaps the card's work on other requests).  `dispatch` is
    checked here; the port runs one step at a time for either value."""
    dispatch = payload.get("dispatch", default_dispatch)
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, got {dispatch!r}")
    depth = payload.get("depth")
    if depth is not None:
        depth = _decode_image(depth, channels=1)
    normals = payload.get("normals")
    if normals is not None and pipe.normals_conditioning_mode != "ip_adapter":
        normals = _decode_image(normals, channels=3)
    elif normals is not None:
        normals = np.asarray(normals, np.float32)
    return dict(
        prompt=payload["prompt"],
        image=_decode_image(payload["image"], channels=3),
        mask=_decode_image(payload["mask"], channels=3),
        depth=depth,
        normals=normals,
        num_inference_steps=int(payload.get("num_inference_steps", default_steps)),
        guidance_scale=float(payload.get("guidance_scale", 7.5)),
        negative_prompt=payload.get("negative_prompt"),
        seed=int(payload.get("seed", 0)),
        num_images_per_prompt=int(payload.get("num_images_per_prompt", 1)),
        scheduler=payload.get("scheduler", "unipc"),
        dispatch=dispatch,
        deterministic_vae_encode=bool(payload.get("deterministic_vae_encode", False)),
    )


class OverloadedError(RuntimeError):
    """Raised when the pending-request queue is full (served as HTTP 503)."""


class _Pending:
    """One queued /generate request: parsed kwargs + a completion event;
    its id, its enqueue time and its `rr.serve.request` span's id (None
    while spans are not recorded) for the queue-wait span."""

    __slots__ = ("parsed", "event", "images", "error", "batch_size", "id", "span_id",
                 "t_enqueued_ns", "batch")

    def __init__(self, parsed, rid: Optional[int] = None, span_id: Optional[int] = None):
        self.parsed = parsed
        self.event = threading.Event()
        self.images = None
        self.error = None
        self.batch_size = 0
        self.id, self.span_id, self.batch = rid, span_id, None
        self.t_enqueued_ns = time.perf_counter_ns()


class BatchingPipelineServer:
    """Micro-batching front end for the one-card pipeline.

    While one batch denoises, new requests accumulate in a queue; when the
    worker frees up it drains up to `max_batch` COMPATIBLE requests (same
    image shape, steps, guidance, scheduler, ...) into one batched pipeline
    call, run at the batch's own size.  `dispatch` is no part of
    compatibility: both values run the same loop here.

    Per-request seeds are honoured exactly: the worker draws each request's
    initial noise as its solo call does (the first draw of a generator
    seeded with its seed) and passes the stacked noise as `latents`.  The
    stochastic VAE encode of the conditioning images then draws from the
    first request's generator, so a batch of one is its solo call; in a
    larger batch the other requests' encode noise differs from their solo
    calls' (send "deterministic_vae_encode": true for solo-equal results).
    Incompatible requests go back to the queue and are served in a later
    batch: arrival order holds within a compatibility class, not globally.
    A failing batch delivers its error to each of its requests, and the
    worker goes on.

    A pipeline on a card serves on CUDA graphs (`enable_cuda_graphs`): the
    server lives long and its batches take few step shapes, so each shape's
    graphs are captured once (by `warmup`, or by the first batch of that
    shape) and replayed by every later step.  It keeps the graphs of
    2 x `max_batch` shapes, the least recently used dropped first: the
    batch sizes at one resolution, each at a guidance window's two
    conditioning scales, and what clients vary beyond that is captured
    anew, in bounded memory.

    Spans (`core/tracing.py`: recorded once enabled): `rr.serve.request` in the
    handler thread, from entry to the reply built (`rr.serve.encode`: its
    PNG encodes); `rr.serve.batch` around a batched call in the worker; and
    each request's `rr.serve.queue_wait`, from its enqueue to its batch's
    start.
    """

    def __init__(self, pipe, default_steps: int = 50, max_batch: int = 4,
                 max_queue: Optional[int] = None, batch_window_s: float = 0.0,
                 dispatch: str = "scan"):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.pipe = pipe
        if pipe.device.type == "cuda":
            pipe.enable_cuda_graphs(max_keys=2 * max_batch)
        self.default_steps = default_steps
        # the dispatch of requests that name none
        self.dispatch = dispatch
        self.requests = 0
        self.max_batch = max_batch
        self.max_queue = max_queue
        # > 0: a partial batch waits up to this long for compatible arrivals
        self.batch_window_s = batch_window_s
        self.batches = 0
        self.batched_requests = 0
        self.rejected = 0
        self._request_ids = itertools.count()
        self._batch_ids = itertools.count()
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True, name="serve-worker")
        self._worker.start()

    def stats(self) -> dict:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch_size": round(self.batched_requests / max(1, self.batches), 3),
            "queue_depth": self._queue.qsize(),
            "max_batch": self.max_batch,
            "rejected": self.rejected,
            "graphs": self.pipe.graph_stats(),
        }

    def close(self):
        self._queue.put(None)
        self._worker.join(timeout=30)

    # -- handler side ------------------------------------------------------

    def generate(self, payload: dict) -> dict:
        t0 = time.perf_counter()
        rid = next(self._request_ids)
        with tracing.span("rr.serve.request", request=rid) as request:
            if self.max_queue is not None and self._queue.qsize() >= self.max_queue:
                self.rejected += 1
                raise OverloadedError(f"queue full ({self.max_queue} pending); retry later")
            req = _Pending(_parse_payload(payload, self.pipe, self.default_steps, self.dispatch),
                           rid, request.id)
            self._queue.put(req)
            req.event.wait()
            if req.error is not None:
                raise req.error
            self.requests += 1
            request.set(batch=req.batch)
            with tracing.span("rr.serve.encode", request=req.id):
                images = [_encode_png(img) for img in req.images]
        return {"images": images, "latency_s": round(time.perf_counter() - t0, 3),
                "batch_size": req.batch_size}

    # -- worker side -------------------------------------------------------

    @staticmethod
    def _key(parsed: dict):
        """Requests sharing this key can share one batched call."""
        def shp(x):
            return None if x is None else tuple(np.shape(x))

        return (shp(parsed["image"]), shp(parsed["mask"]), shp(parsed["depth"]),
                shp(parsed["normals"]), parsed["num_inference_steps"],
                parsed["guidance_scale"], parsed["negative_prompt"],
                parsed["num_images_per_prompt"], parsed["scheduler"],
                parsed["deterministic_vae_encode"])

    def _drain(self, first: _Pending) -> list:
        """Up to max_batch requests compatible with `first`; incompatible
        ones go back to the queue's tail."""
        batch, putback = [first], []
        key = self._key(first.parsed)
        for _ in range(self._queue.qsize()):
            if len(batch) >= self.max_batch:
                break
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is not None and self._key(nxt.parsed) == key:
                batch.append(nxt)
            else:
                putback.append(nxt)          # the shutdown sentinel stays queued
        for item in putback:
            self._queue.put(item)
        return batch

    def _wait_window(self, batch, key):
        """Hold a partial batch up to batch_window_s for compatible
        arrivals; the others go back to the queue when the window closes."""
        deadline = time.perf_counter() + self.batch_window_s
        putback = []
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:                  # shutdown: keep it queued, stop waiting
                putback.append(nxt)
                break
            if self._key(nxt.parsed) == key:
                batch.append(nxt)
            else:
                putback.append(nxt)
        for item in putback:
            self._queue.put(item)
        return batch

    def _run(self):
        while True:
            first = self._queue.get()
            if first is None:
                return
            batch = self._drain(first)
            if self.batch_window_s > 0 and len(batch) < self.max_batch:
                batch = self._wait_window(batch, self._key(first.parsed))
            try:
                self._execute(batch)
            except Exception as e:           # delivered to every waiting handler
                for req in batch:
                    req.error = e
            finally:
                for req in batch:
                    req.event.set()

    def _execute(self, batch: list) -> None:
        bid = next(self._batch_ids)
        for req in batch:
            req.batch = bid
        with tracing.span("rr.serve.batch", batch=bid, requests=[r.id for r in batch],
                          size=len(batch)) as span:
            if span.id is not None:      # each request's wait ends as its batch starts
                for req in batch:
                    tracing.record("rr.serve.queue_wait", req.t_enqueued_ns, span.t0_ns,
                                   parent=req.span_id, request=req.id, batch=bid)
            self._call_pipeline(batch)

    def _call_pipeline(self, batch: list) -> None:
        pipe = self.pipe
        p0 = batch[0].parsed
        nip = p0["num_images_per_prompt"]
        n = len(batch)
        mesh = getattr(pipe, "_dp_mesh", None)
        if mesh is not None:
            # data-parallel generation splits batch_size = n * nip over the
            # mesh: pad with copies of the last request until it divides;
            # the padded outputs are dropped
            while (n * nip) % len(mesh):
                n += 1
        parsed = [r.parsed for r in batch] + [batch[-1].parsed] * (n - len(batch))

        def stack(name):
            vals = [q[name] for q in parsed]
            if vals[0] is None:
                return None
            out = np.stack(vals, axis=0)
            # per-prompt repeat, as encode_prompt repeats the embeds
            return np.repeat(out, nip, axis=0) if nip > 1 else out

        image = stack("image")
        h, w = image.shape[1:3]
        shape = (nip, pipe.unet.in_channels, h // pipe.vae_scale_factor,
                 w // pipe.vae_scale_factor)
        # each request's initial noise as its solo call draws it: the first
        # draw of a generator seeded with the request's seed
        gens = [torch.Generator(pipe.device).manual_seed(q["seed"]) for q in parsed]
        noise = torch.cat([torch.randn(shape, generator=g, device=pipe.device,
                                       dtype=torch.float32) for g in gens])
        out = pipe(
            prompt=[q["prompt"] for q in parsed],
            image=image,
            mask=stack("mask"),
            depth=stack("depth"),
            normals=stack("normals"),
            num_inference_steps=p0["num_inference_steps"],
            guidance_scale=p0["guidance_scale"],
            negative_prompt=p0["negative_prompt"],
            num_images_per_prompt=nip,
            generator=gens[0],               # the VAE encode's draws come next
            latents=noise.permute(0, 2, 3, 1),
            scheduler=p0["scheduler"],
            deterministic_vae_encode=p0["deterministic_vae_encode"],
        )
        for k, req in enumerate(batch):
            req.images = out[k * nip:(k + 1) * nip]
            req.batch_size = len(batch)
        self.batches += 1
        self.batched_requests += len(batch)


def make_handler(server: BatchingPipelineServer):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                dev = server.pipe.device
                name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
                self._reply(200, {"status": "ok", "device": name, **server.stats()})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                self._reply(200, server.generate(payload))
            except OverloadedError as e:
                self._reply(503, {"error": str(e)})
            except KeyError as e:
                self._reply(400, {"error": f"missing field: {e}"})
            except (json.JSONDecodeError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
            except Exception as e:           # the error goes back to the client
                logger.exception("generate failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *a):      # through logging, not stderr
            logger.info("%s " + fmt, self.address_string(), *a)

    return Handler


def build_pipeline(args):
    from reflecting_reality_tpu_torch.ops.attention import set_attention_backend
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[args.weight_dtype]
    pipe = StableDiffusionBrushNetPipeline.from_pretrained(
        args.base_model_path,
        brushnet_path=args.brushnet_path,
        unet_path=args.unet_path,
        depth_conditioning_mode=args.depth_conditioning_mode,
        normals_conditioning_mode=args.normals_conditioning_mode,
        dtype=dtype,
        device=args.device,
    )
    for m in (pipe.unet, pipe.brushnet, pipe.vae):
        set_attention_backend(m, args.attention_backend)
    if args.deep_cache:
        pipe.enable_deep_cache(args.deep_cache)
    if args.encoder_reuse:
        pipe.enable_encoder_reuse(args.encoder_reuse)
    if args.int8:
        pipe.enable_int8()
    if args.data_parallel:
        from reflecting_reality_tpu_torch.parallel.mesh import make_mesh

        pipe.enable_data_parallel(make_mesh(device_type=pipe.device.type))
    return pipe


def warmup(server: BatchingPipelineServer, resolution: int, steps: int, depth: bool,
           normals_mode: Optional[str] = None):
    """One solo call and, with --max_batch > 1, one full max_batch call
    before accepting traffic: the kernels build at their first launch and
    the convolutions pick their algorithms at each new shape."""
    logger.info("warmup: %dx%d at %d steps", resolution, resolution, steps)
    t0 = time.perf_counter()
    payload = {
        "prompt": "warmup",
        "image": np.zeros((resolution, resolution, 3), np.float32),
        "mask": np.ones((resolution, resolution, 3), np.float32),
        "num_inference_steps": steps,
    }
    if depth:
        payload["depth"] = np.zeros((resolution, resolution, 1), np.float32)
    if normals_mode in ("concat", "latents"):
        payload["normals"] = np.zeros((resolution, resolution, 3), np.float32)
    elif normals_mode == "ip_adapter":
        payload["normals"] = np.array([[0.0, 0.0, 1.0]], np.float32)
    server.generate(payload)
    if server.max_batch > 1:
        reqs = [_Pending(_parse_payload(dict(payload), server.pipe, steps))
                for _ in range(server.max_batch)]
        server._execute(reqs)
    logger.info("warmup done in %.1fs", time.perf_counter() - t0)


def build_parser():
    p = argparse.ArgumentParser(description="MirrorFusion HTTP inference server (PyTorch port)")
    p.add_argument("--base_model_path", type=str, required=True)
    p.add_argument("--brushnet_path", type=str, required=True)
    p.add_argument("--unet_path", type=str, default=None)
    p.add_argument("--depth_conditioning_mode", type=str, default=None,
                   choices=[None, "concat", "latents"])
    p.add_argument("--normals_conditioning_mode", type=str, default=None,
                   choices=[None, "concat", "latents", "ip_adapter"])
    p.add_argument("--weight_dtype", type=str, default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--deep_cache", type=int, default=None,
                   help="DeepCache interval (approximate, fewer UNet blocks per step)")
    p.add_argument("--encoder_reuse", type=int, default=None,
                   help="encoder-reuse interval (approximate; exclusive with --deep_cache)")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 serving (ops/quant.py): the UNet's and BrushNet's large "
                        "convs and projections in int8 with int32 accumulation; approximate")
    p.add_argument("--data_parallel", action="store_true",
                   help="split each batched call over the visible cards, the batch padded to "
                        "a multiple of the card count")
    p.add_argument("--max_batch", type=int, default=1,
                   help="micro-batching: drain up to N queued compatible requests into one "
                        "batched pipeline call. 1 = one request at a time")
    p.add_argument("--dispatch", type=str, default="scan", choices=["scan", "per_step"],
                   help="denoise dispatch of requests that name none; the port runs one "
                        "step at a time either way, so both give the same images")
    p.add_argument("--attention_backend", type=str, default="flash", choices=["flash", "xla"],
                   help="attention: 'flash' (kernel B1 for every attention on the card whose "
                        "head dim it takes; wider heads and the CPU take the plain path) or "
                        "'xla' (the plain einsum-softmax path everywhere)")
    p.add_argument("--batch_window", type=float, default=0.0,
                   help="with --max_batch > 1: hold a partial batch up to this many seconds "
                        "for more compatible requests before launching")
    p.add_argument("--max_queue", type=int, default=None,
                   help="backpressure: 503 new requests when this many are already pending")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--warmup", type=int, default=None, metavar="RES",
                   help="one warm-up call at this resolution before serving")
    p.add_argument("--compilation_cache_dir", type=str, default=None,
                   help="build and load the kernel libraries (nvcc's lib<name>-<hash>.so, "
                        "keyed by their sources) here instead of the package's _build "
                        "directories")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu' (the plain "
                        "PyTorch paths)")
    return p


def make_server(args, pipe) -> BatchingPipelineServer:
    return BatchingPipelineServer(pipe, default_steps=args.num_inference_steps,
                                  max_batch=args.max_batch, max_queue=args.max_queue,
                                  batch_window_s=args.batch_window, dispatch=args.dispatch)


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from reflecting_reality_tpu_torch.core.jit_cache import enable_compilation_cache

    enable_compilation_cache(args.compilation_cache_dir)
    pipe = build_pipeline(args)
    server = make_server(args, pipe)
    if args.warmup:
        warmup(server, args.warmup, args.num_inference_steps,
               depth=args.depth_conditioning_mode is not None,
               normals_mode=args.normals_conditioning_mode)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    logger.info("serving on http://%s:%d (max_batch=%d)", args.host, args.port, args.max_batch)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
