"""One caller in a closed loop on FLUX.1 Fill: `FluxFillPipeline` called at
batch 1 on the cell's requests in turn, each call sent when the last has
returned.

End to end: `images_per_s`, the images of every call the window finished
over the window's length; the window closes at the first completion at or
after `--seconds`, so no image is cut.

The check follows the program's own trajectory, as `pipeline_closed_loop`'s
does: the benchmark's hooks keep each transformer forward's latent input
(the first 64 of its 384 channels) and its velocity.  After the window the
program's modules are freed.  For a sample of the finished calls, drawn
from the seed with the longest prompt in it, the reference (float32, TF32
off) computes its own T5 and CLIP embeddings from the same ids (and frees
its T5), its own conditioning from the request's pixels, and its velocity
at the program's latents at `check_steps` steps spread over the call
(`pred_gap`, the worst relative L2 gap); then it replays the program's
velocities through its own Euler steps from the same noise and decodes in
float32 (`replay_off4`, the share of the program's image values more than
4 levels from that replay's).  Under the control (`control="fp8"`, which
`control_flux.py` passes) the reference computed in float8 takes the
program's place in both readings: its velocities at the program's latents,
and its decode of the replayed latents in place of the program's image.
"""

from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
import types

import numpy as np

from bench_h100 import harness, traffic
from bench_h100.drivers.serve_open_loop import StepClock
from bench_h100.instrument import AttentionRanges
from bench_h100.trace import ThreadProfiler

LATENT_CHANNELS = 64            # packed: 16 latent channels x 2 x 2


def program_modules(cfg: dict, seed: int, device, dtype) -> dict:
    """The program's four modules at the configuration's widths, filled
    from the seed a parameter at a time."""
    import torch

    from bench_h100.weights_flux import fill
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.flux_transformer import FluxTransformer2DModel
    from reflecting_reality_tpu_torch.models.t5 import T5EncoderModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    classes = {"transformer": FluxTransformer2DModel, "t5": T5EncoderModel,
               "clip": CLIPTextModel, "vae": AutoencoderKL}
    out = {}
    for kind, cls in classes.items():
        with torch.device("meta"):
            module = cls.from_config(cfg[kind])
        out[kind] = fill(kind, module, seed, device, dtype, d_kv=cfg[kind].get("d_kv", 0)).eval()
    return out


def reference_modules(cfg: dict, seed: int, device, kinds) -> dict:
    """The reference's modules in float32 with the same seeded values."""
    import torch

    from bench_h100.reference.flux import build
    from bench_h100.weights_flux import fill

    out = {}
    for kind in kinds:
        with torch.device("meta"):
            module = build(kind, cfg[kind])
        out[kind] = fill(kind, module, seed, device, torch.float32,
                         d_kv=cfg[kind].get("d_kv", 0)).eval()
    return out


def build_pipeline(run, dtype):
    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer, T5HashTokenizer
    from reflecting_reality_tpu_torch.pipelines.flux_fill_pipeline import FluxFillPipeline

    cfg = run.cfg
    mods = program_modules(cfg, run.seed, run.device, dtype)
    return FluxFillPipeline(
        transformer=mods["transformer"], vae=mods["vae"], text_encoder=mods["clip"],
        text_encoder_2=mods["t5"], tokenizer=HashTokenizer(vocab_size=cfg["clip"]["vocab_size"]),
        tokenizer_2=T5HashTokenizer(cfg["t5"]["vocab_size"], int(cfg["max_sequence_length"])),
        dtype=dtype, device=run.device, max_sequence_length=int(cfg["max_sequence_length"]))


def noise_for(req: dict, px: int, device):
    """A request's initial noise, the first draw of its own seed's generator."""
    import torch

    gen = torch.Generator(device).manual_seed(req["seed"])
    return torch.randn((1, 16, px // 8, px // 8), generator=gen, device=device), gen


def call(pipe, req: dict, params: dict, steps: int):
    """One request as a caller sends it -> (H, W, 3) uint8."""
    px = int(params["resolution"])
    arrs = traffic.request_arrays(req, px)
    noise, gen = noise_for(req, px, pipe.device)
    return pipe(prompt=[req["prompt"]], image=arrs["image"][None],
                mask=arrs["mask"][None, ..., None], num_inference_steps=steps,
                guidance_scale=float(params["guidance_scale"]), generator=gen,
                latents=noise.permute(0, 2, 3, 1), deterministic_vae_encode=True)[0]


class Recorder:
    """Each transformer forward's latent input and velocity, by call, kept
    on the device (no synchronise): the program's trajectory."""

    def __init__(self, transformer):
        self.calls, self.on = [], False
        self.handles = [transformer.register_forward_pre_hook(self._in),
                        transformer.register_forward_hook(self._out)]

    def new_call(self) -> None:
        if self.on:
            self.calls.append([])

    def _in(self, module, args):
        if self.on:
            self.calls[-1].append([args[0][..., :LATENT_CHANNELS].clone(), None])

    def _out(self, module, args, out):
        if self.on:
            self.calls[-1][-1][1] = out.detach().clone()

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def run(run) -> None:
    import torch

    # the port's FLUX modules first: a program without them fails here, at once
    from reflecting_reality_tpu_torch.pipelines import flux_fill_pipeline  # noqa: F401

    p = run.cell["params"]
    dtype = getattr(torch, run.cfg["dtype"])
    on_card = run.device.type == "cuda"
    if on_card:
        harness.build_kernels()
    run.mark("kernels")
    pipe = build_pipeline(run, dtype)
    run.mark("weights")
    reqs = traffic.requests(p, run.seed, int(p["requests"]))
    call(pipe, dict(reqs[0], prompt="warm up"), p, 2)      # the cell's shapes, once
    if on_card:
        torch.cuda.synchronize()
    run.mark("warm-up")

    profiler = ranges = None
    t0 = time.perf_counter()
    run.data["setup_s"] = t0 - run.t_start
    if run.trace:
        start = t0 + float(p["trace_offset_s"])
        profiler = ThreadProfiler(start, start + 3600.0, max_ticks=int(p["trace_steps"]))
        ranges = AttentionRanges(lambda: profiler.active)
    clock = StepClock(types.SimpleNamespace(unet=pipe.transformer, vae=pipe.vae), profiler,
                      events=run.trace and on_card)
    clock.recording = True
    recorder = Recorder(pipe.transformer)
    recorder.on = True
    before = pipe.stats()
    images = []
    try:
        while True:
            recorder.new_call()
            images.append(call(pipe, reqs[len(images) % len(reqs)], p,
                               int(p["num_inference_steps"])))
            if time.perf_counter() - t0 >= run.seconds:
                break
        t1 = time.perf_counter()
    finally:
        clock.recording = recorder.on = False
        recorder.remove()
        if ranges is not None:
            ranges.remove()
    if profiler is not None:
        profiler.stop()
        run.trace_obj = profiler.read()
    after = pipe.stats()
    steps = after["steps"] - before["steps"]
    joint = {k: after["attention"]["joint"][k] - before["attention"]["joint"][k]
             for k in ("flash", "plain")}
    print(f"pipeline counters over the window: {json.dumps(after)}; joint attentions a step: "
          f"{ {k: v / max(steps, 1) for k, v in joint.items()} }", file=sys.stderr)
    run.attempted = len(images)
    run.e2e = {"images_per_s": len(images) / (t1 - t0), "setup_s": run.data["setup_s"]}
    run.data.update(window_s=t1 - t0, images=len(images), step_ms=clock.step_ms(),
                    attention_calls=ranges.calls if ranges else {},
                    joint_attention_per_step={k: v / max(steps, 1) for k, v in joint.items()})
    clock.remove()
    if on_card:
        run.device_extra["memory_peak_bytes"] = torch.cuda.max_memory_allocated(run.device)
    del pipe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check(run, reqs, images, recorder.calls, p)


def _free(*mods) -> None:
    import torch

    for m in mods:
        m.to("meta")
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _precision(mode: str):
    """The reference computed in float32, or in float8 for the control."""
    from bench_h100.reference import models

    models.QUANT = "fp8" if mode == "fp8" else None
    try:
        yield
    finally:
        models.QUANT = None


def check(run, reqs, images, trajectories, p) -> None:
    """The sampled finished calls against the reference, along the
    program's own trajectory (under the control, the float8 reference's
    readings in the program's place)."""
    import torch

    from bench_h100.reference import flux

    done = list(range(len(images)))
    longest = max(done, key=lambda i: len(reqs[i % len(reqs)]["prompt"].split()))
    rng = traffic.rng_for(run.seed, 3)
    others = [i for i in done if i != longest]
    keep = sorted({longest, *rng.choice(others, size=min(len(others),
                                                         int(p["check_requests"]) - 1),
                                        replace=False).tolist()})
    px, steps, g = int(p["resolution"]), int(p["num_inference_steps"]), float(p["guidance_scale"])
    checked = sorted({int(k) for k in np.linspace(0, steps - 1, int(p["check_steps"])).round()})
    cfg, dev = run.cfg, run.device
    control = getattr(run, "control", None) == "fp8"
    modes = ("fp32", "fp8") if control else ("fp32",)
    who = "; the float8 reference in the program's place" if control else ""
    max_len = int(cfg["max_sequence_length"])
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    limits = run.cell["limits"]
    worst = dict.fromkeys(limits, 0.0)
    try:
        with torch.no_grad():
            ref = reference_modules(cfg, run.seed, dev, ("clip", "vae", "t5"))
            ctx = {}                         # (call, mode) -> (states, pooled, cond)
            for i in keep:
                req = reqs[i % len(reqs)]
                arrs = traffic.request_arrays(req, px)
                for mode in modes:
                    with _precision(mode):
                        ctx[i, mode] = flux.context(
                            ref, cfg, req["prompt"], arrs["image"].astype(np.float32) / 255.0,
                            (arrs["mask"] > 0).astype(np.float32), dev, max_len)
            _free(ref.pop("t5"))
            ref.update(reference_modules(cfg, run.seed, dev, ("transformer",)))
            for i in keep:
                req, traj = reqs[i % len(reqs)], trajectories[i]
                sig = flux.sigmas(steps, traj[0][0].shape[1])
                gaps = []
                for k in checked:
                    x_lat, v = traj[k]
                    v_ref = flux.velocity(ref, x_lat, *ctx[i, "fp32"], sig[k], g)
                    if control:
                        with _precision("fp8"):
                            v = flux.velocity(ref, x_lat, *ctx[i, "fp8"], sig[k], g)
                    gaps.append(float((v.float() - v_ref).norm() / v_ref.norm()))
                lat = flux.pack(noise_for(req, px, dev)[0])
                for k, (_, v) in enumerate(traj):
                    lat = flux.euler(lat, v, sig[k], sig[k + 1])
                replay = flux.decode(ref["vae"], cfg["vae"], lat, px).cpu().numpy()
                image = images[i]
                if control:
                    with _precision("fp8"):
                        image = flux.decode(ref["vae"], cfg["vae"], lat, px).cpu().numpy()
                img = traffic.image_gaps(image, replay)
                found = {"pred_gap": max(gaps), "pred_gap_median": float(np.median(gaps)),
                         "replay_off4": img["image_off4"], "replay_mae": img["image_mae"]}
                print(f"reading call {i}: {json.dumps(found)} (words "
                      f"{len(req['prompt'].split())}; {len(traj)} steps; checked {checked}{who})",
                      file=sys.stderr)
                for k in worst:
                    worst[k] = max(worst[k], found[k])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for k, v in worst.items():
        run.check(k, v, limits[k])
