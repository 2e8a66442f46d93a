"""One caller in a closed loop: `StableDiffusionXLBrushNetPipeline` called
at batch 1 on the cell's requests in turn, each call sent when the last has
returned (the port has no SDXL server).

End to end: `images_per_s`, the images of every call the window finished
over the window's length; the window closes at the first completion at or
after `--seconds`, so no image is cut.

The check follows the program's own trajectory (50 steps of SDXL in bf16
part from an fp32 run's by chance on some seeds, so a free-running
comparison swings by orders of magnitude between seeds): for a sample of
the finished calls, drawn from the seed with the longest prompt in it, the
benchmark's hooks keep each step's UNet input and output; the reference
computes its UNet prediction at each of the program's step inputs
(`pred_gap`, the worst step's relative gap; the guided prediction's,
`eps_gap`, is printed beside it), and then replays the program's guided
predictions through its own UniPC from the same noise and decodes
(`replay_off4`, the share of the served image's values more than 4 levels
from that replay's).  The cell's limits name the numbers compared.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np

from bench_h100 import harness, traffic
from bench_h100.drivers.serve_open_loop import StepClock
from bench_h100.instrument import AttentionRanges, GroupNormRanges
from bench_h100.trace import ThreadProfiler


def build_pipeline(run, dtype):
    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
    from reflecting_reality_tpu_torch.pipelines.brushnet_sdxl_pipeline import (
        StableDiffusionXLBrushNetPipeline,
    )

    cfg = run.cfg
    mods = harness.program_modules(cfg, run.seed, run.device, dtype)
    tok = HashTokenizer(vocab_size=cfg["text_encoder"]["vocab_size"])
    pipe = StableDiffusionXLBrushNetPipeline(
        vae=mods["vae"], text_encoder=mods["text_encoder"],
        text_encoder_2=mods["text_encoder_2"], tokenizer=tok, tokenizer_2=tok,
        unet=mods["unet"], brushnet=mods["brushnet"], depth_conditioning_mode="concat",
        scaling_factor=cfg["scaling_factor"], dtype=dtype, device=run.device)
    if getattr(run, "control", None) == "int8":      # the control: the program's int8 path
        pipe.enable_int8()
    return pipe


def call(pipe, req: dict, params: dict, steps: int):
    """One request as a caller sends it: its own seed's noise, the
    deterministic encode -> (H, W, 3) uint8."""
    import torch

    px = int(params["resolution"])
    arrs = traffic.request_arrays(req, px)
    gen = torch.Generator(pipe.device).manual_seed(req["seed"])
    noise = torch.randn((1, 4, px // 8, px // 8), generator=gen, device=pipe.device)
    return pipe(prompt=[req["prompt"]], image=arrs["image"][None],
                mask=np.repeat(arrs["mask"][None, ..., None], 3, -1),
                depth=(arrs["depth"].astype(np.float32) / 65535.0)[None, ..., None],
                num_inference_steps=steps, guidance_scale=float(params["guidance_scale"]),
                generator=gen, latents=noise.permute(0, 2, 3, 1),
                deterministic_vae_encode=True)[0]


class Recorder:
    """Each UNet forward's input and output, by call, kept on the device
    (no synchronise): the program's trajectory for the check."""

    def __init__(self, unet):
        self.calls, self.on = [], False
        self.handles = [unet.register_forward_pre_hook(self._in),
                        unet.register_forward_hook(self._out)]

    def new_call(self) -> None:
        if self.on:
            self.calls.append([])

    def _in(self, module, args):
        if self.on:
            self.calls[-1].append([args[0].detach().clone(), None])

    def _out(self, module, args, out):
        if self.on:
            self.calls[-1][-1][1] = out.detach().clone()

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def run(run) -> None:
    import torch

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
        ranges = [AttentionRanges(lambda: profiler.active),
                  GroupNormRanges(lambda: profiler.active)]
    clock = StepClock(pipe, profiler, events=run.trace and on_card)
    clock.recording = True
    recorder = Recorder(pipe.unet)
    recorder.on = True
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
        for r in ranges or ():
            r.remove()
    if profiler is not None:
        profiler.stop()
        run.trace_obj = profiler.read()
    run.attempted = len(images)
    run.e2e = {"images_per_s": len(images) / (t1 - t0), "setup_s": run.data["setup_s"]}
    run.data.update(window_s=t1 - t0, images=len(images), step_ms=clock.step_ms(),
                    attention_calls=ranges[0].calls if ranges else {},
                    groupnorm_calls=ranges[1].calls if ranges else {})
    clock.remove()
    if on_card:
        run.device_extra["memory_peak_bytes"] = torch.cuda.max_memory_allocated(run.device)
    del pipe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check(run, reqs, images, recorder.calls, p)


def check(run, reqs, images, trajectories, p) -> None:
    """The sampled finished calls against the reference, along the
    program's own trajectory."""
    import torch

    from bench_h100.reference import models
    from bench_h100.reference.sampling import (
        UniPC, guided, scaled_linear_alphas_cumprod, sdxl_context, sdxl_pred, to_uint8,
    )

    done = list(range(len(images)))
    longest = max(done, key=lambda i: len(reqs[i % len(reqs)]["prompt"].split()))
    rng = traffic.rng_for(run.seed, 3)
    others = [i for i in done if i != longest]
    keep = sorted({longest, *rng.choice(others, size=min(len(others),
                                                         int(p["check_requests"]) - 1),
                                        replace=False).tolist()})
    px, steps, g = int(p["resolution"]), int(p["num_inference_steps"]), float(p["guidance_scale"])
    sf = run.cfg["scaling_factor"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    limits = run.cell["limits"]
    worst = dict.fromkeys(limits, 0.0)
    try:
        ref = harness.reference_modules(run.cfg, run.seed, run.device, torch.float32)
        sampler = UniPC(steps, scaled_linear_alphas_cumprod())
        for i in keep:
            req, traj = reqs[i % len(reqs)], trajectories[i]
            arrs = traffic.request_arrays(req, px)
            mask = np.repeat(arrs["mask"][..., None], 3, -1).astype(np.float32) / 255.0
            with torch.no_grad():
                ctx, added, cond2 = sdxl_context(
                    ref, req["prompt"], arrs["image"].astype(np.float32) / 255.0, mask,
                    arrs["depth"][..., None].astype(np.float32) / 65535.0, run.device, sf,
                    run.cfg["text_encoder"]["vocab_size"])
                eps_p, gaps, raw = [], [], []
                for k, (x_in, out) in enumerate(traj):
                    eps_p.append(guided(out, g))
                    pred_r = sdxl_pred(ref, ctx, added, cond2, x_in[:1].float(),
                                       sampler.timesteps[k])
                    eps_r = guided(pred_r, g)
                    gaps.append(float((eps_p[-1] - eps_r).norm() / eps_r.norm()))
                    raw.append(float((out.float() - pred_r).norm() / pred_r.norm()))
                gen = torch.Generator(run.device).manual_seed(req["seed"])
                x_t = torch.randn((1, 4, px // 8, px // 8), generator=gen, device=run.device)
                lat = sampler.run(x_t, lambda lat, k: eps_p[k])
                replay = {"fp32": to_uint8(ref["vae"].decode(lat / sf))[0].permute(1, 2, 0)}
                if getattr(run, "control", None):    # the decode's control: its fp8 twin
                    models.QUANT = "fp8"
                    try:
                        replay["fp8"] = to_uint8(ref["vae"].decode(lat / sf))[0].permute(1, 2, 0)
                    finally:
                        models.QUANT = None
            found = {"eps_gap": max(gaps), "eps_gap_median": float(np.median(gaps)),
                     "pred_gap": max(raw), "pred_gap_median": float(np.median(raw))}
            for k, img in replay.items():
                gaps_img = traffic.image_gaps(images[i], img.cpu().numpy())
                found["replay_off4" + ("" if k == "fp32" else "_fp8")] = gaps_img["image_off4"]
                found["replay_mae" + ("" if k == "fp32" else "_fp8")] = gaps_img["image_mae"]
            print(f"reading call {i}: {json.dumps(found)} (words {len(req['prompt'].split())}; "
                  f"{len(traj)} steps)", file=sys.stderr)
            for k in worst:
                worst[k] = max(worst[k], found[k])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for k, v in worst.items():
        run.check(k, v, limits[k])
