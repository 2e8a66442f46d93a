#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. env     torch/CUDA versions, device name and compute capability, and
             `nvidia-smi --query-gpu=name,power.limit`.
  2. build   nvcc builds the CUDA kernel library from
             reflecting_reality_tpu_torch/ops/kernels/csrc while the Triton
             kernels compile; seconds for each.
  3. kernels every kernel against its plain PyTorch version on the card, at
             the shapes the main path gives it and a few it meets elsewhere
             (1024², 576x512, fp32 parity): max abs error in the working dtype
             and against fp32 and the relative L2 error, each with its
             tolerance; kernel, plain and library times; the roofline bound.
  4. slice   full-width SD-1.5 UNet + BrushNet(conditioning_channels=6), one
             denoise step's forward at 64x64 latents, batch 2, fp32 with TF32
             off: the card (kernels) against the CPU (plain versions).
  5. main    StableDiffusionBrushNetPipeline at full SD-1.5 width in bf16:
             512x512, CFG 7.5, UniPC, depth concat; a warm run, then timed
             4- and 8-step runs in turns, MAIN_REPEATS of each (medians;
             s/step is their two-point difference).  In every run the flash
             kernel must launch exactly 5 x steps times and the GroupNorm
             kernel at least once.
  6. profile one traced 4-step call: device busy time, idle share, device
             time by kind of kernel and the top kernels (torch.profiler).
Then `kernels_detail` (every measured kernel and shape with the launches the
main path's 8-step call gave that shape, 0 where it gave none), the
`{"kernels": [...]}` summary line (the kernels and shapes the main path
launched), the nvidia-smi name/power-limit line, and last
`{"ok": true, "device": {...}}`.  Any failed check raises and
the script exits non-zero; without a CUDA device it exits non-zero at once.
Weights are random, made from a seed.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
MAIN_REPEATS = 5                    # timed 4- and 8-step calls of each count
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core bf16
              "float32": 67e12}     # fp32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


# ---------------------------------------------------------------- phase 2

def phase_build(torch):
    from concurrent.futures import ThreadPoolExecutor

    from reflecting_reality_tpu_torch.ops.kernels import build
    from reflecting_reality_tpu_torch.ops.kernels.groupnorm import group_norm_silu_fwd

    lib = build.library_path("flash_attn_fwd")
    built_now = not lib.exists()
    t0 = time.perf_counter()

    def nvcc_build() -> float:
        build.load("flash_attn_fwd")
        return time.perf_counter() - t0

    # Triton compiles its variants (dtype x SiLU x fused/split) while nvcc runs
    with ThreadPoolExecutor(1) as pool:
        nvcc_done = pool.submit(nvcc_build)
        for dtype in (torch.bfloat16, torch.float32):
            for shape in ((2, 64, 8, 8), (1, 64, 256, 256)):
                x = torch.randn(shape, device="cuda", dtype=dtype)
                w = torch.ones(64, device="cuda", dtype=dtype)
                for silu in (False, True):
                    group_norm_silu_fwd(x, w, w, 32, 1e-5, silu)
        torch.cuda.synchronize()
        t_triton = time.perf_counter() - t0
        t_nvcc = nvcc_done.result()
    log = lib.with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "flash_attn_fwd_nvcc_s": round(t_nvcc, 2),
          "built_now": built_now, "groupnorm_triton_compile_s": round(t_triton, 2),
          "ptxas": ptxas})


# ---------------------------------------------------------------- phase 3

def check(entry: dict) -> None:
    bad = [k for k in ("max_abs_err", "max_abs_err_f32", "rel_l2_err", "lse_max_abs_err")
           if k in entry and not entry[k] <= entry[k.replace("err", "tol")]]
    if bad:
        raise AssertionError(f"{entry['name']}: {bad} over tolerance: {entry}")


def bench_flash(torch, shape, dtype) -> dict:
    import torch.nn.functional as F

    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa

    b, t, h, d = shape
    g = torch.Generator("cuda").manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=g, device="cuda", dtype=dtype) for _ in range(3))
    out, lse = fa.flash_attention_fwd(q, k, v)
    plain, plain_lse = fa.attention_plain(q, k, v, return_lse=True)
    ref32 = fa.attention_plain(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    diff = out.float() - plain.float()
    err = diff.abs().max().item()
    scale, scale32 = plain.float().abs().max().item(), ref32.abs().max().item()

    # randn q/k/v over thousands of keys give outputs of order T^-1/2 (max a
    # few tenths at T=4096), so the tolerances scale with the output.  bf16: P and
    # O round to bf16 at other points than in the plain path, which moves an
    # element by about one ulp: 4 bf16 ulps at the output's max.  fp32:
    # summation order only, 1e-4 of the max.
    def tol(s):
        return 4 * bf16_ulp(s) if bf16 else 1e-4 * s

    entry = {
        "name": f"flash_attn_fwd {'x'.join(map(str, shape))} {str(dtype)[6:]}",
        "key": ("flash", (tuple(shape), str(dtype)[6:])),
        "shape": list(shape), "dtype": str(dtype)[6:],
        "max_abs_err": err,
        "max_rel_err": err / scale,
        "max_abs_tol": tol(scale),
        "max_abs_err_f32": (out.float() - ref32).abs().max().item(),
        "max_abs_tol_f32": tol(scale32),
        "plain_max_abs_err_f32": (plain.float() - ref32).abs().max().item(),
        # a wrong P V fragment or 1/l moves the whole output, not one ulp
        "rel_l2_err": (diff.norm() / plain.float().norm()).item(),
        "rel_l2_tol": 1e-2 if bf16 else 1e-4,
        "lse_max_abs_err": (lse - plain_lse).abs().max().item(),
        "lse_max_abs_tol": 1e-4,
    }
    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    entry["ms"] = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v))
    entry["plain_ms"] = cuda_ms(torch, lambda: fa.attention_plain(q, k, v), iters=5)
    entry["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs))
    itemsize = q.element_size()
    nbytes = 4 * b * t * h * d * itemsize + b * h * t * 4
    entry["bound_ms"], entry["bound_by"] = bound(4.0 * b * h * t * t * d, nbytes,
                                                 entry["dtype"])
    return entry


def bench_groupnorm(torch, shape, dtype, silu) -> dict:
    import torch.nn.functional as F

    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

    g = torch.Generator("cuda").manual_seed(SEED)
    x = torch.randn(shape, generator=g, device="cuda", dtype=dtype) * 3.0 + 1.5
    c = shape[1]
    w = (1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
    bb = (0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
    y = gn.group_norm_silu_fwd(x, w, bb, 32, 1e-5, silu)
    plain = gn.group_norm_plain(x, w, bb, 32, 1e-5, silu)
    y32 = gn.group_norm_silu_fwd(x.float(), w.float(), bb.float(), 32, 1e-5, silu)
    ref32 = gn.group_norm_plain(x.float(), w.float(), bb.float(), 32, 1e-5, silu)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    scale = plain.float().abs().max().item()
    err = (y.float() - plain.float()).abs().max().item()
    entry = {
        "name": f"group_norm{'_silu' if silu else ''} {'x'.join(map(str, shape))} "
                f"{str(dtype)[6:]}",
        "key": ("groupnorm", (tuple(shape), str(dtype)[6:], silu)),
        "shape": list(shape), "dtype": str(dtype)[6:], "silu": silu,
        "max_abs_err": err,
        "max_rel_err": err / scale,
        # bf16: both round the same fp32 value; statistics that differ in the
        # last fp32 bits flip a rounding boundary: <= 2 bf16 ulps (2^-7 rel)
        "max_abs_tol": 2 * 2.0 ** -7 * scale if bf16 else 1e-5 * max(1.0, scale),
        "max_abs_err_f32": (y32 - ref32).abs().max().item(),
        "max_abs_tol_f32": 1e-5 * max(1.0, ref32.abs().max().item()),
    }

    def library():
        out = F.group_norm(x, 32, w, bb, 1e-5)
        return F.silu(out) if silu else out

    entry["ms"] = cuda_ms(torch, lambda: gn.group_norm_silu_fwd(x, w, bb, 32, 1e-5, silu))
    entry["plain_ms"] = cuda_ms(torch, lambda: gn.group_norm_plain(x, w, bb, 32, 1e-5, silu))
    entry["library_ms"] = cuda_ms(torch, library)
    n = x.numel()
    nbytes = 2 * n * x.element_size() + 2 * c * w.element_size()
    entry["bound_ms"], entry["bound_by"] = bound((12.0 if silu else 8.0) * n, nbytes, "float32")
    return entry


FLASH_SHAPES = [((2, 4096, 8, 40), "bfloat16"), ((2, 4096, 8, 80), "bfloat16"),
                ((2, 4608, 8, 40), "bfloat16"), ((1, 2048, 8, 160), "bfloat16"),
                ((2, 4096, 8, 40), "float32")]
GN_SHAPES = [(2, 320, 64, 64), (2, 2560, 16, 16), (2, 1280, 8, 8), (1, 512, 64, 64),
             (1, 128, 512, 512)]


def phase_kernels(torch):
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

    entries = []
    for shape, dt in FLASH_SHAPES:
        e = bench_flash(torch, shape, getattr(torch, dt))
        e.update(kernel="flash", route="cuda", source=fa.SOURCE, replaces=fa.REPLACES)
        entries.append(e)
    for shape in GN_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            for silu in (False, True):
                e = bench_groupnorm(torch, shape, dt, silu)
                e.update(kernel="groupnorm", route="triton", source=gn.SOURCE,
                         replaces=gn.REPLACES)
                entries.append(e)
    for e in entries:
        check(e)
    emit({"phase": "kernels", "checked": len(entries), "all_within_tolerance": True})
    return entries


# ---------------------------------------------------------------- phase 4/5

def fill_zero_convs(torch, brushnet, seed: int, std: float) -> None:
    """Small seeded values in BrushNet's 28 zero convs, so its injections
    carry signal."""
    g = torch.Generator(brushnet.conv_in_condition.weight.device).manual_seed(seed)
    convs = (list(brushnet.brushnet_down_blocks) + [brushnet.brushnet_mid_block]
             + list(brushnet.brushnet_up_blocks))
    with torch.no_grad():
        for conv in convs:
            for p in (conv.weight, conv.bias):
                p.copy_(torch.randn(p.shape, generator=g, device=p.device) * std)


def counters():
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

    return fa.flash_attention_fwd, gn.group_norm_silu_fwd


def reset_counters() -> None:
    for fn in counters():
        fn.launches = 0
        fn.launches_by_shape.clear()


def read_counters() -> dict:
    fa, gn = counters()
    return {"flash": fa.launches, "groupnorm": gn.launches}


def read_counters_by_shape() -> dict:
    """{(kernel, shape key): launches} since the last reset."""
    fa, gn = counters()
    return {**{("flash", k): n for k, n in fa.launches_by_shape.items()},
            **{("groupnorm", k): n for k, n in gn.launches_by_shape.items()}}


def phase_slice(torch):
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.ops.embeddings import precompute_time_embeddings

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        unet = UNet2DConditionModel().eval()
        brushnet = BrushNetModel(conditioning_channels=6).eval()
    fill_zero_convs(torch, brushnet, SEED, 0.02)
    g = torch.Generator("cuda").manual_seed(SEED + 1)
    lat = torch.randn(1, 4, 64, 64, generator=g, device="cuda")
    cond = torch.randn(1, 6, 64, 64, generator=g, device="cuda")
    ehs = torch.randn(2, 77, 768, generator=g, device="cuda")

    def step(unet, brushnet, lat, cond, ehs):
        t = [500]
        tb, tu = precompute_time_embeddings(brushnet, t), precompute_time_embeddings(unet, t)
        down, mid, up = brushnet(lat, None, ehs[1:], cond, temb=tb)
        down, mid, up = ([torch.cat([x, x]) for x in down], torch.cat([mid, mid]),
                         [torch.cat([x, x]) for x in up])
        return unet(torch.cat([lat, lat]), None, ehs, down_block_add_samples=down,
                    mid_block_add_sample=mid, up_block_add_samples=up, temb=tu)

    with torch.inference_mode():
        reset_counters()
        t0 = time.perf_counter()
        gpu = step(unet, brushnet, lat, cond, ehs)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        launched = read_counters()
        unet_c, bn_c = copy.deepcopy(unet).cpu(), copy.deepcopy(brushnet).cpu()
        t0 = time.perf_counter()
        cpu = step(unet_c, bn_c, lat.cpu(), cond.cpu(), ehs.cpu())
        t_cpu = time.perf_counter() - t0
    scale = cpu.abs().max().item()
    err = (gpu.cpu() - cpu).abs().max().item()
    # fp32 both sides, TF32 off: the difference is summation order through
    # ~130 conv/matmul layers and 2 networks
    tol = 1e-3 * scale
    res = {"phase": "slice_parity", "max_abs_err": err, "max_abs_tol": tol,
           "output_max_abs": scale, "finite": bool(torch.isfinite(gpu).all()),
           "launches": launched, "gpu_forward_s": round(t_gpu, 3),
           "cpu_forward_s": round(t_cpu, 3)}
    emit(res)
    if not (res["finite"] and err <= tol):
        raise AssertionError(f"slice parity failed: {res}")
    if launched["flash"] != 5 or launched["groupnorm"] == 0:
        raise AssertionError(f"slice forward did not run through the kernels: {launched}")
    del unet, brushnet, unet_c, bn_c
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()


def phase_main(torch, gpu_line: str):
    import numpy as np

    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    torch.manual_seed(SEED)
    with torch.device("cuda"):
        unet = UNet2DConditionModel()
        brushnet = BrushNetModel(conditioning_channels=6)
        vae = AutoencoderKL()
        text = CLIPTextModel()
    fill_zero_convs(torch, brushnet, SEED, 0.02)
    pipe = StableDiffusionBrushNetPipeline(
        vae=vae, text_encoder=text, tokenizer=HashTokenizer(vocab_size=49408), unet=unet,
        brushnet=brushnet, depth_conditioning_mode="concat", dtype=torch.bfloat16,
        device="cuda")
    rng = np.random.RandomState(SEED)
    image = rng.rand(512, 512, 3).astype(np.float32)
    mask = np.zeros((512, 512, 3), np.float32)
    mask[128:384, 160:352] = 1.0
    depth = rng.rand(512, 512, 1).astype(np.float32)
    kw = dict(prompt="a photo of a mirror on the wall", image=image, mask=mask, depth=depth,
              guidance_scale=7.5, scheduler="unipc", seed=SEED)

    warm = pipe(**kw, num_inference_steps=2, output_type="latent")
    if warm.shape != (1, 512, 512, 3) or not np.isfinite(warm).all():
        raise AssertionError(f"warm run: shape {warm.shape}, finite {np.isfinite(warm).all()}")

    # 4- and 8-step calls in turns; the host clock on a shared host spreads,
    # so each count's time is the median of its repeats
    runs = {4: {"s_each": []}, 8: {"s_each": []}}
    by_shape = {}
    for _ in range(MAIN_REPEATS):
        for steps in (4, 8):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            t0 = time.perf_counter()
            out = pipe(**kw, num_inference_steps=steps, output_type="np")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launched = read_counters()
            if out.shape != (1, 512, 512, 3) or out.dtype != np.uint8:
                raise AssertionError(f"{steps}-step run gave {out.shape} {out.dtype}")
            if launched["flash"] != 5 * steps or launched["groupnorm"] == 0:
                raise AssertionError(f"{steps}-step run launches {launched}")
            runs[steps]["s_each"].append(dt)
            runs[steps].update(launches=launched,
                               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
            by_shape[steps] = read_counters_by_shape()
    for r in runs.values():
        r["s"] = statistics.median(r["s_each"])
    s_step = (runs[8]["s"] - runs[4]["s"]) / 4
    per_step = {k: (runs[8]["launches"][k] - runs[4]["launches"][k]) / 4
                for k in runs[8]["launches"]}
    emit({"phase": "main_path", "gpu": gpu_line, "size": "512x512", "dtype": "bfloat16",
          "cfg": 7.5, "scheduler": "unipc", "runs": {str(k): v for k, v in runs.items()},
          "s_per_step": s_step, "s_per_image_8_steps": runs[8]["s"],
          "s_per_image_50_steps_two_point_estimate": runs[4]["s"] + 46 * s_step,
          "launches_per_step": per_step,
          "launches_by_shape_8_steps": [
              {"kernel": kern, "key": list(key), "launches": n,
               "per_step": (n - by_shape[4].get((kern, key), 0)) / 4}
              for (kern, key), n in sorted(by_shape[8].items(), key=str)]})
    phase_profile(torch, pipe, kw)
    return by_shape


def phase_profile(torch, pipe, kw, steps: int = 4, top: int = 12) -> None:
    """One traced 4-step call: device busy time (the sum of kernel times, all
    on one stream), the idle share of the traced wall time, device time by
    kind of kernel, and the kernels that take the most.  The tracer slows the
    host, so the idle share is an upper bound for the untraced run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(**kw, num_inference_steps=steps, output_type="np")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: a CPU op's own device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    events.sort(key=dev_us, reverse=True)
    groups = {}
    for e in events:
        name = e.key.lower()
        kind = next((k for k, subs in (("flash_attn_fwd", ("flash_fwd",)),
                                       ("groupnorm", ("_gn_",)),
                                       ("convolution", ("conv", "fprop", "implicit")),
                                       ("matmul", ("gemm", "cublas", "cutlass")))
                     if any(s in name for s in subs)), "other")
        groups[kind] = groups.get(kind, 0.0) + dev_us(e) / 1e3
    emit({"phase": "profile", "steps": steps, "traced_wall_s": wall,
          "device_busy_s": busy_s if events else "not measured",
          "device_idle_share": 1.0 - busy_s / wall if events else "not measured",
          "device_ms_by_kind": groups,
          "top_kernels": [{"name": e.key[:90], "calls": e.count, "device_ms": dev_us(e) / 1e3}
                          for e in events[:top]]})


# ------------------------------------------------------------------ main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        ROOT, "reflecting_reality_tpu_torch", "ops", "kernels", "_build", "triton"))
    import reflecting_reality_tpu_torch  # noqa: F401  (fails outside a checkout)

    gpu_line = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "device_count": torch.cuda.device_count(), "nvidia_smi": gpu_line})
    phase_build(torch)
    entries = phase_kernels(torch)
    phase_slice(torch)
    by_shape = phase_main(torch, gpu_line)

    # each entry carries the launches of its own kernel, shape and dtype in
    # the main path's 8-step call
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for e in entries:
        row = {k: e.get(k) for k in keys if k != "launches"}
        row["launches"] = by_shape[8].get(e["key"], 0)
        row["launches_per_step"] = (row["launches"] - by_shape[4].get(e["key"], 0)) / 4
        row.update({k: e[k] for k in ("shape", "dtype", "silu", "max_rel_err", "max_abs_tol",
                                      "max_abs_err_f32", "max_abs_tol_f32", "rel_l2_err",
                                      "rel_l2_tol") if k in e})
        row["kernel_ms"] = e["ms"]
        rows.append(row)
    emit({"phase": "kernels_detail", "kernels": rows})
    summary = [r for r in rows if r["launches"] > 0]
    missing = {e["kernel"] for e in entries} - {e["kernel"] for e, r in zip(entries, rows)
                                                 if r["launches"] > 0}
    if missing:
        raise AssertionError(f"no measured shape of {missing} ran on the main path")
    emit({"kernels": summary})
    print(gpu_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
