#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --ab-main-path OTHER_CHECKOUT [BLOCKS]

The second form times the main path (phases 2 and 5 below) of another
checkout (e.g. the parent commit unpacked with `git archive`) and of this
one in turns, BLOCKS (default 1) times other, this, this, other, each run in
a process of its own, and prints one `ab_main_path` line.

Phases, each printing one JSON line:
  1. env     torch/CUDA versions, device name and compute capability,
             `nvidia-smi --query-gpu=name,power.limit` and clocks.max.sm.
  2. build   nvcc builds the three CUDA kernel libraries (flash forward;
             flash backward; GroupNorm) from
             reflecting_reality_tpu_torch/ops/kernels/csrc, one nvcc each, all
             started together; seconds for each, ptxas's registers and spills
             of every kernel instance, and the count of wgmma (HGMMA),
             TMA-load (UTMALDG) and cluster-barrier (UCGABAR) instructions in
             each library's SASS (`cuobjdump -sass`): both flash libraries
             must hold HGMMA and UTMALDG, the GroupNorm library cluster
             barriers; no wgmma instance of the flash backward may spill,
             ptxas may give neither flash library a performance warning
             (C75xx: wgmmas serialised, setmaxnreg ignored), and the
             backward library's tiling must be `bwd_plan`'s.
  3. kernels every kernel against its plain PyTorch version on the card, at
             the shapes the main path, the training step and the test CLI
             give it (every GroupNorm shape of a denoise step and of the
             VAE, recorded from the full-width modules on the meta device,
             at the main path's batches and at the test CLI's 4 batched
             seeds in bf16 and its batches in fp32) and a few they meet
             elsewhere (1024², 576x512, fp32 parity, and the self-attention shapes the
             routing rule sends to the plain path): max abs error in the
             working dtype and against fp32 and the relative L2 error, each
             with its tolerance; kernel, plain and library times (20
             back-to-back calls, host launch cost included), the kernel's
             device time (a CUDA graph of the same 20 calls), the roofline
             bound and, for flash, the exponential bound (one exp2 per logit
             at 16 per clock per SM, at nvidia-smi's clocks.max.sm).  The
             flash backward kernels (B3 dQ, B4 dK/dV) are held to
             `flash_attention_bwd_plain` on B1's own out and lse, and two
             launches of each on the same inputs must be bit-identical; their
             library time is SDPA's backward.
  4. slice   full-width SD-1.5 UNet + BrushNet(conditioning_channels=6), one
             denoise step's forward at 64x64 latents, batch 2, fp32 with TF32
             off: the card (kernels) against the CPU (plain versions).
  5. main    StableDiffusionBrushNetPipeline at full SD-1.5 width in bf16:
             512x512, CFG 7.5, UniPC, depth concat; a warm run, then timed
             4- and 8-step runs in turns, MAIN_REPEATS of each (medians;
             s/step is their two-point difference).  In every run the flash
             kernel must launch exactly 5 x steps times and the GroupNorm
             kernel at least once, and every GroupNorm shape of a denoise
             step must take the single-pass (cluster) regime.
  6. profile one traced 4-step call: device busy time, idle share, device
             time by kind of kernel and the top kernels (torch.profiler).
  7. train_parity  full-width UNet + BrushNet (`from_unet`, seeded zero
             convs), fp32 with TF32 off, 64x64 latents, batch 1: one loss and
             backward on the card (through the kernels' autograd Functions)
             against the CPU (plain paths) on the same draws: the loss and
             four BrushNet gradients, each with its tolerance; B1/B3/B4 must
             launch 5/5/5 times and GroupNorm at least once.
  8. train_main  the training step (`make_train_step`) at full width: bf16
             autocast, frozen UNet/VAE/CLIP stored in bf16, fp32 BrushNet
             master weights, 512² batch 4, depth concat, AdamW lr 5e-6 without
             warm-up.  A warm step, then TRAIN_REPEATS timed steps (median
             s/step, samples/s, peak memory), one step with gradient
             checkpointing under each policy ("full", "dots"), and one traced
             step (idle share, device time by kind).  Every loss finite,
             BrushNet moved, UNet/VAE/CLIP bit-identical, and per step
             B1/B3/B4 launch 5/5/5 (10/5/5 with checkpointing under either
             policy).
  9. train_cli  the training CLI (`cli.train.main`) end to end: a base
             folder at full SD-1.5 width from seeded weights in bf16
             safetensors (written by the port's `save_pretrained`), a
             16-sample 512² latent-moments cache and its train.csv; 8 steps
             (bf16, batch 4, depth concat, checkpoints every 4, total limit
             1), a resume to step 10, 4 steps with --device_cache and 4 with
             --steps_per_dispatch 2 and --async_save; then
             `StableDiffusionBrushNetPipeline.from_pretrained` on
             checkpoint-8 with the safetensors package blocked and a 4-step
             512² call.  Checks: finite losses, BrushNet moved, frozen modules
             bit-identical to the folder, checkpoint-4 pruned, the resume
             bit-identical (BrushNet, AdamW moments, step 8), 5/5/5 launches
             per CLI step, the first batch the step sees equal to the host
             batch cast to bf16, no h5py/pandas/PIL/safetensors/msgpack
             imported.  Prints s/step beside train_main's, the loader's share
             of a step, H2D per batch (in the loop, and the packed copy
             alone, back-to-back), checkpoint and resume seconds and GB,
             peak memory and the phase's wall time.
  10. test_cli  the inference CLI (`cli.test.main`) on train_cli's base
             folder and checkpoint-8, full width, 512², depth concat, over a
             seeded `--image_mode` dataset (2 rows of PNG images and masks,
             depth .npz, test.csv; no h5py), 4 seeds a row: a one-row
             warm-up, then bf16 `--batch_seeds` at 4 and 8 steps, 8 steps
             again with each row waited for (no overlap), a rerun that must
             write nothing; a one-row fp32 warm-up, then fp32 sequential
             seeds at 2 and 4 steps.  Checks: 1024x1024 uint8 sheets, not
             constant, launches per denoise step equal to main_path's (B1 5,
             B2 the same) in both dtypes, no h5py or jax imported.  Prints
             s/image, s/step (two-point), the host time per row outside the
             card's work and how much of it the one-deep overlap hid, peak
             memory, B1's fp32 launches and their share of an fp32 step.
 11. evaluate  on run a's sheets: MetricsCalculator (PSNR/SSIM/LPIPS of the
             full, mask and mirror families, LPIPS weights from a seed) on
             the card against the CPU (LPIPS 1e-4 relative, PSNR 1e-3 dB,
             SSIM 1e-5), `metrics/evaluate.py --mode avg` (best and avg CSVs)
             on CSVs written from the card's scores, LPIPS ms per 512² pair.
 12. modes   a full-width 512² bf16 pipeline call, 4 steps, depth `latents`
             + normals `concat` (BrushNet with 12 conditioning channels):
             a finite, non-constant uint8 image, B1 20 launches; then fp32
             depth `concat` + normals `latents`, one denoise step, TF32 off,
             the card against the CPU at slice parity's tolerance.
Then `kernels_detail` (every measured kernel and shape with the launches
each path gave that shape: the main path's 8-step call, the timed training
steps, the CLI's first 8 steps and the test CLI's bf16 8-step and fp32
4-step runs, 0 where none), the `{"kernels": [...]}`
summary line (the
kernels and shapes the paths launched), the nvidia-smi name/power-limit
line, and last `{"ok": true, "device": {...}}`.  Any failed check raises and
the script exits non-zero; without a CUDA device it exits non-zero at once.
Weights are random, made from a seed.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
MAIN_REPEATS = 5                    # timed 4- and 8-step calls of each count
TRAIN_REPEATS = 5                   # timed training steps
TRAIN_BATCH = 4                     # the training CLI's --train_batch_size default
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
SMS = 132                           # H100 SXM streaming multiprocessors
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core bf16
              "float32": 67e12}     # fp32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    """nvidia-smi's clocks.max.sm, in Hz (the clock the exponential bound uses)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


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


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Device time of fn() without host launch cost: `iters` calls captured
    in one CUDA graph, one replay timed with CUDA events, divided by iters."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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

SASS_COUNTS = ("HGMMA", "UTMALDG", "UCGABAR")   # wgmma, TMA tensor load, cluster barrier
SASS_WANT = {"flash_attn_fwd": ("HGMMA", "UTMALDG"), "flash_attn_bwd": ("HGMMA", "UTMALDG"),
             "groupnorm": ("UCGABAR",)}
NO_SPILLS = {"flash_attn_bwd": "wgmma"}    # library: the instances that may not spill
NO_C75 = ("flash_attn_fwd", "flash_attn_bwd")  # libraries ptxas may not warn about


def ptxas_kernels(log: str) -> dict:
    """{kernel instance: {"registers", "spill_stores", "spill_loads"}} from
    nvcc's `-Xptxas -v` report; instances are named `function<template arg>`
    from the mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            # the kernel's identifier runs to the first upper-case letter of
            # the mangling (an earlier match is the file's anonymous namespace)
            fns = re.findall(r"(flash_(?:fwd|bwd)_[a-z0-9_]+|gn_[a-z0-9_]+)(?:ILi(\d+)E)?",
                             m.group(1))
            name = (f"{fns[-1][0]}<{fns[-1][1]}>" if fns and fns[-1][1] else
                    fns[-1][0] if fns else m.group(1)[:60])
            out.setdefault(name, {})
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    from reflecting_reality_tpu_torch.ops.kernels import build

    for c in (os.path.join(os.path.dirname(build.nvcc()), "cuobjdump"), shutil.which("cuobjdump")):
        if c and os.path.exists(c):
            return c
    import triton
    c = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump")
    if os.path.exists(c):
        return c
    raise RuntimeError("cuobjdump not found")


def phase_build(torch):
    from concurrent.futures import ThreadPoolExecutor

    from reflecting_reality_tpu_torch.ops.kernels import build

    names = ("flash_attn_fwd", "flash_attn_bwd", "groupnorm")
    built_now = {n: not build.library_path(n).exists() for n in names}
    t0 = time.perf_counter()

    def nvcc_build(name: str) -> float:
        build.load(name)
        return time.perf_counter() - t0

    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(names)) as pool:
        t_nvcc = {n: f.result() for n, f in
                  {n: pool.submit(nvcc_build, n) for n in names}.items()}
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa

    ptxas, warnings, sass = {}, {}, {}
    tool = cuobjdump()
    for n in names:
        lib = build.library_path(n)
        log = lib.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        ptxas[n] = ptxas_kernels(text)
        warnings[n] = [ln.strip() for ln in text.splitlines() if "C75" in ln]
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        sass[n] = {op: sum(ln.count(op) for ln in text.splitlines()) for op in SASS_COUNTS}
    # the backward library's tiling against its Python mirror, per head dim
    plans = {d: {k: (p.tile, p.stages, p.smem) for k, p in fa.bwd_plan(d).items()}
             for d in (40, 64, 80, 160)}
    lib_plans = {d: fa.library_bwd_plan(d) for d in plans}
    emit({"phase": "build", "nvcc_s": {n: round(t, 2) for n, t in t_nvcc.items()},
          "built_now": built_now, "sass_counts": sass, "ptxas": ptxas,
          "ptxas_warnings": warnings,
          "bwd_plan": {d: {k: list(v) for k, v in p.items()} for d, p in lib_plans.items()}})
    missing = {n: op for n, ops in SASS_WANT.items() for op in ops if sass[n][op] == 0}
    if missing:
        raise AssertionError(f"the SASS lacks the instructions of its design: {missing}")
    checked = {f"{n} {k}": v for n, sub in NO_SPILLS.items() for k, v in ptxas[n].items()
               if sub in k}
    spills = {k: v for k, v in checked.items() if v.get("spill_stores") or v.get("spill_loads")}
    if spills or len(checked) != 8:
        raise AssertionError(f"flash-backward wgmma instances ({len(checked)} of 8 reported) "
                             f"spill: {spills}")
    warned = {n: warnings[n] for n in NO_C75 if warnings[n]}
    if warned:
        raise AssertionError(f"ptxas performance warnings: {warned}")
    if lib_plans != plans:
        raise AssertionError(f"the library's B3/B4 tiling {lib_plans} is not bwd_plan's {plans}")


# ---------------------------------------------------------------- phase 3

def check(entry: dict) -> None:
    """Every `*err*` number with a `*tol*` counterpart must be within it."""
    bad = [k for k in entry if "err" in k and k.replace("err", "tol") in entry
           and not entry[k] <= entry[k.replace("err", "tol")]]
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
    entry["device_ms"] = graph_ms(torch, lambda: fa.flash_attention_fwd(q, k, v))
    entry["plain_ms"] = cuda_ms(torch, lambda: fa.attention_plain(q, k, v), iters=5)
    entry["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs))
    itemsize = q.element_size()
    nbytes = 4 * b * t * h * d * itemsize + b * h * t * 4
    entry["bound_ms"], entry["bound_by"] = bound(4.0 * b * h * t * t * d, nbytes,
                                                 entry["dtype"])
    # one exp2 per logit on the multi-function units: 16 per clock per SM
    entry["exp_bound_ms"] = b * h * t * t / (SMS * 16 * max_sm_clock_hz()) * 1e3
    return entry


def bench_flash_bwd(torch, shape, dtype):
    """Kernels B3 (dQ) and B4 (dK/dV) at one shape -> two entries."""
    import torch.nn.functional as F

    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa

    b, t, h, d = shape
    g = torch.Generator("cuda").manual_seed(SEED + 7)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda", dtype=dtype)
                   for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.flash_attention_delta(out, do)
    got = {"dq": fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)}
    got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    ref = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(q, k, v, out, lse, do)))
    # each output element is summed by one CTA in a fixed order: a second
    # launch on the same inputs gives the same bits
    again = {"dq": fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)}
    again["dk"], again["dv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    same = {n: torch.equal(got[n], again[n]) for n in got}
    if not all(same.values()):
        raise AssertionError(f"flash backward at {shape} {dtype}: not bit-identical {same}")
    bf16 = dtype == torch.bfloat16

    # as the forward: 4 bf16 ulps at the gradient's max (the kernels round p
    # and dS to bf16 before their products, as the Pallas kernels do) and a
    # relative L2 error under 1e-2; fp32 1e-4 of the max and L2 under 1e-4
    def errors(name):
        diff = got[name].float() - ref[name].float()
        scale = ref[name].float().abs().max().item()
        return {f"{name}_max_abs_err": diff.abs().max().item(),
                f"{name}_max_abs_tol": 4 * bf16_ulp(scale) if bf16 else 1e-4 * scale,
                f"{name}_rel_l2_err": (diff.norm() / ref[name].float().norm()).item(),
                f"{name}_rel_l2_tol": 1e-2 if bf16 else 1e-4}

    # SDPA's backward as the yardstick: dq, dk, dv of one call together
    qs, ks, vs = (x.permute(0, 2, 1, 3).detach().requires_grad_(True) for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs)
    do_s = do.permute(0, 2, 1, 3)
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do_s,
                                                            retain_graph=True))
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do),
                       iters=5)
    itemsize = q.element_size()
    tensor_bytes = b * t * h * d * itemsize
    rows_bytes = 2 * b * h * t * 4          # lse and delta
    entries = []
    for kind, names, products, run in (
            ("flash_bwd_dq", ("dq",), 3,
             lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)),
            ("flash_bwd_dkv", ("dk", "dv"), 4,
             lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))):
        e = {"name": f"flash_attn_bwd_{kind[10:]} {'x'.join(map(str, shape))} {str(dtype)[6:]}",
             "key": (kind, (tuple(shape), str(dtype)[6:])),
             "shape": list(shape), "dtype": str(dtype)[6:],
             "bit_identical_relaunch": all(same[n] for n in names)}
        for n in names:
            e.update(errors(n))
        e["max_abs_err"] = max(e[f"{n}_max_abs_err"] for n in names)
        e["rel_l2_err_max"] = max(e[f"{n}_rel_l2_err"] for n in names)
        e["ms"] = cuda_ms(torch, run)
        e["device_ms"] = graph_ms(torch, run)
        e["plain_ms"] = plain_ms      # the plain backward computes dq, dk and dv together
        e["library_ms"] = library_ms  # so does SDPA's
        # products of 2·B·H·T²·D each; q, k, v, dO, lse, delta read, grads written
        nbytes = (4 + len(names)) * tensor_bytes + rows_bytes
        e["bound_ms"], e["bound_by"] = bound(2.0 * products * b * h * t * t * d, nbytes,
                                             e["dtype"])
        e["exp_bound_ms"] = b * h * t * t / (SMS * 16 * max_sm_clock_hz()) * 1e3  # p recomputed
        entries.append(e)
    return entries


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
    entry["device_ms"] = graph_ms(torch, lambda: gn.group_norm_silu_fwd(x, w, bb, 32, 1e-5, silu))
    entry["regime"] = gn.launch_plan(tuple(shape), 32).regime
    entry["plain_ms"] = cuda_ms(torch, lambda: gn.group_norm_plain(x, w, bb, 32, 1e-5, silu))
    entry["library_ms"] = cuda_ms(torch, library)
    n = x.numel()
    nbytes = 2 * n * x.element_size() + 2 * c * w.element_size()
    entry["bound_ms"], entry["bound_by"] = bound((12.0 if silu else 8.0) * n, nbytes, "float32")
    return entry


FLASH_SHAPES = [((2, 4096, 8, 40), "bfloat16"), ((4, 4096, 8, 40), "bfloat16"),
                ((8, 4096, 8, 40), "bfloat16"),         # the test CLI's 4 batched seeds
                ((2, 4096, 8, 80), "bfloat16"), ((2, 4608, 8, 40), "bfloat16"),
                ((1, 2048, 8, 160), "bfloat16"), ((2, 4096, 8, 40), "float32"),
                # the UNet's other self-attentions, which the routing rule sends
                # to the plain path: B1 against it, for the crossover
                ((2, 1024, 8, 80), "bfloat16"), ((2, 256, 8, 160), "bfloat16"),
                ((2, 64, 8, 160), "bfloat16")]
FLASH_BWD_SHAPES = [((4, 4096, 8, 40), "bfloat16"), ((2, 4096, 8, 40), "bfloat16"),
                    ((2, 4608, 8, 40), "bfloat16"), ((1, 2048, 8, 160), "bfloat16"),
                    ((2, 4096, 8, 40), "float32")]
GN_SHAPES = [(2, 320, 64, 64), (4, 320, 64, 64), (2, 2560, 16, 16), (2, 1280, 8, 8),
             (1, 512, 64, 64), (1, 128, 512, 512), (4, 128, 512, 512)]


def main_path_groupnorms(torch):
    """The GroupNorms of the main path, recorded from forwards of the
    full-width modules on the meta device (no data, no time) -> two Counters
    of (shape, SiLU): one denoise step (BrushNet at batch 1, UNet at CFG batch
    2, 64x64 latents) and the VAE's encode + decode at 512²."""
    from collections import Counter
    from unittest import mock

    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.ops import norms
    from reflecting_reality_tpu_torch.ops.embeddings import precompute_time_embeddings
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

    seen = []

    def record(x, w, b, groups, eps, apply_silu=False):
        seen.append((tuple(x.shape), bool(apply_silu)))
        return gn.group_norm_plain(x, w, b, groups, eps, apply_silu)

    with torch.device("meta"), mock.patch.object(norms, "group_norm_silu", record), \
            torch.no_grad():
        unet, brushnet = UNet2DConditionModel(), BrushNetModel(conditioning_channels=6)
        lat, cond = torch.empty(1, 4, 64, 64), torch.empty(1, 6, 64, 64)
        ehs = torch.empty(2, 77, 768)
        tb, tu = (precompute_time_embeddings(m, [500]) for m in (brushnet, unet))
        down, mid, up = brushnet(lat, None, ehs[1:], cond, temb=tb)
        unet(torch.cat([lat, lat]), None, ehs,
             down_block_add_samples=[torch.cat([x, x]) for x in down],
             mid_block_add_sample=torch.cat([mid, mid]),
             up_block_add_samples=[torch.cat([x, x]) for x in up], temb=tu)
        step = len(seen)
        vae = AutoencoderKL()
        vae.encode(torch.empty(1, 3, 512, 512))
        vae.decode(lat)
    return Counter(seen[:step]), Counter(seen[step:])


def phase_kernels(torch):
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

    entries = []
    for shape, dt in FLASH_SHAPES:
        e = bench_flash(torch, shape, getattr(torch, dt))
        e.update(kernel="flash", route="cuda", source=fa.SOURCE, replaces=fa.REPLACES)
        entries.append(e)
    for shape, dt in FLASH_BWD_SHAPES:
        for e, replaces in zip(bench_flash_bwd(torch, shape, getattr(torch, dt)),
                               (fa.DQ_REPLACES, fa.DKV_REPLACES)):
            e.update(kernel=e["key"][0], route="cuda", source=fa.BWD_SOURCE, replaces=replaces)
            entries.append(e)
    gn_cases = {(shape, dt, silu) for shape in GN_SHAPES for dt in (torch.bfloat16, torch.float32)
                for silu in (False, True)}
    step_norms, vae_norms = main_path_groupnorms(torch)
    gn_cases |= {(shape, torch.bfloat16, silu) for shape, silu in step_norms}
    # the test CLI: bf16 at 4 batched seeds (the step's and the decoder's
    # batches times 4), and fp32 at the main path's batches
    gn_cases |= {((shape[0] * CLI_SEEDS,) + shape[1:], torch.bfloat16, silu)
                 for shape, silu in step_norms + vae_norms}
    gn_cases |= {(shape, torch.float32, silu) for shape, silu in step_norms + vae_norms}
    for shape, dt, silu in sorted(gn_cases, key=str):
        e = bench_groupnorm(torch, shape, dt, silu)
        e.update(kernel="groupnorm", route="cuda", source=gn.SOURCE, replaces=gn.REPLACES)
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


def counters() -> dict:
    """{kernel: its wrapper}; each wrapper counts the launches of its kernel."""
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

    return {"flash": fa.flash_attention_fwd, "flash_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv, "groupnorm": gn.group_norm_silu_fwd}


def reset_counters() -> None:
    for fn in counters().values():
        fn.launches = 0
        fn.launches_by_shape.clear()


def read_counters() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def read_counters_by_shape() -> dict:
    """{(kernel, shape key): launches} since the last reset."""
    return {(kern, key): n for kern, fn in counters().items()
            for key, n in fn.launches_by_shape.items()}


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
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

    step_norms = [key for (kern, key), n in by_shape[8].items()
                  if kern == "groupnorm" and n > by_shape[4].get((kern, key), 0)]
    not_single = [key for key in step_norms if gn.launch_plan(key[0], 32).regime != "cluster"]
    if not step_norms or not_single:
        raise AssertionError(f"denoise-step GroupNorms outside the cluster regime: {not_single}")
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
          "groupnorm_step_shapes_single_pass": len(step_norms),
          "launches_by_shape_8_steps": [
              {"kernel": kern, "key": list(key), "launches": n,
               "per_step": (n - by_shape[4].get((kern, key), 0)) / 4}
              for (kern, key), n in sorted(by_shape[8].items(), key=str)]})
    phase_profile(torch, pipe, kw)
    return by_shape, per_step


KINDS = (("flash_attn_fwd", ("flash_fwd",)), ("flash_attn_bwd_dq", ("flash_bwd_dq",)),
         ("flash_attn_bwd_dkv", ("flash_bwd_dkv",)), ("groupnorm", ("gn_kernel",)),
         ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
         ("matmul", ("gemm", "cublas", "cutlass")))


def trace(torch, fn, top: int = 12) -> dict:
    """One traced call of fn: device busy time (the sum of kernel times, all
    on one stream), the idle share of the traced wall time, device time by
    kind of kernel, and the kernels that take the most.  The tracer slows the
    host, so the idle share is an upper bound for the untraced run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # device-side kernel events only: a CPU op's own device time repeats its
    # kernels', and a user annotation (the optimizer's step range) spans them
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    events.sort(key=dev_us, reverse=True)
    groups = {}
    for e in events:
        name = e.key.lower()
        kind = next((k for k, subs in KINDS if any(sub in name for sub in subs)), "other")
        groups[kind] = groups.get(kind, 0.0) + dev_us(e) / 1e3
    return {"traced_wall_s": wall,
            "device_busy_s": busy_s if events else "not measured",
            "device_idle_share": 1.0 - busy_s / wall if events else "not measured",
            "device_ms_by_kind": groups,
            "top_kernels": [{"name": e.key[:90], "calls": e.count, "device_ms": dev_us(e) / 1e3}
                            for e in events[:top]]}


def phase_profile(torch, pipe, kw, steps: int = 4) -> None:
    """One traced 4-step pipeline call."""
    res = trace(torch, lambda: pipe(**kw, num_inference_steps=steps, output_type="np"))
    emit({"phase": "profile", "steps": steps, **res})


# ---------------------------------------------------------------- phase 7/8

def phase_train_parity(torch):
    """One fp32 loss + backward of full-width UNet + BrushNet on the card
    (kernels through their autograd Functions) against the CPU."""
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.schedulers.common import NoiseSchedule, add_noise
    from reflecting_reality_tpu_torch.training.train_step import (
        TrainConfig, denoise, diffusion_loss,
    )

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        unet = UNet2DConditionModel().requires_grad_(False)
    brushnet = BrushNetModel.from_unet(unet, conditioning_channels=6)
    fill_zero_convs(torch, brushnet, SEED, 0.02)
    config = TrainConfig()
    schedule = NoiseSchedule.create(1000, 0.00085, 0.012, "scaled_linear")
    g = torch.Generator().manual_seed(SEED + 2)
    latents, noise = torch.randn(1, 4, 64, 64, generator=g), torch.randn(1, 4, 64, 64, generator=g)
    cond = torch.randn(1, 6, 64, 64, generator=g)
    ehs = torch.randn(1, 77, 768, generator=g)
    t = torch.tensor([321])
    noisy = add_noise(schedule, latents, noise, t)
    names = ("conv_in_condition.weight", "brushnet_down_blocks.0.weight",
             "down_blocks.0.resnets.0.conv1.weight", "time_embedding.linear_1.weight")

    def loss_and_grads(unet, brushnet, device):
        params = dict(brushnet.named_parameters())
        args = (x.to(device) for x in (noisy, t, ehs, cond))
        pred = denoise(unet, brushnet, *args)
        loss = diffusion_loss(pred, noise.to(device), t.to(device), schedule, config)
        loss.backward()
        return loss.item(), {n: params[n].grad.detach().cpu() for n in names}

    reset_counters()
    t0 = time.perf_counter()
    card_loss, card = loss_and_grads(unet, brushnet, "cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launched = read_counters()
    unet_c = copy.deepcopy(unet).cpu()
    bn_c = copy.deepcopy(brushnet).cpu()
    bn_c.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    cpu_loss, cpu = loss_and_grads(unet_c, bn_c, "cpu")
    t_cpu = time.perf_counter() - t0
    # fp32 both sides, TF32 off: summation order through ~130 conv/matmul
    # layers forward and as many back; each gradient is held at 1e-3 of its
    # largest element (the forward alone agreed to ~4e-6 of its scale)
    res = {"phase": "train_parity", "loss": card_loss, "cpu_loss": cpu_loss,
           "loss_rel_err": abs(card_loss - cpu_loss) / abs(cpu_loss), "loss_rel_tol": 1e-4,
           "launches": launched, "card_loss_backward_s": round(t_card, 3),
           "cpu_loss_backward_s": round(t_cpu, 3), "grads": {}}
    for n in names:
        scale = cpu[n].abs().max().item()
        res["grads"][n] = {"max_abs_err": (card[n] - cpu[n]).abs().max().item(),
                           "max_abs_tol": 1e-3 * scale, "max_abs": scale,
                           "finite": bool(torch.isfinite(card[n]).all())}
    emit(res)
    bad = [n for n, r in res["grads"].items()
           if not (r["finite"] and r["max_abs"] > 0 and r["max_abs_err"] <= r["max_abs_tol"])]
    if bad or not res["loss_rel_err"] <= res["loss_rel_tol"]:
        raise AssertionError(f"train parity failed ({bad}): {res}")
    if (launched["flash"], launched["flash_bwd_dq"], launched["flash_bwd_dkv"]) != (5, 5, 5) \
            or launched["groupnorm"] == 0:
        raise AssertionError(f"train parity did not run through the kernels: {launched}")
    del unet, brushnet, unet_c, bn_c
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()


def phase_train_main(torch, gpu_line: str) -> dict:
    """The training step at full width, bf16, 512² batch 4 -> {(kernel, key):
    launches} over the timed steps."""
    import numpy as np

    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.training import TrainConfig, make_train_step

    torch.manual_seed(SEED)
    with torch.device("cuda"):
        unet = UNet2DConditionModel()
        vae = AutoencoderKL()
        text = CLIPTextModel()
    brushnet = BrushNetModel.from_unet(unet, conditioning_channels=6)
    fill_zero_convs(torch, brushnet, SEED, 0.02)
    for m in (unet, vae, text):           # frozen modules stored in bf16
        m.to(torch.bfloat16)
    config = TrainConfig(learning_rate=5e-6, lr_warmup_steps=0)
    step, init_state = make_train_step(unet, brushnet, vae, text, config, dtype=torch.bfloat16)
    step_ckpt, _ = make_train_step(unet, brushnet, vae, text,
                                   dataclasses.replace(config, gradient_checkpointing=True),
                                   dtype=torch.bfloat16)
    step_dots, _ = make_train_step(unet, brushnet, vae, text,
                                   dataclasses.replace(config, gradient_checkpointing=True,
                                                       gradient_checkpointing_policy="dots"),
                                   dtype=torch.bfloat16)
    state = init_state()

    rng = np.random.RandomState(SEED)
    n, px = TRAIN_BATCH, 512
    masks = np.zeros((n, px, px, 1), np.float32)
    masks[:, 128:384, 160:352] = 1.0
    batch = {k: torch.from_numpy(v).cuda() for k, v in {
        "pixel_values": rng.uniform(-1, 1, (n, px, px, 3)).astype(np.float32),
        "conditioning_pixel_values": rng.uniform(-1, 1, (n, px, px, 3)).astype(np.float32),
        "masks": masks,
        "depths": rng.uniform(-1, 1, (n, px, px, 1)).astype(np.float32),
        "input_ids": rng.randint(0, 49408, (n, 77)).astype(np.int64)}.items()}
    gen = torch.Generator("cuda").manual_seed(SEED)
    frozen0 = {k: [p.detach().cpu().clone() for p in m.parameters()]
               for k, m in (("unet", unet), ("vae", vae), ("text", text))}
    watched = ("conv_in_condition.weight", "brushnet_mid_block.weight",
               "down_blocks.0.resnets.0.conv1.weight")
    bn_params = dict(brushnet.named_parameters())
    before = {k: bn_params[k].detach().clone() for k in watched}

    losses = []

    def run(fn):
        nonlocal state
        state, m = fn(state, batch, gen)
        losses.append(float(m["loss"]))
        if not (math.isfinite(losses[-1]) and float(m["nonfinite_skipped"]) == 0.0):
            raise AssertionError(f"train step {state.step}: loss {losses[-1]}, {m}")
        return m

    run(step)                               # warm: cuBLAS/cuDNN/Triton set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    s_each = []
    for _ in range(TRAIN_REPEATS):
        t0 = time.perf_counter()
        m = run(step)
        torch.cuda.synchronize()
        s_each.append(time.perf_counter() - t0)
    launched = read_counters()
    by_shape = read_counters_by_shape()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / TRAIN_REPEATS for k, v in launched.items()}

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    run(step_ckpt)
    torch.cuda.synchronize()
    t_ckpt = time.perf_counter() - t0
    ckpt = {"s": t_ckpt, "launches": read_counters(),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    run(step_dots)
    torch.cuda.synchronize()
    dots = {"s": time.perf_counter() - t0, "launches": read_counters(),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    traced = trace(torch, lambda: run(step))

    moved = {k: (bn_params[k].detach() - before[k]).abs().max().item() for k in watched}
    frozen_same = {k: all(torch.equal(a, p.detach().cpu()) for a, p in zip(ps, m.parameters()))
                   for (k, ps), m in zip(frozen0.items(), (unet, vae, text))}
    s_step = statistics.median(s_each)
    emit({"phase": "train_main", "gpu": gpu_line, "size": f"{px}x{px}", "batch": n,
          "dtype": "bfloat16 autocast; BrushNet fp32 master, UNet/VAE/CLIP bf16",
          "optimizer": "AdamW lr 5e-6, no warm-up, clip 1.0", "s_each": s_each,
          "s_per_step": s_step, "samples_per_s": n / s_step,
          "max_memory_allocated_bytes": peak, "launches_per_step": per_step,
          "losses": losses, "last_grad_norm": float(m["grad_norm"]),
          "brushnet_max_abs_change": moved, "frozen_bit_identical": frozen_same,
          "gradient_checkpointing_step": ckpt, "gradient_checkpointing_dots_step": dots,
          "trace": traced})
    if not all(v > 0 for v in moved.values()) or not all(frozen_same.values()):
        raise AssertionError(f"train step moved {moved}, frozen unchanged {frozen_same}")
    want = {"flash": 5, "flash_bwd_dq": 5, "flash_bwd_dkv": 5}
    if any(per_step[k] != v for k, v in want.items()) or per_step["groupnorm"] == 0:
        raise AssertionError(f"train step launches per step {per_step}, want {want}")
    # under either policy the flash forward (an opaque autograd Function) is
    # recomputed with the rest of the forward: 10/5/5
    for policy, got in (("full", ckpt["launches"]), ("dots", dots["launches"])):
        if (got["flash"], got["flash_bwd_dq"], got["flash_bwd_dkv"]) != (10, 5, 5):
            raise AssertionError(f"checkpointed ({policy}) step launches {got}, want 10/5/5")
    del state, unet, brushnet, vae, text
    torch.cuda.empty_cache()
    return by_shape, s_step


# ---------------------------------------------------------------- phase 9

CLI_SAMPLES = 16                    # latent-cache samples of the train_cli phase
CLI_PX = 512                        # their resolution (latents CLI_PX / 8)
ABSENT_MODULES = ("h5py", "pandas", "PIL", "safetensors", "msgpack")


def write_base_folder(torch, base: str) -> dict:
    """A diffusers-layout SD-1.5 folder at full width from seeded weights,
    in bf16 safetensors, written by the port's own writers -> {subfolder:
    seconds}."""
    from reflecting_reality_tpu_torch.core.io import cast_floating, save_pretrained, save_safetensors
    from reflecting_reality_tpu_torch.data.tokenizer import write_byte_vocab
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    torch.manual_seed(SEED)
    took = {}
    for sub, cls in (("unet", UNet2DConditionModel), ("vae", AutoencoderKL),
                     ("text_encoder", CLIPTextModel)):
        t0 = time.perf_counter()
        with torch.device("cuda"):
            module = cls()
        state = cast_floating(module.state_dict(), torch.bfloat16)
        folder = os.path.join(base, sub)
        if sub == "text_encoder":         # the transformers layout
            module.save_config(folder)
            save_safetensors(state, os.path.join(folder, "model.safetensors"))
        else:
            save_pretrained(module, folder, state)
        del module, state
        took[sub] = time.perf_counter() - t0
    write_byte_vocab(os.path.join(base, "tokenizer"))
    torch.cuda.empty_cache()
    return took


def write_latent_cache(data: str, cache: str, n: int) -> None:
    """`n` samples at CLI_PX² in the precompute tool's .npz layout, fp16
    moments, and a train.csv written with `csv`."""
    import csv

    import numpy as np

    from reflecting_reality_tpu_torch.data.latent_cache import cache_name

    rng = np.random.RandomState(SEED)
    hl = CLI_PX // 8

    def moments():                      # mean ‖ logvar
        return np.concatenate([rng.standard_normal((hl, hl, 4)),
                               rng.uniform(-6.0, -2.0, (hl, hl, 4))], axis=-1).astype(np.float16)

    os.makedirs(cache)
    rows = [{"uid": f"uid{i}", "path": f"obj/{i}.hdf5",
             "auto_caption": f"a framed mirror on a wall, scene {i}"} for i in range(n)]
    with open(os.path.join(data, "train.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    mask = np.zeros((hl, hl, 1), np.float32)
    mask[hl // 4: 3 * hl // 4, hl // 3: 2 * hl // 3] = 1.0
    for i, row in enumerate(rows):
        np.savez(os.path.join(cache, cache_name(row, i)), latent_moments=moments(),
                 cond_latent_moments=moments(), masks=mask,
                 depths=rng.uniform(-1.0, 1.0, (hl, hl, 1)).astype(np.float32))


def read_metrics(out: str) -> list:
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_train_cli(torch, gpu_line: str, train_main_s_step: float, tmp: str) -> dict:
    """The training CLI end to end at full width on the card, in `tmp` ->
    {(kernel, key): launches} over its first run's 8 steps.  It leaves the
    base folder (tmp/base) and checkpoint-8 (tmp/run/checkpoint-8) for the
    test CLI."""
    from unittest import mock

    import numpy as np

    from reflecting_reality_tpu_torch.cli import train as cli
    from reflecting_reality_tpu_torch.core.io import WEIGHTS_NAME, load_safetensors
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    t_phase = time.perf_counter()
    base, data = os.path.join(tmp, "base"), os.path.join(tmp, "data")
    cache = os.path.join(tmp, "cache")
    os.makedirs(data)
    t0 = time.perf_counter()
    folder_s = write_base_folder(torch, base)
    folder_gb = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, fs in os.walk(base) for f in fs) / 1e9
    write_latent_cache(data, cache, CLI_SAMPLES)
    setup_s = time.perf_counter() - t0

    def argv(out, *extra):
        return ["--pretrained_model_name_or_path", base, "--train_data_dir", data,
                "--output_dir", out, "--logging_dir", os.path.join(out, "logs"),
                "--mixed_precision", "bf16", "--train_batch_size", str(TRAIN_BATCH),
                "--depth_conditioning_mode", "concat", "--learning_rate", "5e-6",
                "--lr_warmup_steps", "0", "--precomputed_latents_dir", cache,
                "--dataloader_num_workers", "4", "--log_every", "1",
                "--validation_steps", "0", "--report_to", "none", "--seed", "0", *extra]

    # instrumentation: the initial BrushNet, the first host batch, the
    # first batch the step sees, and the state right after a resume
    seen = {}
    real_load_models, real_prefetch = cli.load_models, cli.prefetch_to_device
    real_make_step, real_load_state = cli.make_train_step, cli.ckpt.load_state

    def load_models(args):
        out = real_load_models(args)
        seen.setdefault("brushnet0", {k: v.clone() for k, v in out[1].state_dict().items()})
        return out

    def prefetch(iterator, *a, **kw):
        def tee():
            for b in iterator:
                seen.setdefault("host_batch", {k: v.copy() for k, v in b.items()})
                yield b
        return real_prefetch(tee(), *a, **kw)

    def make_train_step(*a, **kw):
        step, init = real_make_step(*a, **kw)

        def recording(state, batch, generator, **k2):
            seen.setdefault("step_batch", {k: v.detach().cpu().clone()
                                           for k, v in batch.items()})
            return step(state, batch, generator, **k2)
        return recording, init

    def load_state(path, state):
        state = real_load_state(path, state)
        opt = state.optimizer.state_dict()["state"]
        seen["resumed"] = {
            "step": state.step,
            "brushnet": {k: v.detach().cpu().clone()
                         for k, v in state.trainable["brushnet"].state_dict().items()},
            "moments": {i: (s["exp_avg"].cpu().clone(), s["exp_avg_sq"].cpu().clone())
                        for i, s in opt.items()}}
        return state

    runs = {}
    with mock.patch.object(cli, "load_models", load_models), \
            mock.patch.object(cli, "prefetch_to_device", prefetch), \
            mock.patch.object(cli, "make_train_step", make_train_step), \
            mock.patch.object(cli.ckpt, "load_state", load_state):
        out_a = os.path.join(tmp, "run")
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        state = cli.main(argv(out_a, "--max_train_steps", "8", "--checkpointing_steps", "4",
                              "--checkpoints_total_limit", "1"))
        torch.cuda.synchronize()
        runs["train"] = {"wall_s": time.perf_counter() - t0,
                         "launches": read_counters(), "steps": 8}
        cli_by_shape = read_counters_by_shape()
        peak = torch.cuda.max_memory_allocated()
        trained = {k: v.detach().cpu().clone()
                   for k, v in state.trainable["brushnet"].state_dict().items()}
        frozen = {sub: state.frozen[name] for sub, name in
                  (("unet", "unet"), ("vae", "vae"), ("text_encoder", "text"))}
        frozen_same = {}
        for sub, module in frozen.items():
            fname = "model.safetensors" if sub == "text_encoder" else WEIGHTS_NAME
            ref = load_safetensors(os.path.join(base, sub, fname))
            frozen_same[sub] = all(torch.equal(v.detach().cpu(), ref[k])
                                   for k, v in module.state_dict().items())
        del state, frozen
        torch.cuda.empty_cache()
        listing_a = sorted(os.listdir(out_a))

        reset_counters()
        t0 = time.perf_counter()
        cli.main(argv(out_a, "--max_train_steps", "10", "--checkpointing_steps", "4",
                      "--checkpoints_total_limit", "1", "--resume_from_checkpoint",
                      "latest"))
        torch.cuda.synchronize()
        runs["resume"] = {"wall_s": time.perf_counter() - t0,
                          "launches": read_counters(), "steps": 2}
        shutil.rmtree(os.path.join(out_a, "checkpoint-10"))     # 7.4 GB not needed
        torch.cuda.empty_cache()
        for name, extra in (("device_cache", ("--device_cache",)),
                            ("steps_per_dispatch_2", ("--steps_per_dispatch", "2",
                                                      "--async_save",
                                                      "--checkpointing_steps", "2",
                                                      "--checkpoints_total_limit", "1"))):
            out = os.path.join(tmp, name)
            reset_counters()
            t0 = time.perf_counter()
            cli.main(argv(out, "--max_train_steps", "4", *extra))
            torch.cuda.synchronize()
            runs[name] = {"wall_s": time.perf_counter() - t0, "launches": read_counters(),
                          "steps": 4, "metrics": read_metrics(out)}
            shutil.rmtree(out)
            torch.cuda.empty_cache()

    # the checkpoint read back through the port's reader, then the
    # pipeline loading it with the safetensors package blocked
    ckpt8 = os.path.join(out_a, "checkpoint-8", "brushnet")
    saved8 = load_safetensors(os.path.join(ckpt8, WEIGHTS_NAME))
    saved_same = all(torch.equal(saved8[k], v) for k, v in trained.items())
    with mock.patch.dict(sys.modules, {"safetensors": None}):
        t0 = time.perf_counter()
        pipe = StableDiffusionBrushNetPipeline.from_pretrained(
            base, brushnet_path=ckpt8, depth_conditioning_mode="concat",
            dtype=torch.bfloat16, device="cuda")
        pipe_load_s = time.perf_counter() - t0
    pipe_same = all(torch.equal(v.cpu(), trained[k].to(torch.bfloat16))
                    for k, v in pipe.brushnet.state_dict().items())
    rng = np.random.RandomState(SEED)
    px = CLI_PX
    mask = np.zeros((px, px, 3), np.float32)
    mask[px // 4: 3 * px // 4, px // 3: 2 * px // 3] = 1.0
    kw = dict(prompt="a framed mirror on a wall", image=rng.rand(px, px, 3).astype(np.float32),
              mask=mask, depth=rng.rand(px, px, 1).astype(np.float32),
              num_inference_steps=4, guidance_scale=7.5, seed=SEED)
    image_f = pipe(**kw, output_type="latent")
    image_u8 = pipe(**kw, output_type="np")
    del pipe
    torch.cuda.empty_cache()

    # the upload alone: the first host batch packed as the loader packs
    # it, copied back-to-back from its pinned buffer on an idle card
    from reflecting_reality_tpu_torch.data import loader as data_loader

    flat, _, nbytes = data_loader._pack(seen["host_batch"], torch.bfloat16, (), pin=True)
    packed = flat[:nbytes]
    h2d_copy_ms = cuda_ms(torch, lambda: packed.to("cuda", non_blocking=True))

    metrics_a = read_metrics(out_a)
    steps_a = [r for r in metrics_a if "loss" in r]
    resumed = seen["resumed"]
    saved_opt = torch.load(os.path.join(out_a, "checkpoint-8", "train_state.pt"),
                           map_location="cpu", weights_only=True)["optimizer"]["state"]
    timed = [r for r in steps_a if 2 <= r["step"] <= 8]       # run 1, after its first step

    def med(rows, key):
        vals = [r[key] for r in rows if key in r]
        return statistics.median(vals) if vals else "not measured"

    losses = {"train": [r["loss"] for r in steps_a if r["step"] <= 8],
              "resume": [r["loss"] for r in steps_a if r["step"] > 8]}
    losses.update({name: [r["loss"] for r in runs[name]["metrics"] if "loss" in r]
                   for name in ("device_cache", "steps_per_dispatch_2")})
    host_bf16 = {k: torch.from_numpy(v).to(torch.bfloat16)
                 if v.dtype == np.float32 else torch.from_numpy(v)
                 for k, v in seen["host_batch"].items()}
    first_batch_same = (set(host_bf16) == set(seen["step_batch"]) and all(
        torch.equal(host_bf16[k], seen["step_batch"][k]) for k in host_bf16))
    moved = max((trained[k] - seen["brushnet0"][k]).abs().max().item() for k in trained)
    sync = [r for r in metrics_a if "checkpoint_s" in r]
    async_rows = runs["steps_per_dispatch_2"]["metrics"]
    per_step = {k: v / runs["train"]["steps"] for k, v in runs["train"]["launches"].items()}
    res = {
        "phase": "train_cli", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}",
        "batch": TRAIN_BATCH,
        "samples": CLI_SAMPLES, "base_folder_gb_bf16": folder_gb,
        "base_folder_write_s": folder_s, "setup_s": setup_s,
        "runs_wall_s": {k: v["wall_s"] for k, v in runs.items()},
        "cli_s_per_step_median_steps_2_8": med(timed, "s_per_step"),
        "cli_s_per_step_each": {name: [round(r["s_per_step"], 4) for r in rows]
                                for name, rows in (
                                    ("train", steps_a),
                                    ("device_cache", [r for r in runs["device_cache"]
                                                      ["metrics"] if "loss" in r]),
                                    ("steps_per_dispatch_2", [r for r in async_rows
                                                              if "loss" in r]))},
        "h2d_ms_each": [round(r["h2d_ms"], 4) for r in steps_a if "h2d_ms" in r],
        "cli_samples_per_s_median_steps_2_8": med(timed, "samples_per_s"),
        "train_main_s_per_step": train_main_s_step,
        "train_main_samples_per_s": TRAIN_BATCH / train_main_s_step,
        "loader_share_median": statistics.median(
            r["data_wait_s"] / (r["data_wait_s"] + r["dispatch_s"]) for r in timed),
        "data_wait_s_median": med(timed, "data_wait_s"),
        "h2d_ms_median": med(timed, "h2d_ms"),
        "h2d_copy_alone": {"bytes": nbytes, "ms": h2d_copy_ms,
                           "gb_per_s": nbytes / h2d_copy_ms / 1e6},
        "checkpoint_sync": [{"step": r["step"], "s": r["checkpoint_s"],
                             "gb": r["checkpoint_gb"]} for r in sync],
        "checkpoint_async": {
            "wait_s_snapshot_s": [(r["step"], r["checkpoint_async_wait_s"],
                                   r["checkpoint_async_snapshot_s"])
                                  for r in async_rows if "checkpoint_async_wait_s" in r],
            "write_s_gb": [(r["step"], r["checkpoint_async_write_s"], r["checkpoint_gb"])
                           for r in async_rows if "checkpoint_async_write_s" in r]},
        "resume_s": [r["resume_s"] for r in metrics_a if "resume_s" in r],
        "pipeline_load_s_without_safetensors": pipe_load_s,
        "max_memory_allocated_bytes_run_1": peak,
        "device_cache_s_per_step_median": med(
            [r for r in runs["device_cache"]["metrics"] if r.get("step", 0) >= 2],
            "s_per_step"),
        "steps_per_dispatch_2_s_per_step_median": med(
            [r for r in async_rows if r.get("step", 0) >= 3], "s_per_step"),
        "launches_per_step": per_step,
        "launches_by_run": {k: v["launches"] for k, v in runs.items()},
        "losses": losses,
        "brushnet_max_abs_change": moved, "frozen_bit_identical": frozen_same,
        "run_1_listing": listing_a, "resumed_step": resumed["step"],
        "resumed_brushnet_bit_identical": all(
            torch.equal(resumed["brushnet"][k], saved8[k]) for k in saved8),
        "resumed_moments_bit_identical": all(
            torch.equal(resumed["moments"][i][0], saved_opt[i]["exp_avg"])
            and torch.equal(resumed["moments"][i][1], saved_opt[i]["exp_avg_sq"])
            for i in saved_opt) and len(saved_opt) == len(resumed["moments"]),
        "checkpoint_8_bit_identical": saved_same, "pipeline_brushnet_bit_identical": pipe_same,
        "first_batch_bf16_equal": first_batch_same,
        "pipeline_image": {"shape": list(image_u8.shape), "dtype": str(image_u8.dtype),
                           "finite": bool(np.isfinite(image_f).all())},
        "absent_modules": {m: m not in sys.modules or sys.modules[m] is None
                           for m in ABSENT_MODULES},
    }
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    bad = []
    if not all(math.isfinite(x) for ls in losses.values() for x in ls) \
            or [len(losses[k]) for k in ("train", "resume", "device_cache",
                                         "steps_per_dispatch_2")] != [8, 2, 4, 4]:
        bad.append("losses")
    if not moved > 0 or not all(frozen_same.values()):
        bad.append("brushnet moved / frozen modules unchanged")
    if "checkpoint-4" in listing_a or "checkpoint-8" not in listing_a \
            or any(n.endswith(".tmp") for n in listing_a):
        bad.append(f"checkpoint listing {listing_a}")
    if res["resumed_step"] != 8 or not res["resumed_brushnet_bit_identical"] \
            or not res["resumed_moments_bit_identical"]:
        bad.append("resume")
    if not (saved_same and pipe_same):
        bad.append("checkpoint-8 BrushNet against the trained one")
    want = {"flash": 5, "flash_bwd_dq": 5, "flash_bwd_dkv": 5}
    if any(per_step[k] != v for k, v in want.items()) or per_step["groupnorm"] == 0:
        bad.append(f"launches per CLI step {per_step}")
    if not first_batch_same:
        bad.append("the first batch the step saw is not the host batch cast to bf16")
    if res["pipeline_image"] != {"shape": [1, CLI_PX, CLI_PX, 3], "dtype": "uint8",
                                 "finite": True}:
        bad.append(f"pipeline image {res['pipeline_image']}")
    if not all(res["absent_modules"].values()):
        bad.append(f"modules imported: {res['absent_modules']}")
    if bad:
        raise AssertionError(f"train_cli failed: {bad}")
    return cli_by_shape


# ---------------------------------------------------------------- phase 10

CLI_SEEDS = 4                       # the test CLI's --num_images_per_validation default
CLI_ROWS = 2                        # rows of the test CLI's --image_mode dataset
FAMILIES = ("PSNR", "SSIM", "LPIPS", "mask_PSNR", "mask_SSIM", "mask_LPIPS",
            "mirror_PSNR", "mirror_SSIM", "mirror_LPIPS")


def write_image_mode_data(root: str) -> None:
    """CLI_ROWS rows at CLI_PX²: images/*.png, masks/*.png, depth/*.npz and
    a test.csv (the MSD layout `--image_mode` reads; no HDF5)."""
    import csv

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(SEED + 3)
    for sub in ("images", "masks", "depth"):
        os.makedirs(os.path.join(root, sub))
    yy, xx = np.mgrid[0:CLI_PX, 0:CLI_PX] / CLI_PX
    rows = []
    for i in range(CLI_ROWS):
        # a smooth scene plus noise, so PSNR/SSIM/LPIPS see structure
        base = np.stack([yy, xx, (yy + xx) / 2], axis=-1) * 200 + 30 * i
        image = np.clip(base + rng.randint(-20, 21, base.shape), 0, 255).astype(np.uint8)
        mask = np.zeros((CLI_PX, CLI_PX), np.uint8)
        mask[CLI_PX // 4: 3 * CLI_PX // 4, CLI_PX // 3: 2 * CLI_PX // 3] = 255
        Image.fromarray(image).save(os.path.join(root, "images", f"{i}.png"))
        Image.fromarray(mask).save(os.path.join(root, "masks", f"{i}.png"))
        np.savez(os.path.join(root, "depth", f"{i}.npz"),
                 depth=(1.0 + 4.0 * rng.rand(CLI_PX, CLI_PX)).astype(np.float32))
        rows.append({"uid": f"scene{i}", "path": f"{i}.png",
                     "auto_caption": f"a framed mirror on a wall, scene {i}"})
    with open(os.path.join(root, "test.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def phase_test_cli(torch, gpu_line: str, tmp: str, main_per_step: dict, entries: list):
    """The inference CLI (`cli.test.main`) at full width on checkpoint-8 of
    `train_cli` -> ({run: {(kernel, key): launches}}, the sheets of run a,
    the dataset folder)."""
    from unittest import mock

    import numpy as np
    from PIL import Image

    from reflecting_reality_tpu_torch.cli import test as cli_test

    t_phase = time.perf_counter()
    data = os.path.join(tmp, "msd")
    write_image_mode_data(data)
    real_drive = cli_test.drive_rows
    record = {}

    def drive(serial: bool):
        """drive_rows timed from its first row to its last write (the model
        load left out), with CUDA events around each row's device work;
        `serial` waits for each row before the next (no overlap)."""
        def run(args, df, out, generate, finalize=None):
            spans = []

            def timed(*a):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                handles = generate(*a)
                end.record()
                spans.append((start, end))
                return handles

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if serial:
                real_drive(args, df, out, lambda *a: finalize(timed(*a)))
            else:
                real_drive(args, df, out, timed, finalize)
            torch.cuda.synchronize()
            record.update(rows_s=time.perf_counter() - t0, rows=len(spans),
                          device_s=sum(a.elapsed_time(b) for a, b in spans) / 1e3)
        return run

    def argv(out, *extra):
        return ["--brushnet_path", os.path.join(tmp, "run", "checkpoint-8"),
                "--base_model_path", os.path.join(tmp, "base"), "--train_data_dir", data,
                "--output_dir", out, "--image_mode", "--depth_conditioning_mode", "concat",
                "--resolution", str(CLI_PX), "--seed", str(SEED), *extra]

    # a warm-up run of one row before each dtype's timed runs takes the
    # first calls' set-up (cuDNN/cuBLAS choices at new shapes) off them
    bf16 = ("--weight_dtype", "bf16", "--batch_seeds")
    warm = ("--num_samples", "1", "--num_inference_steps", "2")
    plan = [("a_warm", bf16 + warm, False),
            ("a_4_steps", bf16 + ("--num_inference_steps", "4"), False),
            ("a_8_steps", bf16 + ("--num_inference_steps", "8"), False),
            ("a_8_steps_serial", bf16 + ("--num_inference_steps", "8"), True),
            ("c_rerun_of_a_8_steps", bf16 + ("--num_inference_steps", "8"), False),
            ("b_warm", warm, False),
            ("b_fp32_2_steps", ("--num_inference_steps", "2"), False),
            ("b_fp32_4_steps", ("--num_inference_steps", "4"), False)]
    runs, by_shape = {}, {}
    for name, extra, serial in plan:
        out = os.path.join(tmp, "infer", name.replace("c_rerun_of_", ""))
        before = ({f: os.path.getmtime(os.path.join(out, f)) for f in os.listdir(out)}
                  if os.path.isdir(out) else None)
        record.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        with mock.patch.object(cli_test, "drive_rows", drive(serial)):
            cli_test.main(argv(out, *extra))
        torch.cuda.synchronize()
        runs[name] = {"wall_s": time.perf_counter() - t0, **record,
                      "launches": read_counters(),
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        by_shape[name] = read_counters_by_shape()
        if before is not None:
            runs[name]["rewrote"] = sorted(f for f in os.listdir(out)
                                           if before.get(f) != os.path.getmtime(
                                               os.path.join(out, f)))
        sheets = sorted(os.listdir(out))
        arrays = [np.asarray(Image.open(os.path.join(out, f))) for f in sheets]
        runs[name]["sheets"] = [{"name": f, "shape": list(a.shape), "dtype": str(a.dtype),
                                 "std": float(a.std())} for f, a in zip(sheets, arrays)]

    a4, a8, a8s = runs["a_4_steps"], runs["a_8_steps"], runs["a_8_steps_serial"]
    b2, b4, c = runs["b_fp32_2_steps"], runs["b_fp32_4_steps"], runs["c_rerun_of_a_8_steps"]
    rows = CLI_ROWS

    def per_step(hi, lo, steps, calls):
        return {k: (hi["launches"][k] - lo["launches"][k]) / (steps * calls)
                for k in hi["launches"]}

    a_per_step = per_step(a8, a4, 4, rows)                 # one batched call a row
    b_per_step = per_step(b4, b2, 2, rows * CLI_SEEDS)     # one call a seed
    fp32_key = ("flash", ((2, 4096, 8, 40), "float32"))
    b1_fp32 = next(e for e in entries if e["key"] == fp32_key)
    b_s_step = (b4["rows_s"] - b2["rows_s"]) / (2 * rows * CLI_SEEDS)
    host_row_s = (a8s["rows_s"] - a8s["device_s"]) / rows
    res = {
        "phase": "test_cli", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}", "rows": rows,
        "seeds_per_row": CLI_SEEDS, "depth": "concat", "cfg": 7.5, "scheduler": "unipc",
        "runs": runs,
        "bf16_batched_s_per_image_8_steps": a8["rows_s"] / (rows * CLI_SEEDS),
        "bf16_batched_s_per_step": (a8["rows_s"] - a4["rows_s"]) / (4 * rows),
        "bf16_batched_s_per_image_step": (a8["rows_s"] - a4["rows_s"]) / (4 * rows * CLI_SEEDS),
        "fp32_sequential_s_per_image_4_steps": b4["rows_s"] / (rows * CLI_SEEDS),
        "fp32_sequential_s_per_step": b_s_step,
        "host_s_per_row_outside_device_work": host_row_s,
        "overlap_hid_s_per_row": (a8s["rows_s"] - a8["rows_s"]) / rows,
        "launches_per_step": {"bf16_batched": a_per_step, "fp32_sequential": b_per_step,
                              "main_path": main_per_step},
        "b1_fp32_launches": {"b_fp32_4_steps": by_shape["b_fp32_4_steps"].get(fp32_key, 0),
                             "per_step": b_per_step["flash"]},
        "b1_fp32_device_ms_per_step": b_per_step["flash"] * b1_fp32["device_ms"],
        "b1_fp32_share_of_fp32_step": b_per_step["flash"] * b1_fp32["device_ms"] / 1e3
        / b_s_step,
        "plain_fp32_ms_per_step_instead": b_per_step["flash"] * b1_fp32["plain_ms"],
        "absent_modules": {m: m not in sys.modules or sys.modules[m] is None
                           for m in ("h5py", "jax")},
        "phase_wall_s": time.perf_counter() - t_phase,
    }
    emit(res)
    bad = []
    for name in ("a_4_steps", "a_8_steps", "a_8_steps_serial", "b_fp32_2_steps",
                 "b_fp32_4_steps"):
        sheets = runs[name]["sheets"]
        if len(sheets) != rows or runs[name]["rows"] != rows or any(
                sh["shape"] != [2 * CLI_PX, 2 * CLI_PX, 3] or sh["dtype"] != "uint8"
                or not sh["std"] > 0 for sh in sheets):
            bad.append(f"{name} sheets {sheets}")
    if c["rows"] != 0 or c["rewrote"] or c["launches"]["flash"] != 0:
        bad.append(f"the rerun wrote or ran: {c['rewrote']}, {c['rows']} rows")
    for name, got in (("bf16_batched", a_per_step), ("fp32_sequential", b_per_step)):
        if got["flash"] != 5 or got["groupnorm"] != main_per_step["groupnorm"]:
            bad.append(f"{name} launches per step {got}, main path {main_per_step}")
    if not all(res["absent_modules"].values()):
        bad.append(f"modules imported: {res['absent_modules']}")
    if bad:
        raise AssertionError(f"test_cli failed: {bad}")
    return by_shape, os.path.join(tmp, "infer", "a_8_steps"), data


def phase_evaluate(torch, gpu_line: str, tmp: str, sheets_dir: str, data: str) -> None:
    """The evaluation stack on the test CLI's sheets: MetricsCalculator on
    the card against the same calculator on the CPU, then `evaluate`'s
    best/avg on the CSVs written from the card's scores, and the LPIPS
    time per 512² pair."""
    import numpy as np
    import pandas as pd
    from PIL import Image

    from reflecting_reality_tpu_torch.data.synmirror import get_masked_image
    from reflecting_reality_tpu_torch.metrics import evaluate
    from reflecting_reality_tpu_torch.metrics.calculator import MetricsCalculator, _no_tf32
    from reflecting_reality_tpu_torch.metrics.lpips import LPIPS, save_lpips_npz

    t_phase = time.perf_counter()
    torch.manual_seed(SEED)
    weights = os.path.join(tmp, "lpips_squeeze.npz")
    save_lpips_npz({k: v.abs() for k, v in LPIPS().state_dict().items()}, weights)
    calcs = {dev: MetricsCalculator(FAMILIES, lpips_weights=weights, device=dev)
             for dev in ("cuda", "cpu")}
    uids = sorted(f[:-4] for f in os.listdir(sheets_dir) if f.endswith(".png"))
    scores = {dev: {} for dev in calcs}
    for uid in uids:
        i = int(uid.removeprefix("scene"))
        image = np.asarray(Image.open(os.path.join(data, "images", f"{i}.png")))
        mask = np.asarray(Image.open(os.path.join(data, "masks", f"{i}.png")).convert("L"))
        gt = {"image": image, "mask": mask, "masked_image": get_masked_image(image, mask)}
        gens = evaluate.split_generated_image(
            CLI_SEEDS, Image.open(os.path.join(sheets_dir, f"{uid}.png")))
        for dev, calc in calcs.items():
            for k, gen in enumerate(gens):
                for m in FAMILIES:
                    scores[dev][(uid, k, m)] = calc.compute_metric(m, gen, gt, "")
    # fp32 both sides, TF32 off: summation order only
    tol = {"LPIPS": ("rel", 1e-4), "PSNR": ("abs", 1e-3), "SSIM": ("abs", 1e-5)}
    worst = {}
    for key, want in scores["cpu"].items():
        kind, limit = tol[next(t for t in tol if t in key[2])]
        got = scores["cuda"][key]
        err = abs(got - want) / (abs(want) if kind == "rel" else 1.0)
        fam = key[2]
        worst[fam] = max(worst.get(fam, 0.0), err)
        if not (math.isfinite(got) and err <= limit):
            raise AssertionError(f"evaluate: {key} card {got} cpu {want} ({kind} {err} > {limit})")
    for k in range(CLI_SEEDS):
        df = pd.DataFrame({c: [float("nan")] * len(uids) for c in evaluate.columns})
        df["uid"] = uids
        for j, uid in enumerate(uids):
            for m in FAMILIES:
                df.at[j, m] = scores["cuda"][(uid, k, m)]
        df.to_csv(os.path.join(sheets_dir, f"eval_{k}.csv"), index=False)
    evaluate.main(["--infer_dir", sheets_dir, "--mode", "avg", "--select_metric", "mask_SSIM",
                   "--device", "cuda"])
    best = pd.read_csv(os.path.join(sheets_dir, "eval_best.csv"))
    avg = pd.read_csv(os.path.join(sheets_dir, "eval_avg.csv")).set_index("Metric")
    want_idx = [int(np.argmax([scores["cuda"][(uid, k, "mask_SSIM")] for k in range(CLI_SEEDS)]))
                for uid in best["uid"]]
    want_avg = {m: float(np.mean([scores["cuda"][(uid, j, m)]
                                  for uid, j in zip(best["uid"], want_idx)])) for m in FAMILIES}

    module = calcs["cuda"].lpips_module()
    g = torch.Generator("cuda").manual_seed(SEED)
    x, y = (torch.rand(1, 3, CLI_PX, CLI_PX, generator=g, device="cuda") * 2 - 1
            for _ in range(2))
    with torch.inference_mode(), _no_tf32():
        lpips_ms = cuda_ms(torch, lambda: module(x, y))
    a, b = (np.random.RandomState(SEED + s).rand(CLI_PX, CLI_PX, 3).astype(np.float32) * 2 - 1
            for s in (0, 1))
    calcs["cuda"].calculate_lpips(a, b)
    t0 = time.perf_counter()
    for _ in range(10):
        calcs["cuda"].calculate_lpips(a, b)
    call_ms = (time.perf_counter() - t0) * 100
    res = {"phase": "evaluate", "gpu": gpu_line, "sheets": uids, "seeds": CLI_SEEDS,
           "metrics": list(FAMILIES), "cells_compared": len(scores["cpu"]),
           "card_vs_cpu_worst": worst,
           "tolerance": {k: f"{kind} {v}" for k, (kind, v) in tol.items()},
           "best_select_img_index": best["select_img_index"].astype(int).tolist(),
           "avg": {m: float(avg.loc[m, "Dataset Average"]) for m in FAMILIES},
           "lpips_ms_per_512_pair_device": lpips_ms,
           "lpips_ms_per_512_pair_calculate_lpips": call_ms,
           "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    if res["best_select_img_index"] != want_idx or any(
            abs(res["avg"][m] - want_avg[m]) > 1e-6 * max(1.0, abs(want_avg[m]))
            for m in FAMILIES):
        raise AssertionError(f"evaluate best/avg: {res['best_select_img_index']} vs {want_idx}, "
                             f"{res['avg']} vs {want_avg}")


def phase_modes(torch, gpu_line: str) -> None:
    """The pipeline's other conditioning modes at full width, 512²: bf16
    depth `latents` + normals `concat` (BrushNet with 12 conditioning
    channels), 4 steps; then fp32 depth `concat` + normals `latents`, one
    denoise step (slice_parity's depth), the card against the CPU."""
    import numpy as np

    from reflecting_reality_tpu_torch.cli.train import conditioning_channels_for
    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 5)
    mask = np.zeros((CLI_PX, CLI_PX, 3), np.float32)
    mask[128:384, 160:352] = 1.0
    kw = dict(prompt="a photo of a mirror on the wall",
              image=rng.rand(CLI_PX, CLI_PX, 3).astype(np.float32), mask=mask,
              depth=rng.rand(CLI_PX, CLI_PX, 1).astype(np.float32),
              normals=rng.rand(CLI_PX, CLI_PX, 3).astype(np.float32), guidance_scale=7.5,
              seed=SEED)

    def modules(depth_mode, normals_mode):
        torch.manual_seed(SEED)
        with torch.device("cuda"):
            unet, vae, text = UNet2DConditionModel(), AutoencoderKL(), CLIPTextModel()
            brushnet = BrushNetModel(
                conditioning_channels=conditioning_channels_for(depth_mode, normals_mode))
        fill_zero_convs(torch, brushnet, SEED, 0.02)
        return dict(vae=vae, text_encoder=text, unet=unet, brushnet=brushnet,
                    tokenizer=HashTokenizer(vocab_size=49408), depth_conditioning_mode=depth_mode,
                    normals_conditioning_mode=normals_mode)

    mods = modules("latents", "concat")
    channels = mods["brushnet"].conditioning_channels
    pipe = StableDiffusionBrushNetPipeline(**mods, dtype=torch.bfloat16, device="cuda")
    reset_counters()
    t0 = time.perf_counter()
    out = pipe(**kw, num_inference_steps=4, output_type="np")
    torch.cuda.synchronize()
    bf16 = {"depth": "latents", "normals": "concat", "conditioning_channels": channels,
            "s_4_steps": time.perf_counter() - t0, "launches": read_counters(),
            "shape": list(out.shape), "dtype": str(out.dtype), "std": float(out.std())}
    del pipe, mods
    torch.cuda.empty_cache()

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = modules("concat", "latents")
    cpu_mods = {k: copy.deepcopy(v).cpu() if isinstance(v, torch.nn.Module) else v
                for k, v in mods.items()}
    fp32 = dict(kw, num_inference_steps=1, output_type="latent", deterministic_vae_encode=True,
                latents=np.random.RandomState(SEED + 6).standard_normal(
                    (1, CLI_PX // 8, CLI_PX // 8, 4)).astype(np.float32))
    reset_counters()
    t0 = time.perf_counter()
    card = StableDiffusionBrushNetPipeline(**mods, device="cuda")(**fp32)
    t_card = time.perf_counter() - t0
    launched = read_counters()
    t0 = time.perf_counter()
    cpu = StableDiffusionBrushNetPipeline(**cpu_mods, device="cpu")(**fp32)
    t_cpu = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    scale = float(np.abs(cpu).max())
    err = float(np.abs(card - cpu).max())
    res = {"phase": "modes", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}", "bf16": bf16,
           "fp32_parity": {"depth": "concat", "normals": "latents",
                           "conditioning_channels": mods["brushnet"].conditioning_channels,
                           "steps": 1, "max_abs_err": err, "max_abs_tol": 1e-3 * scale,
                           "output_max_abs": scale, "finite": bool(np.isfinite(card).all()),
                           "launches": launched, "card_s": t_card, "cpu_s": t_cpu},
           "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    del mods, cpu_mods
    torch.cuda.empty_cache()
    bad = []
    if bf16["shape"] != [1, CLI_PX, CLI_PX, 3] or bf16["dtype"] != "uint8" or \
            not bf16["std"] > 0 or channels != 12:
        bad.append(f"bf16 image {bf16}")
    if bf16["launches"]["flash"] != 20 or bf16["launches"]["groupnorm"] == 0:
        bad.append(f"bf16 launches {bf16['launches']}")
    p = res["fp32_parity"]
    if not (p["finite"] and err <= p["max_abs_tol"]) or launched["flash"] != 5 \
            or launched["groupnorm"] == 0:
        bad.append(f"fp32 parity {p}")
    if bad:
        raise AssertionError(f"modes failed: {bad}")


# ------------------------------------------------------------------ main

AB_RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
          "cs.phase_build(torch); cs.phase_main(torch, cs.nvidia_smi())")


def ab_main_path(other: str, blocks: int) -> None:
    """The main path (phases build and main_path) of another checkout and of
    this one in turns, each in a process of its own: `blocks` times other,
    this, this, other; one `ab_main_path` line with each run's numbers."""
    runs = []
    order = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)] * blocks
    for name, tree in order:
        out = subprocess.run([sys.executable, "-c", AB_RUN], cwd=tree, capture_output=True,
                             text=True, timeout=900, check=True).stdout
        lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        main = next(d for d in lines if d.get("phase") == "main_path")
        prof = next(d for d in lines if d.get("phase") == "profile")
        runs.append({"tree": name, "s_per_step": main["s_per_step"],
                     "s_per_image_8_steps": main["s_per_image_8_steps"],
                     "s_each": {k: r["s_each"] for k, r in main["runs"].items()},
                     "launches_per_step": main["launches_per_step"],
                     "traced_idle_share": prof["device_idle_share"]})
    emit({"phase": "ab_main_path", "gpu": nvidia_smi(), "other": other, "runs": runs,
          "median_s_per_step": {n: statistics.median(r["s_per_step"] for r in runs
                                                     if r["tree"] == n)
                                for n in ("other", "this")},
          "median_s_per_image_8_steps": {n: statistics.median(r["s_per_image_8_steps"]
                                                              for r in runs if r["tree"] == n)
                                         for n in ("other", "this")}})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import reflecting_reality_tpu_torch  # noqa: F401  (fails outside a checkout)

    if sys.argv[1:2] == ["--ab-main-path"]:
        ab_main_path(os.path.abspath(sys.argv[2]), int(sys.argv[3]) if len(sys.argv) > 3 else 1)
        return 0
    gpu_line = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "device_count": torch.cuda.device_count(), "nvidia_smi": gpu_line,
          "importable": {m: importlib.util.find_spec(m) is not None for m in ABSENT_MODULES},
          "clocks_max_sm_mhz": max_sm_clock_hz() / 1e6})
    phase_build(torch)
    entries = phase_kernels(torch)
    phase_slice(torch)
    by_shape, main_per_step = phase_main(torch, gpu_line)
    phase_train_parity(torch)
    train_by_shape, train_s_step = phase_train_main(torch, gpu_line)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cli_by_shape = phase_train_cli(torch, gpu_line, train_s_step, tmp)
        test_by_shape, sheets, data = phase_test_cli(torch, gpu_line, tmp, main_per_step,
                                                     entries)
        phase_evaluate(torch, gpu_line, tmp, sheets, data)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_modes(torch, gpu_line)

    # each entry carries the launches of its own kernel, shape and dtype on
    # each path: the main path's 8-step call (and per denoise step), the
    # TRAIN_REPEATS timed training steps (and per training step), the
    # training CLI's first run (8 steps) and the test CLI's bf16 8-step and
    # fp32 4-step runs (2 rows of 4 seeds each)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    test_paths = {"test_cli_bf16_8_steps": test_by_shape["a_8_steps"],
                  "test_cli_fp32_4_steps": test_by_shape["b_fp32_4_steps"]}
    rows = []
    for e in entries:
        row = {k: e.get(k) for k in keys if k != "launches"}
        main_n, train_n = by_shape[8].get(e["key"], 0), train_by_shape.get(e["key"], 0)
        cli_n = cli_by_shape.get(e["key"], 0)
        test_n = {path: counts.get(e["key"], 0) for path, counts in test_paths.items()}
        row["launches"] = main_n + train_n + cli_n + sum(test_n.values())
        row["launches_by_path"] = {"main_path_8_steps": main_n,
                                   f"train_main_{TRAIN_REPEATS}_steps": train_n,
                                   "train_cli_8_steps": cli_n, **test_n}
        row["launches_per_denoise_step"] = (main_n - by_shape[4].get(e["key"], 0)) / 4
        row["launches_per_train_step"] = train_n / TRAIN_REPEATS
        row["launches_per_cli_step"] = cli_n / 8
        row.update({k: e[k] for k in e if k not in row and k not in ("key", "kernel", "ms")})
        rows.append(row)
    emit({"phase": "kernels_detail", "kernels": rows})
    summary = [r for r in rows if r["launches"] > 0]
    missing = {e["kernel"] for e in entries} - {e["kernel"] for e, r in zip(entries, rows)
                                                 if r["launches"] > 0}
    if missing:
        raise AssertionError(f"no measured shape of {missing} ran on a path")
    emit({"kernels": summary})
    print(gpu_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
