#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

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
             the shapes the main path and the training step give it (every
             GroupNorm shape of a denoise step, recorded from the full-width
             modules on the meta device) and a few they meet elsewhere
             (1024², 576x512, fp32 parity, and the self-attention shapes the
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
             checkpointing, and one traced step (idle share, device time by
             kind).  Every loss finite, BrushNet moved, UNet/VAE/CLIP
             bit-identical, and per step B1/B3/B4 launch 5/5/5 (10/5/5 with
             checkpointing).
Then `kernels_detail` (every measured kernel and shape with the launches
each path gave that shape: the main path's 8-step call and the timed
training steps, 0 where none), the `{"kernels": [...]}` summary line (the
kernels and shapes the paths launched), the nvidia-smi name/power-limit
line, and last `{"ok": true, "device": {...}}`.  Any failed check raises and
the script exits non-zero; without a CUDA device it exits non-zero at once.
Weights are random, made from a seed.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
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
    import shutil

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
    gn_cases |= {(shape, torch.bfloat16, silu) for shape, silu in main_path_groupnorms(torch)[0]}
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
    return by_shape


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
          "gradient_checkpointing_step": ckpt, "trace": traced})
    if not all(v > 0 for v in moved.values()) or not all(frozen_same.values()):
        raise AssertionError(f"train step moved {moved}, frozen unchanged {frozen_same}")
    want = {"flash": 5, "flash_bwd_dq": 5, "flash_bwd_dkv": 5}
    if any(per_step[k] != v for k, v in want.items()) or per_step["groupnorm"] == 0:
        raise AssertionError(f"train step launches per step {per_step}, want {want}")
    got_ckpt = ckpt["launches"]
    if (got_ckpt["flash"], got_ckpt["flash_bwd_dq"], got_ckpt["flash_bwd_dkv"]) != (10, 5, 5):
        raise AssertionError(f"checkpointed step launches {got_ckpt}, want 10/5/5")
    del state, unet, brushnet, vae, text
    torch.cuda.empty_cache()
    return by_shape


# ------------------------------------------------------------------ main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import reflecting_reality_tpu_torch  # noqa: F401  (fails outside a checkout)

    gpu_line = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "device_count": torch.cuda.device_count(), "nvidia_smi": gpu_line,
          "clocks_max_sm_mhz": max_sm_clock_hz() / 1e6})
    phase_build(torch)
    entries = phase_kernels(torch)
    phase_slice(torch)
    by_shape = phase_main(torch, gpu_line)
    phase_train_parity(torch)
    train_by_shape = phase_train_main(torch, gpu_line)

    # each entry carries the launches of its own kernel, shape and dtype on
    # each path: the main path's 8-step call (and per denoise step) and the
    # TRAIN_REPEATS timed training steps (and per training step)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for e in entries:
        row = {k: e.get(k) for k in keys if k != "launches"}
        main_n, train_n = by_shape[8].get(e["key"], 0), train_by_shape.get(e["key"], 0)
        row["launches"] = main_n + train_n
        row["launches_by_path"] = {"main_path_8_steps": main_n,
                                   f"train_main_{TRAIN_REPEATS}_steps": train_n}
        row["launches_per_denoise_step"] = (main_n - by_shape[4].get(e["key"], 0)) / 4
        row["launches_per_train_step"] = train_n / TRAIN_REPEATS
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
