#!/usr/bin/env python3
"""The port's multi-device paths across the cards of one host (written for
four NVLink-joined H100s), what `chip_smoke.py` on one card cannot show:

    python3 chip_multicard.py

It needs at least two visible cards; N is their count.  Phases, each
printing one JSON line:
  1. env    torch/CUDA versions, the device count and every card's
            `nvidia-smi --query-gpu=name,power.limit` line.
  2. build  the kernel libraries (`chip_smoke.phase_build`).
  3. ddp_nccl  N ranks of `chip_smoke.py --ddp-step ... nccl` (rank r on
            card r), full width, fp32, TF32 off, each on its rows of the
            global batch of 4, against one process on the whole batch with
            the same seed (`chip_smoke.py`'s ddp tolerances: loss and
            gradient norm at 1e-4 relative, the gradient at 1e-3 of its
            largest); each rank's timed second step.
  4. train_cli  the training CLI at its default fp32, depth concat, batch 4
            a process, from a seeded base folder and 16-sample latent cache
            (`chip_smoke.write_base_folder`, `write_latent_cache`): one
            process, then `torchrun --standalone --nproc_per_node N` (NCCL),
            TRAIN_STEPS steps each: CLI s/step (median from step 2), samples/s
            and the scaling efficiency samples/s(N) / (N x samples/s(1)).
  5. data_parallel  the main path in bf16 with N seeds, 4 and 8 steps in
            turns: one call on card 0 against `enable_data_parallel(
            make_mesh())` over the N cards (s/step of both); the data-parallel
            8-step images against each seed's row called alone on card 0
            (uint8 within 1).
  6. sharded_vae  `sharded_decode_exact` of a 128x128 latent (1024²) over the
            N cards against the plain decode on card 0, fp32, TF32 off (rtol
            1e-4, atol 2e-5): seconds and each card's peak memory.
Then the run's seconds, card 0's nvidia-smi line and `{"ok": true, ...}`.
Any failed check raises and the script exits non-zero.  Weights are random,
made from a seed.
"""

from __future__ import annotations

import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_STEPS = 6
DP_REPEATS = 2


def phase_ddp_nccl(torch, cs, n: int, tmp: str) -> dict:
    from reflecting_reality_tpu_torch.tools.multiprocess_dryrun import free_port, spawn

    out = os.path.join(tmp, "ddp")
    os.makedirs(out)
    script = os.path.join(ROOT, "chip_smoke.py")
    port = str(free_port())
    t0 = time.perf_counter()
    spawn([[sys.executable, script, "--ddp-step", str(r), str(n), port, out, "nccl"]
           for r in range(n)], [os.path.join(out, f"rank{r}.log") for r in range(n)],
          timeout_s=900)
    ranks_s = time.perf_counter() - t0
    spawn([[sys.executable, script, "--ddp-step", "0", "1", "0", out]],
          [os.path.join(out, "one.log")], timeout_s=900)
    ranks = [torch.load(os.path.join(out, f"ddp_{n}p_{r}.pt"), weights_only=False)
             for r in range(n)]
    one = torch.load(os.path.join(out, "ddp_1p_0.pt"), weights_only=False)
    r0 = ranks[0]
    res = {"phase": "ddp_nccl", "world": n, "backend": "nccl", "dtype": "float32",
           "tf32": False, "global_batch": cs.DDP_WORLD * cs.DDP_RANK_BATCH,
           "loss_rel_err": abs(r0["loss"] - one["loss"]) / abs(one["loss"]),
           "grad_norm_rel_err": abs(r0["grad_norm"] - one["grad_norm"]) / one["grad_norm"],
           "rel_tol": 1e-4,
           "grad_max_abs_err": (r0["sample"] - one["sample"]).abs().max().item(),
           "grad_max_abs_tol": 1e-3 * one["g_max"],
           "ranks_identical": all(r["loss"] == r0["loss"] and torch.equal(r["sample"],
                                                                          r0["sample"])
                                  for r in ranks),
           "rank_step_s": [r["timed_step_s"] for r in ranks],
           "one_process_step_s": one["timed_step_s"],
           "rank_peak_bytes": [r["peak_bytes"] for r in ranks], "ranks_wall_s": ranks_s}
    cs.emit(res)
    if not (res["loss_rel_err"] <= 1e-4 and res["grad_norm_rel_err"] <= 1e-4
            and res["grad_max_abs_err"] <= res["grad_max_abs_tol"] and res["ranks_identical"]):
        raise AssertionError(f"ddp_nccl failed: {res}")
    return res


def phase_train_cli(torch, cs, n: int, tmp: str) -> dict:
    base, data, cache = (os.path.join(tmp, d) for d in ("base", "data", "cache"))
    os.makedirs(data)
    cs.write_base_folder(torch, base)
    cs.write_latent_cache(data, cache, cs.CLI_SAMPLES)
    torch.cuda.empty_cache()
    runs = {}
    for procs in (1, n):
        out = os.path.join(tmp, f"run{procs}")
        argv = ["--pretrained_model_name_or_path", base, "--train_data_dir", data,
                "--output_dir", out, "--logging_dir", os.path.join(out, "logs"),
                "--train_batch_size", str(cs.TRAIN_BATCH), "--depth_conditioning_mode",
                "concat", "--learning_rate", "5e-6", "--lr_warmup_steps", "0",
                "--precomputed_latents_dir", cache, "--dataloader_num_workers", "4",
                "--log_every", "1", "--validation_steps", "0", "--report_to", "none",
                "--seed", "0", "--max_train_steps", str(TRAIN_STEPS),
                "--checkpointing_steps", str(10 * TRAIN_STEPS)]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={procs}", "-m", "reflecting_reality_tpu_torch.cli.train",
               *argv]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=1200)
        wall = time.perf_counter() - t0
        if done.returncode != 0:
            raise RuntimeError(f"torchrun x{procs} failed:\n{done.stdout[-4000:]}")
        rows = [r for r in cs.read_metrics(out) if "loss" in r]
        timed = [r["s_per_step"] for r in rows if r["step"] >= 2]
        runs[procs] = {"processes": procs, "global_batch": procs * cs.TRAIN_BATCH,
                       "cli_s_per_step_median_steps_2_on": statistics.median(timed),
                       "samples_per_s": procs * cs.TRAIN_BATCH / statistics.median(timed),
                       "losses": [r["loss"] for r in rows], "wall_s": wall}
        shutil.rmtree(out)
    res = {"phase": "train_cli", "dtype": "float32 (the CLI's default)",
           "batch_per_process": cs.TRAIN_BATCH, "steps": TRAIN_STEPS,
           "one": runs[1], "many": runs[n],
           "scaling_efficiency": runs[n]["samples_per_s"] / (n * runs[1]["samples_per_s"])}
    cs.emit(res)
    if len(runs[n]["losses"]) != TRAIN_STEPS or not all(map(math.isfinite, runs[n]["losses"])):
        raise AssertionError(f"train_cli failed: {res}")
    return res


def phase_data_parallel(torch, cs, n: int) -> dict:
    import numpy as np

    from reflecting_reality_tpu_torch.parallel.mesh import make_mesh
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    lat = np.random.RandomState(cs.SEED + 31).standard_normal(
        (n, cs.CLI_PX // 8, cs.CLI_PX // 8, 4)).astype(np.float32)
    kw = dict(cs.pipeline_inputs(cs.SEED), num_images_per_prompt=n, latents=lat,
              deterministic_vae_encode=True)
    pipe = StableDiffusionBrushNetPipeline(**cs.full_width_modules(torch), dtype=torch.bfloat16,
                                           device="cuda")
    rows = np.concatenate([pipe(**dict(kw, num_images_per_prompt=1, latents=lat[i:i + 1]),
                                num_inference_steps=8) for i in range(n)])
    mesh = make_mesh()
    runs = {}
    for name in ("one_card", "data_parallel"):
        if name == "data_parallel":
            pipe.enable_data_parallel(mesh)
        pipe(**kw, num_inference_steps=2)                 # warm
        each = {4: [], 8: []}
        for _ in range(DP_REPEATS):
            for steps in (4, 8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = pipe(**kw, num_inference_steps=steps)
                for d in mesh:
                    torch.cuda.synchronize(d)
                each[steps].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) for k, v in each.items()}
        runs[name] = {"s_per_step": (med[8] - med[4]) / 4, "s_8_steps": med[8], "image": img}
    pipe.disable_data_parallel()
    res = {"phase": "data_parallel", "mesh": [str(d) for d in mesh], "seeds": n,
           "dtype": "bfloat16",
           **{name: {k: v for k, v in r.items() if k != "image"} for name, r in runs.items()},
           "uint8_max_diff_from_rows_alone": int(np.abs(
               runs["data_parallel"]["image"].astype(np.int16) - rows.astype(np.int16)).max())}
    res["speedup"] = runs["one_card"]["s_per_step"] / runs["data_parallel"]["s_per_step"]
    cs.emit(res)
    del pipe
    torch.cuda.empty_cache()
    if res["uint8_max_diff_from_rows_alone"] > 1:
        raise AssertionError(f"data_parallel failed: {res}")
    return res


def phase_sharded_vae(torch, cs, n: int) -> dict:
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.parallel.mesh import make_mesh, replicated
    from reflecting_reality_tpu_torch.parallel.sharded_vae import sharded_decode_exact

    mesh = make_mesh()
    torch.manual_seed(cs.SEED)
    with torch.device("cuda:0"):
        vae = AutoencoderKL().eval()
    reps = replicated(vae, mesh)
    z = 0.5 * torch.randn(1, 4, 128, 128, generator=torch.Generator("cuda:0").manual_seed(
        cs.SEED), device="cuda:0")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        with torch.inference_mode():
            for name, fn in (("plain", lambda: vae.decode(z)),
                             ("exact", lambda: sharded_decode_exact(vae, z, mesh, replicas=reps))):
                fn()
                for d in mesh:
                    torch.cuda.synchronize(d)
                    torch.cuda.reset_peak_memory_stats(d)
                before = [torch.cuda.memory_allocated(d) for d in mesh]
                t0 = time.perf_counter()
                img = fn()
                for d in mesh:
                    torch.cuda.synchronize(d)
                out[name] = {"s": time.perf_counter() - t0, "image": img,
                             "peak_bytes_above_inputs": [
                                 torch.cuda.max_memory_allocated(d) - b
                                 for d, b in zip(mesh, before)]}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    a, b = out["exact"]["image"], out["plain"]["image"]
    excess = ((a - b).abs() - (2e-5 + 1e-4 * b.abs())).max().item()
    res = {"phase": "sharded_vae", "mesh": [str(d) for d in mesh], "dtype": "float32",
           "max_abs_diff": (a - b).abs().max().item(), "within_rtol_1e-4_atol_2e-5": excess <= 0,
           **{name: {k: v for k, v in r.items() if k != "image"} for name, r in out.items()}}
    cs.emit(res)
    del vae, reps, out, a, b
    torch.cuda.empty_cache()
    if not res["within_rtol_1e-4_atol_2e-5"]:
        raise AssertionError(f"sharded_vae failed: {res}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_multicard: needs at least two CUDA devices", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import reflecting_reality_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    n = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE, text=True).stdout
    cs.emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
             "device_count": n, "nvidia_smi": smi.strip().splitlines()})
    cs.phase_build(torch)
    tmp = tempfile.mkdtemp(prefix="chip_multicard_")
    try:
        phase_ddp_nccl(torch, cs, n, tmp)
        phase_train_cli(torch, cs, n, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_data_parallel(torch, cs, n)
    phase_sharded_vae(torch, cs, n)
    cs.emit({"phase": "run", "seconds": time.perf_counter() - t_start})
    print(cs.nvidia_smi(), flush=True)
    cs.emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                    "count": n}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
