#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --ab-main-path OTHER_CHECKOUT [BLOCKS]
    python3 chip_smoke.py --ab-train-cli-fp32 OTHER_CHECKOUT [BLOCKS]
    python3 chip_smoke.py --train-cli-fp32 [CHECKOUT]
    python3 chip_smoke.py --ddp-step RANK WORLD PORT OUT [BACKEND]   (a rank of phase 19)
    python3 chip_smoke.py --sdxl      (phases 2 and 22 alone, B1 at SDXL's shapes)
    python3 chip_smoke.py --flux      (phase 2, B1 at FLUX.1's shape, a FLUX.1 Fill call)
    python3 chip_smoke.py --backend-memory-cache   (phases 2 and 23-25 alone)
    python3 chip_smoke.py --cache-child DIR [--no-nvcc]   (a process of phase 25)
    python3 chip_smoke.py --train-cli-modes TMP OUT_JSON   (a process of phase 9)
    python3 chip_smoke.py --cpu-references DIR   (the reference process, below)

The second form times the main path (phases 2 and 5 below) of another
checkout (e.g. the parent commit unpacked with `git archive`) and of this
one in turns, BLOCKS (default 1) times other, this, this, other, each run in
a process of its own, and prints one `ab_main_path` line.  The third does
the same for phase 12 (the training CLI at its default fp32), each run a
process of the fourth form, which runs that phase alone with the package
of CHECKOUT (default this one) on a base folder and latent cache it writes.

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
             must hold HGMMA and UTMALDG, each of the twelve fp32 instances
             of B1, B3 and B4 (`flash_fwd_tf32<DP>`, `flash_bwd_dq_tf32<DP>`,
             `flash_bwd_dkv_tf32<DP>`) TF32 HGMMA and UTMALDG of its own,
             the GroupNorm library cluster barriers; no wgmma or fp32
             instance of the flash libraries may spill, ptxas may give
             neither flash library a performance warning (C75xx: wgmmas
             serialised, setmaxnreg ignored), and the libraries' tilings
             must be `bwd_plan`'s, `bwd_f32_plan`'s and `fwd_f32_plan`'s.
  3. kernels every kernel against its plain PyTorch version on the card, at
             the shapes the main path, the training step and the test CLI
             give it (every GroupNorm shape of a denoise step and of the
             VAE, recorded from the full-width modules on the meta device,
             at the main path's batches and at the test CLI's 4 batched
             seeds in bf16 and its batches in fp32) and a few they meet
             elsewhere (1024², 576x512, fp32 parity; B1 at every attention of
             the SD-1.5 UNet at the main path's, the server's and the fp32
             paths' rows, self- and cross-attention, and of SDXL's): max abs
             error in the
             working dtype and against fp32 and the relative L2 error, each
             with its tolerance; kernel, plain and library times (20
             back-to-back calls, host launch cost included), the kernel's
             device time (a CUDA graph of the same 20 calls), the roofline
             bound and, for flash, the exponential bound (one exp2 per logit
             at 16 per clock per SM, at nvidia-smi's clocks.max.sm); an fp32
             flash kernel's bound is its work as three TF32 passes a
             product at 495 TFLOP/s (what an fp32-accurate kernel does on
             this card), `simt_bound_ms` the same work on the CUDA cores.  The
             flash backward kernels (B3 dQ, B4 dK/dV) are held to
             `flash_attention_bwd_plain` on B1's own out and lse, and two
             launches of each on the same inputs must be bit-identical; their
             library time is SDPA's backward.
  4. slice   SD-1.5 UNet + BrushNet(conditioning_channels=6) at the
             published widths and PARITY_DEPTH (one resnet a level, so that
             the CPU's side takes about half the time), one denoise step's
             forward at 64x64 latents, batch 2, fp32 with TF32 off: the card
             (kernels; B1 20 launches, every attention of the forward)
             against the CPU (plain versions).
  5. main    StableDiffusionBrushNetPipeline at full SD-1.5 width in bf16:
             512x512, CFG 7.5, UniPC, depth concat; a warm run, then timed
             4- and 8-step runs in turns, MAIN_REPEATS of each (medians;
             s/step is their two-point difference).  In every run the flash
             kernel must launch exactly 32 x steps times and the GroupNorm
             kernel at least once, and every GroupNorm shape of a denoise
             step must take the single-pass (cluster) regime.
  6. profile one traced 4-step call: device busy time, idle share, device
             time by kind of kernel and the top kernels (torch.profiler).
  7. train_parity  UNet + BrushNet (`from_unet`, seeded zero convs) at the
             published widths and PARITY_DEPTH, fp32 with TF32 off, 64x64
             latents, batch 1: one loss and
             backward on the card (through the kernels' autograd Functions)
             against the CPU (plain paths) on the same draws: the loss and
             four BrushNet gradients, each with its tolerance; B1/B3/B4 must
             launch 20/20/20 times and GroupNorm at least once.
  8. train_main  the training step (`make_train_step`) at full width: bf16
             autocast, frozen UNet/VAE/CLIP stored in bf16, fp32 BrushNet
             master weights, 512² batch 4, depth concat, AdamW lr 5e-6 without
             warm-up.  A warm step, then TRAIN_REPEATS timed steps (median
             s/step, samples/s, peak memory), one step with gradient
             checkpointing under each policy ("full", "dots"), and one traced
             step (idle share, device time by kind).  Every loss finite,
             BrushNet moved, UNet/VAE/CLIP bit-identical, and per step
             B1/B3/B4 launch 32/32/32 (64/32/32 with checkpointing under either
             policy).
  9. train_cli  the training CLI (`cli.train.main`) end to end: a base
             folder at full SD-1.5 width from seeded weights in bf16
             safetensors (written by the port's `save_pretrained`), a
             16-sample 512² latent-moments cache and its train.csv; 8 steps
             (bf16, batch 4, depth concat, checkpoints every 4, total limit
             1), a resume to step 10, 4 steps with --device_cache and 4 with
             --steps_per_dispatch 2 and --async_save (these two in a process
             of their own, `--train-cli-modes`, beside the resume and the
             checks after it: their s/step are not speed figures); then
             `StableDiffusionBrushNetPipeline.from_pretrained` on
             checkpoint-8 with the safetensors package blocked and a 4-step
             512² call.  Checks: finite losses, BrushNet moved, frozen modules
             bit-identical to the folder, checkpoint-4 pruned, the resume
             bit-identical (BrushNet, AdamW moments, step 8), 32/32/32 launches
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
             constant, launches per denoise step equal to main_path's (B1 32,
             B2 the same) in both dtypes, no h5py or jax imported.  Prints
             s/image, s/step (two-point), the host time per row outside the
             card's work and how much of it the one-deep overlap hid, peak
             memory, B1's fp32 launches and their share of an fp32 step.
 11. evaluate  on run a's sheets: MetricsCalculator (PSNR/SSIM/LPIPS of the
             full, mask and mirror families, LPIPS weights from a seed) on
             the card against the CPU (LPIPS 1e-4 relative, PSNR 1e-3 dB,
             SSIM 1e-5), `metrics/evaluate.py --mode avg` (best and avg CSVs)
             on CSVs written from the card's scores, LPIPS ms per 512² pair.
 12. train_cli_fp32  the training CLI at its default `--mixed_precision no`
             (fp32, the users' default step) on train_cli's base folder and
             latent cache: 6 steps, 512² batch 4, depth concat, no checkpoint
             within the run (the CLI's final one is deleted), no validation.
             Checks: finite losses, BrushNet moved, B1/B3/B4 each launched 5
             times a step at (4, 4096, 8, 40) fp32.  Prints s/step (median of
             steps 2-6), samples/s, peak memory and the launches.
     fp32_conv_cost  C4's cost, TF32 at its default, in turns
             (FP32_COST_REPEATS, 2) in one process: the fp32 pipeline step
             (512², one image) and the fp32 training step (full width, batch
             4) with full-fp32 cuDNN convolutions, as the port runs them,
             against one TF32 pass.
 13. ip_adapter  the normals ip_adapter mode at full width, 512²: the
             pipeline (depth concat + the mean normal's token; IP UNet and
             NormalProjModel from a seed) in bf16, CFG 7.5, UniPC, 4- and
             8-step calls in turns (IP_REPEATS, 2, each; s/step, s/image, peak
             memory, B1 384 launches in 8 steps: each cross-attention runs a
             second one over the normal's token), another normal must change
             the image, one fp32 step card vs CPU at PARITY_DEPTH (B1 30
             launches); then the training CLI in ip mode at its default fp32
             from the base folder and a latent cache with normals: batch 4,
             IP_TRAIN_STEPS steps with a checkpoint at the end (unet/ and
             ip_adapter/normal_proj), a resume to +2.  Checks: every non-IP UNet weight
             bit-identical to the base folder, every to_k_ip/to_v_ip moved,
             B1/B3/B4 5/5/5 a step at (4, 4096, 8, 40) fp32, finite losses.
 14. serve   `cli/serve.py` as started by a user (its parser and
             `build_pipeline` on the base folder and checkpoint-8's
             BrushNet, bf16, `--max_batch 4`, `warmup` at 512²) behind its
             HTTP handler on 127.0.0.1 in a thread: /healthz (the card's
             name), one solo request, then SERVE_REQUESTS concurrent ones at
             SERVE_STEPS steps (PNG inputs, a 16-bit depth PNG): latency p50
             and p95, images/s, the batches formed; the solo reply within 1
             uint8 level of a direct, eager pipeline call on the same
             payload.  The server steps on CUDA graphs: /healthz's graph
             counters show replays, and the solo request again under the
             profiler launches two graphs a step, with B1 and B2 among the
             kernels those launch: each B1 and B2 kernel as often as the
             eager call's denoise loop launches it.  Then the same with `--int8`
             (`serve_int8`, eager: no graph): images/s beside the exact
             server's, B1, B2 and int8 GEMMs launched.
 15. baseline  the SD-inpainting baseline at full width: its training step
             (the whole 10-channel UNet trainable, fp32 as the baseline
             CLI's default, 512² batch 4, depth concat, AdamW lr 5e-6): a
             warm step and BASELINE_STEPS timed ones (median s/step, peak
             memory, B1/B3/B4 5/5/5 a step at (4, 4096, 8, 40) fp32, conv_in
             moved), one step at batch 1 card vs CPU on the same draws, UNet
             and VAE at PARITY_DEPTH (the loss at 1e-4, the first AdamW
             moment of four leaves at 1e-3 of each one's largest element;
             B1/B3/B4 20/20/20), `save_pretrained` to
             checkpoint-N/unet, then `cli.test_baseline.main --image_mode` on
             it at its default fp32: 2 rows, 4 seeds, 4 steps, 1024x1024
             sheets, B1 1024 launches.  (The card has no h5py, so the
             baseline training CLI's HDF5 reader runs only in the CPU
             tests.)
 16. modes   a full-width 512² bf16 pipeline call, 4 steps, depth `latents`
             + normals `concat` (BrushNet with 12 conditioning channels):
             a finite, non-constant uint8 image, B1 128 launches; then fp32
             depth `concat` + normals `latents` at PARITY_DEPTH, one denoise
             step, TF32 off, the card against the CPU at slice parity's
             tolerance (the normals drawn from their own seed; B1 20
             launches).
 17. approx  the main path (bf16, 512², 4 and 8 steps in turns, APPROX_REPEATS,
             3, each) exact, with
             DeepCache every 3 steps and with encoder reuse every 3 steps in
             one process: s/step and s/image of each beside the exact
             path's, each 8-step image's mean and max uint8 difference from
             the exact one, B1 launches (256, 146, 196 in 8 steps); then
             `tiled_decode` of a 128x128 latent (a 1024² image) against the
             plain decode: seconds, peak memory above the inputs, max and
             mean difference, the tiled decode's launches.
 18. int8    W8A8 int8 (`enable_int8()`, the default policy) at full width,
             bf16, 512²: the main path exact, then quantized in place, 4-
             and 8-step calls in turns (INT8_REPEATS, 2, each): s/step, s/image,
             peak memory, the quantized-module counts (256 UNet, 92
             BrushNet: JAX's selection), the 8-step image's mean and max
             uint8 difference from the exact one, B1 256 launches, the int8
             GEMMs launched; what `torch._int_mm` accepts at its edges;
             every int8 GEMM shape the 8-step call launched, `int8_mm` held
             exactly against an fp64 product on the card and timed beside
             the whole int8 layer and the bf16 conv or linear it replaces;
             one fp32 int8 denoise step card vs CPU at PARITY_DEPTH, held to
             the int8 mode's own error (within twice the CPU's int8-vs-exact
             difference, max and mean: a code flip on one side cascades),
             and the exact fp32 step beside it at 1e-3; then (C5) one
             `Int8Conv2d` (3x3, input (2, 640, 64, 64)) and one fused-qkv
             `Int8Linear` group (input (2, 4096, 320)) card vs CPU on the
             same fp32 input, TF32 off: equal activation scales, codes
             equal except at rounding ties (counted and printed), outputs
             within two fp32 ulps of the CPU's (|d| <= 2^-22 |cpu|).
 19. ddp     data-parallel training on the one card: DDP_WORLD processes
             (`--ddp-step`, this script) in a gloo group, each at full width,
             fp32, TF32 off, its DDP_RANK_BATCH rows of a global batch in
             the latent cache's form, one step, against one process on the
             whole batch with the same seed: loss and gradient norm at
             1e-4 relative, every DDP_SAMPLE_STRIDE-th element of the
             averaged gradient (recovered from AdamW's first moment) at
             1e-3 of its largest, the ranks identical, B1/B3/B4 5/5/5 a
             rank step at (2, 4096, 8, 40) fp32; a second, timed step (its
             seconds include gloo staging through the host: not a scaling
             figure).  The ranks and the one-process reference run side by
             side.  The children load the libraries phase 2 built.  Then
             the training CLI as torchrun starts one process (NCCL,
             WORLD_SIZE=1) at fp32, batch 4: DDP_CLI_STEPS steps with a
             checkpoint from rank 0, a resume to DDP_CLI_RESUME_TO; its
             s/step beside train_cli_fp32's.
 20. data_parallel  `enable_data_parallel` over a mesh of two `cuda:0`
             entries, full width, bf16, DP_SEEDS seeds, 4 and 8 steps in
             turns, beside the same calls without it (s/step of both; B1 512
             launches in 8 steps); the 8-step images against each
             replica's rows called alone (uint8 within 1; a bf16 batch of 4
             takes other kernels than two of 2, so its difference from the
             undivided call is printed, not held); fp32 one step TF32 off
             against the undivided call at 1e-5 of max; `cli/test.py --data_parallel
             --batch_seeds` (one replica) on checkpoint-8 and `cli/serve.py
             --data_parallel` with a burst of three requests.
 21. sharded_vae  the sharded decodes of a 128x128 latent (1024²) over a
             mesh of SHARDS `cuda:0` entries, fp32, TF32 off: the exact one
             against the plain decode (rtol 1e-4, atol 2e-5), the blended one
             against `tiled_decode` (rtol 1e-4, atol 1e-5); seconds and peaks.
 22. sdxl    `StableDiffusionXLBrushNetPipeline` at the full published
             SDXL-base width (stabilityai/stable-diffusion-xl-base-1.0:
             UNet 320/640/1280, transformer depths 1/2/10, head dim 64,
             cross dim 2048, text_time; BrushNet `config_from_unet` with 6
             conditioning channels; CLIP-L and bigG; the SD VAE) from
             seeded weights made on the card, bf16, 1024², CFG 7.5, UniPC,
             depth concat: 4- and 8-step calls in turns (SDXL_REPEATS, 2, each;
             s/step, s/image, peak memory, B1 and B2 launches by shape a
             denoise step, the attentions of a UNet forward by route (the
             pipeline's `stats()`: 140 flash, 0 plain), and B1's launches by
             shape exactly a self- and a cross-attention (77 keys) a
             transformer layer: 10 layers at 4096 tokens, 60 at 1024), a
             traced 4-step call (idle share); one fp32 denoise step and
             decode card vs CPU at 1e-3 of the output's max under C4's rule
             (the transformer depth cut to 1/1/1, one resnet a level in the
             UNet, BrushNet and VAE, 2-layer text encoders, SDXL_PARITY_*; B1
             14 launches, 7 layers; phase 3 measures SDXL_FULL_DEPTH_NORM,
             the B2 shape only two resnets a level give); B1's head-dim-64
             instances without spills.  Its norms' shapes are measured by
             `kernels_late`.
 23. attention_backend  `--attention_backend xla` against the default
             `flash`: one fp32 pipeline step (TF32 off) at 1e-3 of the
             output's max; the 512² bf16 pipeline (4- and 8-step calls,
             BACKEND_REPEATS, 2, each) and the bf16 training step at batch 4
             (BACKEND_TRAIN_STEPS, 2, timed), the backends in turns: s/step,
             peak memory, a traced 2-step call each (device busy time, idle
             share), launches (B1/B3/B4 none under xla), the 8-step images'
             uint8 difference; `cli.test.main --attention_backend xla` on
             checkpoint-8 (2 rows, 2 steps, no B1 launch).
 24. aot_memory  `tools/aot_memory.py` at full width, 512²: its CLI as a
             user runs it (the reference recipe, planned and measured), the
             plans and real runs (two steps, `max_memory_allocated`) of the
             other AOT_RECIPES, in processes started together, then the
             largest batch per card the plan fits for the AOT_SEARCH recipes
             (a line through the plans at the largest batch found before and
             the next, which are then the search's check when that holds;
             every plan started at once at a lower priority than the CLI,
             each recipe planned once) and its
             real run, in the process that measured the others: every
             measured peak within 10% of its plan,
             or 1 GiB.  Seconds of each stage in `stages_s`.
 25. compilation_cache  a fresh process builds the libraries into a new
             directory through the test CLI's `--compilation_cache_dir`; a
             second loads them with nvcc forbidden (under 1 s); B1 and B2
             from them against their plain versions.  Phases 24 and 25 run
             side by side: 25 in a thread during 24's first plans and
             measurements, waited for before 24's largest batches.
C4: train_parity and every `card_vs_cpu_one_step` run the card again with
TF32 at PyTorch's default, bare (`tf32_default`: cuDNN convolutions in one
TF32 pass, what the fp32 paths ran before C4's repair) and as the port runs
its fp32 paths (`tf32_default_fp32_convolutions`), each error beside the
TF32-off check's tolerance; the second must meet it (int8: printed only).
The CPU sides of the fp32 steps of ip_adapter, baseline, modes, int8 and
sdxl come from the reference process (`--cpu-references DIR`, started
first): it makes each step's modules on the card from the phase's seed
during phase 2 (phase 3 waits for it to leave the card), keeps their
fingerprint (each phase checks its own against it) and computes the steps
on the CPU at the lowest priority, off two cores.  It is stopped (SIGSTOP)
through the phases whose speed PERF.md quotes (main, profile, train_main,
train_cli, test_cli, train_cli_fp32, serve, ddp's NCCL CLI, data_parallel,
sdxl), through phase 3's timings and through the CPU sides that slice and
train_parity compute themselves, but for any wait of a phase for its
file; it ends before phase 24.
Then `kernels_late` (any kernel shape a path launched that phase 3 did not
list, measured and checked against its plain version now), `kernels_detail`
(every measured kernel and shape with the launches each path gave that
shape: the main path's 8-step call, the timed training steps, the CLI's
first 8 steps, the test CLI's bf16 8-step and fp32 4-step runs,
train_parity's fp32 step, the fp32 CLI's 6 steps, the ip pipeline's 8-step
call, the ip training CLI's first run, the served requests (exact and
int8), the baseline's timed training steps and its test CLI run, the modes
phase's bf16 call, the cached modes' 8-step calls, the tiled decode, the
int8 pipeline's 8-step call, rank 0's ddp step, the one-rank NCCL CLI run,
the data-parallel 8-step call, test CLI run and served requests, the
sharded decodes, SDXL's bf16 8-step call and fp32 step, and the attention
backends' 8-step calls, training steps and xla test CLI run, 0 where none;
the run fails if a path launched a shape with no entry), `phase_seconds`
(each phase's `phase_wall_s` by the name on its line, and `run_s`, the
seconds since the script started; phases 24 and 25 overlap, so their sum
exceeds the run), the
`{"kernels": [...]}` summary line (the kernels and shapes the paths
launched), the run's seconds, the nvidia-smi name/power-limit line, and
last `{"ok": true, "device": {...}}`.  Any failed check raises and
the script exits non-zero; without a CUDA device it exits non-zero at once.
Weights are random, made from a seed.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
TF32_DEFAULT = (False, True)        # (matmul, cuDNN) as PyTorch starts; read again in main
ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
MAIN_REPEATS = 5                    # timed 4- and 8-step calls of each count
TRAIN_REPEATS = 5                   # timed training steps
TRAIN_BATCH = 4                     # the training CLI's --train_batch_size default
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
SMS = 132                           # H100 SXM streaming multiprocessors
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core bf16
              "tf32": 495e12,       # dense tensor-core TF32
              "int8": 1979e12,      # dense tensor-core int8 (TOP/s)
              "float32": 67e12}     # fp32 outside the tensor cores
TF32_PASSES = 3                     # an fp32-accurate product on TF32 (hi·lo + lo·hi + hi·hi)
# the fp32 card-vs-CPU steps of slice, train_parity, ip_adapter, baseline,
# modes and int8 (and SDXL's VAE): the published widths with one resnet a
# level in the UNet, BrushNet and VAE, so that the CPU's side takes about
# half the time; B1 and B2 still launch at the full-depth paths' shapes
PARITY_DEPTH = dict(layers_per_block=1)
FLUX_STEPS = 4                      # the counted FLUX.1 Fill call's denoise steps
FLUX_JOINT_ATTENTIONS = 57          # FLUX.1's 19 double- and 38 single-stream blocks, a step


def attentions_per_unet_forward(layers_per_block: int = 2, ip: bool = False) -> int:
    """An SD-1.5 UNet forward's attentions at 512², every one B1's: a self-
    and a cross-attention in each transformer block (`layers_per_block` in
    each of down blocks 0-2, one in the mid block, one more in each of up
    blocks 1-3); with `ip` (the IP-Adapter UNet) each cross-attention runs a
    second one, over the image tokens."""
    return (3 if ip else 2) * (6 * layers_per_block + 4)


PHASE_SECONDS = {}                  # {phase: its phase_wall_s}, for the phase_seconds line


def emit(obj) -> None:
    if "phase_wall_s" in obj:
        PHASE_SECONDS[obj["phase"]] = obj["phase_wall_s"]
    print(json.dumps(obj), flush=True)


def emit_phase_seconds() -> None:
    """One line of every phase's wall seconds so far, and the run's."""
    emit({"phase": "phase_seconds", "seconds": PHASE_SECONDS,
          "run_s": time.perf_counter() - T_START})


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


def flash_bound(flops: float, nbytes: float, dtype: str) -> dict:
    """The bound of a flash kernel's work: bf16 on the tensor cores; fp32 as
    an fp32-accurate kernel does it on this card, three TF32 passes a
    product (`bound_ms`), with the same work on the CUDA cores beside it
    (`simt_bound_ms`)."""
    if dtype == "bfloat16":
        ms, by = bound(flops, nbytes, dtype)
        return {"bound_ms": ms, "bound_by": by}
    ms, by = bound(TF32_PASSES * flops, nbytes, "tf32")
    return {"bound_ms": ms, "bound_by": by, "simt_bound_ms": bound(flops, nbytes, "float32")[0]}


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


# ---------------------------------------------------------------- phase 2

SASS_COUNTS = ("HGMMA", "UTMALDG", "UCGABAR")   # wgmma, TMA tensor load, cluster barrier
SASS_WANT = {"flash_attn_fwd": ("HGMMA", "UTMALDG"), "flash_attn_bwd": ("HGMMA", "UTMALDG"),
             "groupnorm": ("UCGABAR",)}
# (library, the instances that may not spill, how many there are)
NO_SPILLS = (("flash_attn_bwd", "wgmma", 8), ("flash_attn_bwd", "tf32", 8),
             ("flash_attn_fwd", "tf32", 4))
F32_DIMS = (40, 64, 80, 160)               # the fp32 instances of B1, B3 and B4
NO_C75 = ("flash_attn_fwd", "flash_attn_bwd")  # libraries ptxas may not warn about
LIBRARIES = ("flash_attn_fwd", "flash_attn_bwd", "groupnorm")


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


def sass_by_function(text: str, which: str) -> dict:
    """{function: {"HGMMA_TF32", "UTMALDG"}} for each function of a
    `cuobjdump -sass` listing whose mangled name holds `which`: its TF32
    wgmma and TMA-load instructions."""
    out, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1) if which in m.group(1) else None
            if fn:
                out[fn] = {"HGMMA_TF32": 0, "UTMALDG": 0}
        elif fn:
            out[fn]["HGMMA_TF32"] += "HGMMA" in ln and ".TF32" in ln
            out[fn]["UTMALDG"] += "UTMALDG" in ln
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


def build_libraries() -> dict:
    """Every kernel library built and loaded, one nvcc per source, all
    started together -> {library: seconds from the start until it loaded}."""
    from concurrent.futures import ThreadPoolExecutor

    from reflecting_reality_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()

    def nvcc_build(name: str) -> float:
        build.load(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        return {n: f.result() for n, f in
                {n: pool.submit(nvcc_build, n) for n in LIBRARIES}.items()}


def phase_build(torch):
    from reflecting_reality_tpu_torch.ops.kernels import build
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    names = LIBRARIES
    built_now = {n: not build.library_path(n).exists() for n in names}
    t_nvcc = build_libraries()
    ptxas, warnings, sass, f32_sass = {}, {}, {}, {}
    tool = cuobjdump()

    def disassemble(n):
        return subprocess.run([tool, "-sass", str(build.library_path(n))], capture_output=True,
                              text=True, timeout=300, check=True).stdout

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(names)) as pool:      # one cuobjdump a library, together
        sass_text = dict(zip(names, pool.map(disassemble, names)))
    for n in names:
        lib = build.library_path(n)
        log = lib.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        ptxas[n] = ptxas_kernels(text)
        warnings[n] = [ln.strip() for ln in text.splitlines() if "C75" in ln]
        text = sass_text[n]
        sass[n] = {op: sum(ln.count(op) for ln in text.splitlines()) for op in SASS_COUNTS}
        if n != "groupnorm":   # the fp32 instances of B1, B3 and B4, each on its own
            f32_sass.update(sass_by_function(text, "_tf32"))
    # the backward library's tilings against their Python mirrors, per head dim
    plans = {d: {k: (p.tile, p.stages, p.smem) for k, p in fa.bwd_plan(d).items()}
             for d in (40, 64, 80, 160)}
    lib_plans = {d: fa.library_bwd_plan(d) for d in plans}
    bwd_f32_plans = {d: {k: (p.rows, p.cols, p.tile, p.stages, p.smem)
                         for k, p in fa.bwd_f32_plan(d).items()} for d in F32_DIMS}
    lib_bwd_f32_plans = {d: fa.library_bwd_f32_plan(d) for d in F32_DIMS}
    # and B1's fp32 (3xTF32) tiling, per instance
    f32_plans = {d: (lambda p: (p.rows, p.tile, p.stages, p.smem))(fa.fwd_f32_plan(d))
                 for d in F32_DIMS}
    lib_f32_plans = {d: fa.library_fwd_f32_plan(d) for d in F32_DIMS}
    emit({"phase": "build", "nvcc_s": {n: round(t, 2) for n, t in t_nvcc.items()},
          "built_now": built_now, "sass_counts": sass, "f32_sass": f32_sass,
          "ptxas": ptxas, "ptxas_warnings": warnings,
          "bwd_plan": {d: {k: list(v) for k, v in p.items()} for d, p in lib_plans.items()},
          "bwd_f32_plan": {d: {k: list(v) for k, v in p.items()}
                           for d, p in lib_bwd_f32_plans.items()},
          "fwd_f32_plan": {d: list(p) for d, p in lib_f32_plans.items()},
          "phase_wall_s": time.perf_counter() - t_phase})
    missing = {n: op for n, ops in SASS_WANT.items() for op in ops if sass[n][op] == 0}
    missing.update({fn: op for fn, counts in f32_sass.items() for op, c in counts.items()
                    if c == 0})
    if missing or len(f32_sass) != 3 * len(F32_DIMS):
        raise AssertionError(f"the SASS lacks the instructions of its design: {missing} "
                             f"({len(f32_sass)} of {3 * len(F32_DIMS)} fp32 instances of "
                             f"B1, B3 and B4 found)")
    for n, sub, count in NO_SPILLS:
        checked = {k: v for k, v in ptxas[n].items() if sub in k}
        spills = {k: v for k, v in checked.items()
                  if v.get("spill_stores") or v.get("spill_loads")}
        if spills or len(checked) != count:
            raise AssertionError(f"{n}: {sub} instances ({len(checked)} of {count} reported) "
                                 f"spill: {spills}")
    warned = {n: warnings[n] for n in NO_C75 if warnings[n]}
    if warned:
        raise AssertionError(f"ptxas performance warnings: {warned}")
    if lib_plans != plans:
        raise AssertionError(f"the library's B3/B4 tiling {lib_plans} is not bwd_plan's {plans}")
    if lib_f32_plans != f32_plans:
        raise AssertionError(f"the library's fp32 B1 tiling {lib_f32_plans} is not "
                             f"fwd_f32_plan's {f32_plans}")
    if lib_bwd_f32_plans != bwd_f32_plans:
        raise AssertionError(f"the library's fp32 B3/B4 tiling {lib_bwd_f32_plans} is not "
                             f"bwd_f32_plan's {bwd_f32_plans}")
    return ptxas


# ---------------------------------------------------------------- phase 3

def check(entry: dict) -> None:
    """Every `*err*` number with a `*tol*` counterpart must be within it."""
    bad = [k for k in entry if "err" in k and k.replace("err", "tol") in entry
           and not entry[k] <= entry[k.replace("err", "tol")]]
    if bad:
        raise AssertionError(f"{entry['name']}: {bad} over tolerance: {entry}")


def flash_name(kind: str, shape, dtype: str, tk: int) -> str:
    """An entry's name: the kernel, q's shape and dtype, and the key count
    where it is not the query count (a cross-attention)."""
    keys = "" if tk == shape[1] else f" x {tk} keys"
    return f"{kind} {'x'.join(map(str, shape))}{keys} {dtype}"


def bench_flash(torch, shape, dtype, tk: int) -> dict:
    """B1 at q `shape` (B, Tq, H, D) over `tk` keys against its plain
    version, and timed."""
    import torch.nn.functional as F

    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa

    b, t, h, d = shape
    g = torch.Generator("cuda").manual_seed(SEED)
    q = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    k, v = (torch.randn((b, tk, h, d), generator=g, device="cuda", dtype=dtype)
            for _ in range(2))
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
    # summation order and the 3xTF32 products (each about 2^-22 relative),
    # 1e-4 of the max.
    def tol(s):
        return 4 * bf16_ulp(s) if bf16 else 1e-4 * s

    entry = {
        "name": flash_name("flash_attn_fwd", shape, str(dtype)[6:], tk),
        "key": ("flash", (tuple(shape), str(dtype)[6:], tk)),
        "shape": list(shape), "keys": tk, "dtype": str(dtype)[6:],
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
    nbytes = 2 * b * (t + tk) * h * d * itemsize + b * h * t * 4     # q, k, v, o; lse
    entry.update(flash_bound(4.0 * b * h * t * tk * d, nbytes, entry["dtype"]))
    # one exp2 per logit on the multi-function units: 16 per clock per SM
    entry["exp_bound_ms"] = b * h * t * tk / (SMS * 16 * max_sm_clock_hz()) * 1e3
    return entry


def bench_flash_bwd(torch, shape, dtype, tk: int):
    """Kernels B3 (dQ) and B4 (dK/dV) at q `shape` over `tk` keys -> two
    entries."""
    import torch.nn.functional as F

    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa

    b, t, h, d = shape
    g = torch.Generator("cuda").manual_seed(SEED + 7)
    q, do = (torch.randn(shape, generator=g, device="cuda", dtype=dtype) for _ in range(2))
    k, v = (torch.randn((b, tk, h, d), generator=g, device="cuda", dtype=dtype)
            for _ in range(2))
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
    row_bytes = b * h * d * q.element_size()    # one token of (B, T, H, D)
    rows_bytes = 2 * b * h * t * 4              # lse and delta
    entries = []
    for kind, names, products, written, run in (
            ("flash_bwd_dq", ("dq",), 3, t,
             lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)),
            ("flash_bwd_dkv", ("dk", "dv"), 4, 2 * tk,
             lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))):
        e = {"name": flash_name(f"flash_attn_bwd_{kind[10:]}", shape, str(dtype)[6:], tk),
             "key": (kind, (tuple(shape), str(dtype)[6:], tk)),
             "shape": list(shape), "keys": tk, "dtype": str(dtype)[6:],
             "bit_identical_relaunch": all(same[n] for n in names)}
        for n in names:
            e.update(errors(n))
        e["max_abs_err"] = max(e[f"{n}_max_abs_err"] for n in names)
        e["rel_l2_err_max"] = max(e[f"{n}_rel_l2_err"] for n in names)
        e["ms"] = cuda_ms(torch, run)
        e["device_ms"] = graph_ms(torch, run)
        e["plain_ms"] = plain_ms      # the plain backward computes dq, dk and dv together
        e["library_ms"] = library_ms  # so does SDPA's
        # products of 2·B·H·Tq·Tk·D each; q, k, v, dO, lse, delta read, grads written
        nbytes = (2 * t + 2 * tk + written) * row_bytes + rows_bytes
        e.update(flash_bound(2.0 * products * b * h * t * tk * d, nbytes, e["dtype"]))
        e["exp_bound_ms"] = b * h * t * tk / (SMS * 16 * max_sm_clock_hz()) * 1e3  # p recomputed
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


def sd15_attention_shapes(batch: int) -> list:
    """(q shape, key count) of every attention an SD-1.5 UNet forward at
    512² runs at `batch` rows: the self-attentions at 4096, 1024, 256 and 64
    tokens (head dims 40, 80, 160, 160) and the cross-attentions of the same
    queries to the 77 text tokens."""
    qs = [(batch, 4096, 8, 40), (batch, 1024, 8, 80), (batch, 256, 8, 160), (batch, 64, 8, 160)]
    return [(q, q[1]) for q in qs] + [(q, 77) for q in qs]


# (q shape, dtype, key count)
FLASH_SHAPES = [((2, 4096, 8, 40), "bfloat16", 4096), ((4, 4096, 8, 40), "bfloat16", 4096),
                ((8, 4096, 8, 40), "bfloat16", 4096),   # the test CLI's 4 batched seeds
                ((6, 4096, 8, 40), "bfloat16", 4096),   # the server's batch of 3
                ((2, 4096, 8, 80), "bfloat16", 4096), ((2, 4608, 8, 40), "bfloat16", 4608),
                ((1, 2048, 8, 160), "bfloat16", 2048), ((2, 4096, 8, 40), "float32", 4096),
                ((1, 4096, 8, 40), "float32", 4096),    # train_parity's batch
                ((4, 4096, 8, 40), "float32", 4096)]    # the training CLI's default step
# the SD-1.5 UNet's other attentions at the main path's and the server's CFG
# rows (2, 4, 6, 8; 4 also the training batch) in bf16, and at the fp32
# paths' 2 and 4 rows
FLASH_SHAPES += [(q, "bfloat16", tk) for b in (2, 4, 6, 8)
                 for q, tk in sd15_attention_shapes(b) if q[1] != 4096 or tk != 4096]
FLASH_SHAPES += [(q, "float32", tk) for b in (2, 4)
                 for q, tk in sd15_attention_shapes(b) if q[1] != 4096 or tk != 4096]
# SDXL at 1024²: the self-attentions at 4096 and 1024 tokens (head dim 64)
# and the cross-attentions of both to the 77 text tokens; FLUX.1 Fill's
# joint attention at 1024² (4096 image + 512 text tokens)
FLASH_SHAPES += [((2, 4096, 10, 64), "bfloat16", 4096), ((2, 4096, 10, 64), "float32", 4096),
                 ((2, 1024, 20, 64), "bfloat16", 1024), ((2, 4096, 10, 64), "bfloat16", 77),
                 ((2, 1024, 20, 64), "bfloat16", 77), ((1, 4608, 24, 128), "bfloat16", 4608)]
FLASH_BWD_SHAPES = [((4, 4096, 8, 40), "bfloat16", 4096), ((2, 4096, 8, 40), "bfloat16", 4096),
                    ((2, 4608, 8, 40), "bfloat16", 4608), ((1, 2048, 8, 160), "bfloat16", 2048),
                    ((4, 4096, 8, 40), "float32", 4096), ((2, 4096, 8, 40), "float32", 4096),
                    ((1, 4096, 8, 40), "float32", 4096)]
# the training step's other attentions (batch 4) in both dtypes
FLASH_BWD_SHAPES += [(q, dt, tk) for dt in ("bfloat16", "float32")
                     for q, tk in sd15_attention_shapes(TRAIN_BATCH)
                     if q[1] != 4096 or tk != 4096]
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


def kernel_entries(torch, kern: str, key: tuple) -> list:
    """The measured entries of one (kernel, shape key) as the wrappers count
    it, each checked against its plain version; B3's and B4's shapes give
    both backward entries."""
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

    shape, dt = key[0], getattr(torch, key[1])
    if kern == "flash":
        entries = [bench_flash(torch, shape, dt, key[2])]
        entries[0].update(kernel="flash", route="cuda", source=fa.SOURCE, replaces=fa.REPLACES)
    elif kern == "groupnorm":
        entries = [bench_groupnorm(torch, shape, dt, key[2])]
        entries[0].update(kernel="groupnorm", route="cuda", source=gn.SOURCE,
                          replaces=gn.REPLACES)
    else:
        entries = bench_flash_bwd(torch, shape, dt, key[2])
        for e, replaces in zip(entries, (fa.DQ_REPLACES, fa.DKV_REPLACES)):
            e.update(kernel=e["key"][0], route="cuda", source=fa.BWD_SOURCE, replaces=replaces)
    for e in entries:
        check(e)
    return entries


def phase_kernels(torch):
    t_phase = time.perf_counter()
    keys = [("flash", (shape, dt, tk)) for shape, dt, tk in FLASH_SHAPES]
    keys += [("flash_bwd", (shape, dt, tk)) for shape, dt, tk in FLASH_BWD_SHAPES]
    gn_cases = {(shape, dt, silu) for shape in GN_SHAPES for dt in ("bfloat16", "float32")
                for silu in (False, True)}
    step_norms, vae_norms = main_path_groupnorms(torch)
    # bf16 at every batch of 1 to 4 prompts (the step's and the VAE's batches
    # times k): the main path's 1, the server's batches at --max_batch 4, the
    # test CLI's 4 batched seeds, the training step's batch; fp32 at the main
    # path's batches and the step's at the training batch
    ks = range(1, max(CLI_SEEDS, SERVE_MAX_BATCH, TRAIN_BATCH) + 1)
    gn_cases |= {((shape[0] * k,) + shape[1:], "bfloat16", silu)
                 for shape, silu in step_norms + vae_norms for k in ks}
    gn_cases |= {(shape, "float32", silu) for shape, silu in step_norms + vae_norms}
    gn_cases |= {((shape[0] * k,) + shape[1:], "float32", silu)
                 for shape, silu in step_norms for k in range(1, TRAIN_BATCH + 1)}
    gn_cases.add(SDXL_FULL_DEPTH_NORM)
    keys += [("groupnorm", case) for case in sorted(gn_cases, key=str)]
    entries = [e for kern, key in keys for e in kernel_entries(torch, kern, key)]
    emit({"phase": "kernels", "checked": len(entries), "all_within_tolerance": True,
          "phase_wall_s": time.perf_counter() - t_phase})
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

    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(**PARITY_DEPTH).eval()
        brushnet = BrushNetModel(conditioning_channels=6, **PARITY_DEPTH).eval()
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
           "depth": PARITY_DEPTH, "launches": launched, "gpu_forward_s": round(t_gpu, 3),
           "cpu_forward_s": round(t_cpu, 3), "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    if not (res["finite"] and err <= tol):
        raise AssertionError(f"slice parity failed: {res}")
    if launched["flash"] != attentions_per_unet_forward(**PARITY_DEPTH) \
            or launched["groupnorm"] == 0:
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

    t_phase = time.perf_counter()
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
            if launched["flash"] != attentions_per_unet_forward() * steps \
                    or launched["groupnorm"] == 0:
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
              for (kern, key), n in sorted(by_shape[8].items(), key=str)],
          "phase_wall_s": time.perf_counter() - t_phase})
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
    t_phase = time.perf_counter()
    res = trace(torch, lambda: pipe(**kw, num_inference_steps=steps, output_type="np"))
    emit({"phase": "profile", "steps": steps, **res,
          "phase_wall_s": time.perf_counter() - t_phase})


# ---------------------------------------------------------------- phase 7/8

def tf32_default_report(loss_rel_err: float, loss_rel_tol: float, errs: dict) -> dict:
    """C4's record of a card run with TF32 at PyTorch's default: each error
    beside the TF32-off check's tolerance."""
    return {"settings": {"matmul": TF32_DEFAULT[0], "cudnn": TF32_DEFAULT[1]},
            "loss_rel_err": loss_rel_err, "loss_rel_tol": loss_rel_tol,
            "grads": {n: {"max_abs_err": e, "max_abs_tol": t} for n, (e, t) in errs.items()},
            "meets_tolerance": loss_rel_err <= loss_rel_tol
            and all(e <= t for e, t in errs.values())}


def phase_train_parity(torch):
    """One fp32 loss + backward of full-width UNet + BrushNet on the card
    (kernels through their autograd Functions) against the CPU."""
    from reflecting_reality_tpu_torch.core.device import fp32_convolutions
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.schedulers.common import NoiseSchedule, add_noise
    from reflecting_reality_tpu_torch.training.train_step import (
        TrainConfig, denoise, diffusion_loss,
    )

    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(**PARITY_DEPTH).requires_grad_(False)
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
    launched, by_shape = read_counters(), read_counters_by_shape()
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
           "depth": PARITY_DEPTH, "launches": launched,
           "card_loss_backward_s": round(t_card, 3), "cpu_loss_backward_s": round(t_cpu, 3),
           "grads": {}}
    for n in names:
        scale = cpu[n].abs().max().item()
        res["grads"][n] = {"max_abs_err": (card[n] - cpu[n]).abs().max().item(),
                           "max_abs_tol": 1e-3 * scale, "max_abs": scale,
                           "finite": bool(torch.isfinite(card[n]).all())}
    # C4: the same card step with TF32 at PyTorch's default, against the
    # same CPU result and tolerances: bare (cuDNN convolutions in one TF32
    # pass, what an fp32 step ran before C4's repair) and under the scope
    # the training step runs its fp32 forward and backward in
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = TF32_DEFAULT
    for key, scope in (("tf32_default", contextlib.nullcontext),
                       ("tf32_default_fp32_convolutions", fp32_convolutions)):
        brushnet.zero_grad(set_to_none=True)
        with scope():
            d_loss, d_grads = loss_and_grads(unet, brushnet, "cuda")
        res[key] = tf32_default_report(
            abs(d_loss - cpu_loss) / abs(cpu_loss), res["loss_rel_tol"],
            {n: ((d_grads[n] - cpu[n]).abs().max().item(), res["grads"][n]["max_abs_tol"])
             for n in names})
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    if not res["tf32_default_fp32_convolutions"]["meets_tolerance"]:
        raise AssertionError(f"train parity with TF32 at its default failed: {res}")
    bad = [n for n, r in res["grads"].items()
           if not (r["finite"] and r["max_abs"] > 0 and r["max_abs_err"] <= r["max_abs_tol"])]
    if bad or not res["loss_rel_err"] <= res["loss_rel_tol"]:
        raise AssertionError(f"train parity failed ({bad}): {res}")
    b1 = attentions_per_unet_forward(**PARITY_DEPTH)     # BrushNet's residuals reach each
    if (launched["flash"], launched["flash_bwd_dq"], launched["flash_bwd_dkv"]) != (b1, b1, b1) \
            or launched["groupnorm"] == 0:
        raise AssertionError(f"train parity did not run through the kernels: {launched} "
                             f"(want {b1} each)")
    del unet, brushnet, unet_c, bn_c
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return by_shape


def phase_train_main(torch, gpu_line: str) -> dict:
    """The training step at full width, bf16, 512² batch 4 -> {(kernel, key):
    launches} over the timed steps."""
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.training import TrainConfig, make_train_step

    t_phase = time.perf_counter()
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

    n, px = TRAIN_BATCH, 512
    batch = train_batch(torch, n, px)
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
          "trace": traced, "phase_wall_s": time.perf_counter() - t_phase})
    if not all(v > 0 for v in moved.values()) or not all(frozen_same.values()):
        raise AssertionError(f"train step moved {moved}, frozen unchanged {frozen_same}")
    n = attentions_per_unet_forward()
    want = {"flash": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    if any(per_step[k] != v for k, v in want.items()) or per_step["groupnorm"] == 0:
        raise AssertionError(f"train step launches per step {per_step}, want {want}")
    # under either policy the flash forward (an opaque autograd Function) is
    # recomputed with the rest of the forward: 2n/n/n
    for policy, got in (("full", ckpt["launches"]), ("dots", dots["launches"])):
        if (got["flash"], got["flash_bwd_dq"], got["flash_bwd_dkv"]) != (2 * n, n, n):
            raise AssertionError(f"checkpointed ({policy}) step launches {got}, "
                                 f"want {2 * n}/{n}/{n}")
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


def write_latent_cache(data: str, cache: str, n: int, ip_normals: bool = False) -> None:
    """`n` samples at CLI_PX² in the precompute tool's .npz layout, fp16
    moments, and a train.csv written with `csv`; with `ip_normals` each
    sample also holds its (1, 3) unit mean mirror normal (ip_adapter mode)."""
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
        extra = {}
        if ip_normals:
            v = rng.standard_normal((1, 3))
            extra["normals"] = (v / np.linalg.norm(v)).astype(np.float32)
        np.savez(os.path.join(cache, cache_name(row, i)), latent_moments=moments(),
                 cond_latent_moments=moments(), masks=mask,
                 depths=rng.uniform(-1.0, 1.0, (hl, hl, 1)).astype(np.float32), **extra)


def read_metrics(out: str) -> list:
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_cli_argv(tmp: str, out: str, *extra) -> list:
    """The training CLI's arguments on train_cli's base folder and latent
    cache in `tmp` (bf16, batch TRAIN_BATCH, depth concat)."""
    return ["--pretrained_model_name_or_path", os.path.join(tmp, "base"),
            "--train_data_dir", os.path.join(tmp, "data"),
            "--output_dir", out, "--logging_dir", os.path.join(out, "logs"),
            "--mixed_precision", "bf16", "--train_batch_size", str(TRAIN_BATCH),
            "--depth_conditioning_mode", "concat", "--learning_rate", "5e-6",
            "--lr_warmup_steps", "0", "--precomputed_latents_dir", os.path.join(tmp, "cache"),
            "--dataloader_num_workers", "4", "--log_every", "1",
            "--validation_steps", "0", "--report_to", "none", "--seed", "0", *extra]


# the train_cli phase's runs in the CLI's other modes, 4 steps each
TRAIN_CLI_MODES = (("device_cache", ("--device_cache",)),
                   ("steps_per_dispatch_2", ("--steps_per_dispatch", "2", "--async_save",
                                             "--checkpointing_steps", "2",
                                             "--checkpoints_total_limit", "1")))


def train_cli_modes(tmp: str, out_json: str) -> None:
    """`--train-cli-modes TMP OUT_JSON` (a process of the train_cli phase):
    the TRAIN_CLI_MODES runs one after the other -> OUT_JSON {mode: wall
    seconds, launches, steps, metrics}."""
    import torch

    from reflecting_reality_tpu_torch.cli import train as cli

    runs = {}
    for name, extra in TRAIN_CLI_MODES:
        out = os.path.join(tmp, name)
        reset_counters()
        t0 = time.perf_counter()
        cli.main(train_cli_argv(tmp, out, "--max_train_steps", "4", *extra))
        torch.cuda.synchronize()
        runs[name] = {"wall_s": time.perf_counter() - t0, "launches": read_counters(),
                      "steps": 4, "metrics": read_metrics(out)}
        shutil.rmtree(out)
        torch.cuda.empty_cache()
    with open(out_json, "w") as f:
        json.dump(runs, f)


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

    argv = functools.partial(train_cli_argv, tmp)

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

        # the other modes' runs in a process of their own, beside the resume
        # and the checks below: they share the card, so their s/step are
        # not speed figures
        modes_json, modes_log = (os.path.join(tmp, f"train_cli_modes.{x}") for x in ("json",
                                                                                     "log"))
        with open(modes_log, "w") as log:
            modes = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                      "--train-cli-modes", tmp, modes_json],
                                     stdout=log, stderr=subprocess.STDOUT)

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
    if modes.wait(timeout=900) != 0:
        with open(modes_log) as log:
            raise RuntimeError(f"the train_cli modes' process failed:\n{log.read()[-3000:]}")
    with open(modes_json) as f:
        runs.update(json.load(f))

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
    n = attentions_per_unet_forward()
    want = {"flash": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
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


CLI_FP32_STEPS = 6                  # steps of the train_cli_fp32 phase
FP32_TRAIN_KEY = ((TRAIN_BATCH, 4096, 8, 40), "float32", 4096)   # its level-0 self-attentions


def phase_train_cli_fp32(torch, gpu_line: str, tmp: str) -> dict:
    """The training CLI at its default `--mixed_precision no` on train_cli's
    base folder and latent cache in `tmp` -> {(kernel, key): launches} over
    its CLI_FP32_STEPS steps.  No checkpoint within the run (the CLI writes
    its final one, deleted here) and no validation."""
    from unittest import mock

    from reflecting_reality_tpu_torch.cli import train as cli

    t_phase = time.perf_counter()
    out = os.path.join(tmp, "fp32_run")
    argv = ["--pretrained_model_name_or_path", os.path.join(tmp, "base"),
            "--train_data_dir", os.path.join(tmp, "data"), "--output_dir", out,
            "--logging_dir", os.path.join(out, "logs"), "--train_batch_size", str(TRAIN_BATCH),
            "--depth_conditioning_mode", "concat", "--learning_rate", "5e-6",
            "--lr_warmup_steps", "0", "--precomputed_latents_dir", os.path.join(tmp, "cache"),
            "--dataloader_num_workers", "4", "--log_every", "1", "--validation_steps", "0",
            "--report_to", "none", "--seed", "0", "--max_train_steps", str(CLI_FP32_STEPS),
            "--checkpointing_steps", str(10 * CLI_FP32_STEPS)]
    seen = {}
    real_load_models = cli.load_models

    def load_models(args):
        models = real_load_models(args)
        seen["brushnet0"] = {k: v.detach().cpu().clone()
                             for k, v in models[1].state_dict().items()}
        seen["dtype"] = str(next(models[1].parameters()).dtype)
        return models

    with mock.patch.object(cli, "load_models", load_models):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        state = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched, by_shape = read_counters(), read_counters_by_shape()
    peak = torch.cuda.max_memory_allocated()
    moved = max((v.detach().cpu() - seen["brushnet0"][k]).abs().max().item()
                for k, v in state.trainable["brushnet"].state_dict().items())
    del state
    torch.cuda.empty_cache()
    rows = [r for r in read_metrics(out) if "loss" in r]
    shutil.rmtree(out)
    losses = [r["loss"] for r in rows]
    timed = [r["s_per_step"] for r in rows if r["step"] >= 2]
    per_step = {k: by_shape.get((k, FP32_TRAIN_KEY), 0) / CLI_FP32_STEPS
                for k in ("flash", "flash_bwd_dq", "flash_bwd_dkv")}
    res = {"phase": "train_cli_fp32", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}",
           "batch": TRAIN_BATCH, "mixed_precision": "no (the default)",
           "brushnet_dtype": seen["dtype"], "steps": CLI_FP32_STEPS,
           "cli_s_per_step_median_steps_2_on": statistics.median(timed),
           "cli_s_per_step_each": [round(r["s_per_step"], 4) for r in rows],
           "cli_samples_per_s_median": TRAIN_BATCH / statistics.median(timed),
           "max_memory_allocated_bytes": peak, "run_wall_s": wall, "losses": losses,
           "brushnet_max_abs_change": moved, "launches": launched,
           f"launches_per_step_at_{'x'.join(map(str, FP32_TRAIN_KEY[0]))}_fp32": per_step,
           "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    bad = []
    if len(losses) != CLI_FP32_STEPS or not all(math.isfinite(x) for x in losses):
        bad.append(f"losses {losses}")
    if not moved > 0:
        bad.append("BrushNet did not move")
    if any(n != 5 for n in per_step.values()) or launched["groupnorm"] == 0:
        bad.append(f"launches per step at {FP32_TRAIN_KEY}: {per_step} (want 5 each)")
    if bad:
        raise AssertionError(f"train_cli_fp32 failed: {bad}")
    return by_shape, res["cli_s_per_step_median_steps_2_on"]


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
    # B1's device time an fp32 step: each shape's launches a step by its
    # device ms (phase 3 measured every shape of the fp32 step's CFG batch 2)
    device_ms = {e["key"]: e["device_ms"] for e in entries}
    b1_fp32_ms = sum((n - by_shape["b_fp32_2_steps"].get(k, 0)) / (2 * rows * CLI_SEEDS)
                     * device_ms[k] for k, n in by_shape["b_fp32_4_steps"].items()
                     if k[0] == "flash")
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
        "b1_fp32_launches": {"b_fp32_4_steps": b4["launches"]["flash"],
                             "per_step": b_per_step["flash"]},
        "b1_fp32_device_ms_per_step": b1_fp32_ms,
        "b1_fp32_share_of_fp32_step": b1_fp32_ms / 1e3 / b_s_step,
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
        if got["flash"] != attentions_per_unet_forward() \
                or got["groupnorm"] != main_per_step["groupnorm"]:
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

    from reflecting_reality_tpu_torch.core.device import fp32_convolutions
    from reflecting_reality_tpu_torch.data.synmirror import get_masked_image
    from reflecting_reality_tpu_torch.metrics import evaluate
    from reflecting_reality_tpu_torch.metrics.calculator import MetricsCalculator
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
    with torch.inference_mode(), fp32_convolutions():
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


def phase_modes(torch, gpu_line: str) -> dict:
    """The pipeline's other conditioning modes at full width, 512²: bf16
    depth `latents` + normals `concat` (BrushNet with 12 conditioning
    channels), 4 steps; then fp32 depth `concat` + normals `latents`, one
    denoise step (PARITY_DEPTH), the card against the CPU -> {path:
    {(kernel, key): launches}}."""
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    t_phase = time.perf_counter()
    kw = modes_inputs()
    mods = full_width_modules(torch, "latents", "concat")
    channels = mods["brushnet"].conditioning_channels
    pipe = StableDiffusionBrushNetPipeline(**mods, dtype=torch.bfloat16, device="cuda")
    reset_counters()
    t0 = time.perf_counter()
    out = pipe(**kw, num_inference_steps=4, output_type="np")
    torch.cuda.synchronize()
    bf16 = {"depth": "latents", "normals": "concat", "conditioning_channels": channels,
            "s_4_steps": time.perf_counter() - t0, "launches": read_counters(),
            "by_shape": read_counters_by_shape(),
            "shape": list(out.shape), "dtype": str(out.dtype), "std": float(out.std())}
    del pipe, mods
    torch.cuda.empty_cache()

    cls, mods, kw = parity_case(torch, "modes")
    p = {"depth": "concat", "normals": "latents", "unet_depth": PARITY_DEPTH,
         "conditioning_channels": mods["brushnet"].conditioning_channels,
         **card_vs_cpu_one_step(torch, mods, kw, cls, reference="modes")}
    by_shape = bf16.pop("by_shape")
    res = {"phase": "modes", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}", "bf16": bf16,
           "fp32_parity": p, "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    del mods
    torch.cuda.empty_cache()
    bad = []
    if bf16["shape"] != [1, CLI_PX, CLI_PX, 3] or bf16["dtype"] != "uint8" or \
            not bf16["std"] > 0 or channels != 12:
        bad.append(f"bf16 image {bf16}")
    if bf16["launches"]["flash"] != 4 * attentions_per_unet_forward() \
            or bf16["launches"]["groupnorm"] == 0:
        bad.append(f"bf16 launches {bf16['launches']}")
    b1 = attentions_per_unet_forward(**PARITY_DEPTH)
    if not (p["finite"] and p["max_abs_err"] <= p["max_abs_tol"]) \
            or p["launches"]["flash"] != b1 or p["launches"]["groupnorm"] == 0:
        bad.append(f"fp32 parity {p} (B1: want {b1})")
    if bad:
        raise AssertionError(f"modes failed: {bad}")
    return {"modes_bf16_4_steps": by_shape}


# ------------------------------------------------- phases 14-16 (PR 9 paths)

IP_REPEATS = 2                      # timed 4- and 8-step calls of each count
APPROX_REPEATS = 3                  # timed 4- and 8-step calls of each approximate mode
IP_TRAIN_STEPS = 4                  # the ip training CLI's first run (checkpoint at its end)
SERVE_REQUESTS = 8                  # concurrent requests of the serve phase
SERVE_MAX_BATCH = 4
SERVE_STEPS = 8


def full_width_modules(torch, depth_mode: str = "concat", normals_mode=None,
                       depth: dict = None) -> dict:
    """Seeded full-width SD-1.5 modules for the pipeline in these
    conditioning modes (BrushNet's zero convs given small values); normals
    `ip_adapter` gives an IP-Adapter UNet (to_k_ip/to_v_ip copied from
    to_k/to_v) and a NormalProjModel; `depth` (PARITY_DEPTH) cuts the
    UNet's, BrushNet's and VAE's depth."""
    from reflecting_reality_tpu_torch.cli.train import conditioning_channels_for
    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
    from reflecting_reality_tpu_torch.models import ip_adapter
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    ip = normals_mode == "ip_adapter"
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        depth = depth or {}
        unet = UNet2DConditionModel(ip_num_tokens=ip_adapter.DEFAULT_NUM_TOKENS if ip else None,
                                    **depth)
        mods = dict(unet=unet, vae=AutoencoderKL(**depth), text_encoder=CLIPTextModel(),
                    brushnet=BrushNetModel(conditioning_channels=conditioning_channels_for(
                        depth_mode, normals_mode), **depth))
        if ip:
            ip_adapter.init_ip_params_from_unet(unet)
            mods["normal_proj"] = ip_adapter.NormalProjModel(768)
    fill_zero_convs(torch, mods["brushnet"], SEED, 0.02)
    return dict(mods, tokenizer=HashTokenizer(vocab_size=49408),
                depth_conditioning_mode=depth_mode, normals_conditioning_mode=normals_mode)


def pipeline_inputs(seed: int, normal=None) -> dict:
    import numpy as np

    rng = np.random.RandomState(seed)
    mask = np.zeros((CLI_PX, CLI_PX, 3), np.float32)
    mask[128:384, 160:352] = 1.0
    kw = dict(prompt="a photo of a mirror on the wall",
              image=rng.rand(CLI_PX, CLI_PX, 3).astype(np.float32), mask=mask,
              depth=rng.rand(CLI_PX, CLI_PX, 1).astype(np.float32), guidance_scale=7.5,
              scheduler="unipc", seed=SEED)
    if normal is not None:
        kw["normals"] = np.asarray(normal, np.float32).reshape(1, 3)
    return kw


IP_NORMAL = [0.0, 0.6, 0.8]          # the ip_adapter phase's normal


def modes_inputs() -> dict:
    """The modes phase's inputs: normals drawn from their own seed."""
    import numpy as np

    kw = pipeline_inputs(SEED + 5)
    kw["normals"] = np.random.RandomState(SEED + 6).rand(CLI_PX, CLI_PX, 3).astype(np.float32)
    return kw


UNPRINTED = ("by_shape_8", "by_shape_4", "image_8")   # timed_calls' keys no JSON line holds


def timed_calls(torch, pipe, kw, repeats: int) -> dict:
    """A 2-step warm call, then 4- and 8-step calls in turns, `repeats` of
    each -> s/step (two-point difference of the medians), s/image (the 8-step
    median), peak memory, the 4- and 8-step calls' launches (total and by
    shape) and the 8-step call's uint8 image."""
    return timed_variants(torch, pipe, kw, repeats, {"": lambda: None})[""]


def timed_variants(torch, pipe, kw, repeats: int, variants: dict) -> dict:
    """`timed_calls` for each of `variants` ({name: a function that switches
    the pipeline to it}), the variants taking turns within each repeat, so
    that the host's drift falls on all of them -> {name: timed_calls' dict}."""
    import numpy as np

    for switch in variants.values():
        switch()
        pipe(**kw, num_inference_steps=2, output_type="latent")
    each = {name: {4: [], 8: []} for name in variants}
    out = {name: {} for name in variants}
    for _ in range(repeats):
        for name, switch in variants.items():
            switch()
            for steps in (4, 8):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counters()
                t0 = time.perf_counter()
                img = pipe(**kw, num_inference_steps=steps, output_type="np")
                torch.cuda.synchronize()
                each[name][steps].append(time.perf_counter() - t0)
                out[name][steps] = dict(launches=read_counters(),
                                        by_shape=read_counters_by_shape(),
                                        peak=torch.cuda.max_memory_allocated(), image=img)
    res = {}
    for name in variants:
        med = {k: statistics.median(v) for k, v in each[name].items()}
        o = out[name]
        img = o[8]["image"]
        if img.shape != (1, *kw["image"].shape[:2], 3) or img.dtype != np.uint8 \
                or not img.std() > 0:
            raise AssertionError(f"{name} 8-step image {img.shape} {img.dtype} std {img.std()}")
        res[name] = {"s_each": {str(k): v for k, v in each[name].items()},
                     "s_per_step": (med[8] - med[4]) / 4, "s_per_image_8_steps": med[8],
                     "max_memory_allocated_bytes": o[8]["peak"],
                     "launches_8_steps": o[8]["launches"], "launches_4_steps": o[4]["launches"],
                     "by_shape_8": o[8]["by_shape"], "by_shape_4": o[4]["by_shape"],
                     "image_8": img}
    return res


def fp32_step_inputs(kw: dict) -> dict:
    """A pipeline's inputs `kw` as the fp32 card-vs-CPU steps take them:
    one denoise step, deterministic encode, latents from a seed."""
    import numpy as np

    h, w = kw["image"].shape[:2]
    return dict(kw, num_inference_steps=1, output_type="latent", deterministic_vae_encode=True,
                latents=np.random.RandomState(SEED + 6).standard_normal(
                    (1, h // 8, w // 8, 4)).astype(np.float32))


def fingerprint(torch, mods: dict) -> float:
    """The fp64 sum of every parameter of the modules in `mods`, on the
    device they are on: a phase and the reference process hold the same
    weights when theirs agree."""
    with torch.no_grad():
        return sum(float(sum(p.double().sum() for p in mods[k].parameters()))
                   for k in sorted(mods) if isinstance(mods[k], torch.nn.Module))


def card_vs_cpu_one_step(torch, mods, kw, pipeline_cls=None, keep: bool = False,
                         exact: bool = True, by_shape: dict = None, reference: str = None):
    """One fp32 denoise step (TF32 off, deterministic encode, given latents)
    of a pipeline on `mods` (`pipeline_cls`, by default the BrushNet
    pipeline), the card against the CPU's plain paths -> the comparison
    (and, with `keep`, the card's and the CPU's images after it).  `exact`
    holds the C4 run to the tolerance (int8 is held to its own error by
    its phase); `by_shape`, when given, receives the card call's launches
    by shape.  `reference` names the step in CPU_REFERENCES: in a full run
    the reference process has computed its CPU side from the same seeded
    modules and inputs (their fingerprints must agree); otherwise the CPU
    side runs here."""
    import numpy as np

    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    pipeline_cls = pipeline_cls or StableDiffusionBrushNetPipeline
    fp32 = fp32_step_inputs(kw)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    elsewhere = reference is not None and REFERENCES is not None
    if elsewhere:
        weights = fingerprint(torch, mods)
    else:
        cpu_mods = {k: copy.deepcopy(v).cpu() if isinstance(v, torch.nn.Module) else v
                    for k, v in mods.items()}
    try:
        reset_counters()
        t0 = time.perf_counter()
        card_pipe = pipeline_cls(**mods, device="cuda")
        card = card_pipe(**fp32)
        t_card = time.perf_counter() - t0
        launched = read_counters()
        if by_shape is not None:
            by_shape.update(read_counters_by_shape())
        if not elsewhere:
            t0 = time.perf_counter()
            cpu = pipeline_cls(**cpu_mods, device="cpu")(**fp32)
            t_cpu = time.perf_counter() - t0
        # C4: the card step again with TF32 at PyTorch's default, bare
        # (`generate`: cuDNN convolutions in one TF32 pass, what an fp32
        # call ran before C4's repair) and as a call runs it (full-fp32
        # convolutions at fp32)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = TF32_DEFAULT
        card_bare = card_pipe.generate(**fp32)
        card_default = card_pipe(**fp32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if elsewhere:
        ref = REFERENCES.get(reference)
        if not math.isclose(ref["fingerprint"], weights, rel_tol=1e-12):
            raise AssertionError(f"{reference}: the reference process's weights differ "
                                 f"({ref['fingerprint']} against {weights})")
        cpu, t_cpu = ref["cpu"], ref["cpu_s"]
    scale = float(np.abs(cpu).max())
    err = float(np.abs(card - cpu).max())
    res = {"steps": 1, "max_abs_err": err, "max_abs_tol": 1e-3 * scale, "output_max_abs": scale,
           "finite": bool(np.isfinite(card).all()), "launches": launched, "card_s": t_card,
           "cpu_s": t_cpu, "cpu_side": "reference process" if elsewhere else "here",
           "tf32_default": tf32_default_report(
               0.0, 0.0, {"output": (float(np.abs(card_bare - cpu).max()), 1e-3 * scale)}),
           "tf32_default_fp32_convolutions": tf32_default_report(
               0.0, 0.0, {"output": (float(np.abs(card_default - cpu).max()), 1e-3 * scale)})}
    if exact and not res["tf32_default_fp32_convolutions"]["meets_tolerance"]:
        raise AssertionError(f"a card call with TF32 at its default misses the CPU: {res}")
    return (res, card, cpu) if keep else res


def int8_pipeline_class():
    """The BrushNet pipeline that quantizes its modules in place as it is
    made (`enable_int8()`)."""
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    class Int8Pipeline(StableDiffusionBrushNetPipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.enable_int8()

    return Int8Pipeline


def parity_case(torch, name: str, tok_dir: str = None) -> tuple:
    """(pipeline class, seeded modules made on the card at the cut depth,
    inputs) of the fp32 card-vs-CPU step of phase `name` (ip_adapter,
    modes, int8 or sdxl; sdxl's tokenizer in `tok_dir`), as the phase and
    the reference process both make them."""
    from reflecting_reality_tpu_torch.pipelines import StableDiffusionXLBrushNetPipeline
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    if name == "sdxl":
        return (StableDiffusionXLBrushNetPipeline,
                sdxl_modules(torch, tok_dir, SDXL_PARITY_DEPTH, SDXL_PARITY_TEXT_LAYERS,
                             PARITY_DEPTH), sdxl_inputs(SEED))
    modes, kw = {"ip_adapter": (("concat", "ip_adapter"), pipeline_inputs(SEED + 7, IP_NORMAL)),
                 "modes": (("concat", "latents"), modes_inputs()),
                 "int8": (("concat", None), pipeline_inputs(SEED))}[name]
    return StableDiffusionBrushNetPipeline, full_width_modules(torch, *modes, PARITY_DEPTH), kw


# the CPU sides that the reference process computes, in the order the phases
# read them: each phase's fp32 step but slice's and train_parity's, which
# come before it has any, and int8's two (exact, then quantized)
CPU_REFERENCES = ("ip_adapter", "baseline", "modes", "int8_exact", "int8", "sdxl")
REFERENCES = None                   # the full run's `CpuReferences`; None: CPU sides run in place


def references_paused():
    """A stretch whose speed PERF.md quotes: the reference process, if
    there is one, stops through it."""
    return REFERENCES.paused() if REFERENCES is not None else contextlib.nullcontext()


class CpuReferences:
    """The reference process (`--cpu-references DIR`): the CPU sides of the
    fp32 card-vs-CPU steps in CPU_REFERENCES, computed from the same seeded
    modules and inputs as their phases make, one file each in DIR as it
    finishes.  It runs beside this process at the lowest priority and off
    two of its cores, and is stopped where this process times what PERF.md
    quotes (`paused`, `references_paused`).  A phase that reads a file not
    written yet lets it run until it is; `cpu_s` in a step's line is the
    process's wall seconds for that side, stops included."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_refs_")
        self.log = open(os.path.join(self.dir, "log.txt"), "w")
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                      "--cpu-references", self.dir],
                                     stdout=self.log, stderr=subprocess.STDOUT)
        self.stopped = False

    def tail(self) -> str:
        self.log.flush()
        with open(self.log.name) as f:
            return f.read()[-3000:]

    def send(self, sig) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(sig)

    @contextlib.contextmanager
    def paused(self):
        self.stopped = True
        self.send(signal.SIGSTOP)
        try:
            yield
        finally:
            self.stopped = False
            self.send(signal.SIGCONT)

    def get(self, name: str):
        """What the process wrote as `name`, once it has."""
        import torch

        path = os.path.join(self.dir, name + ".pt")
        if not os.path.exists(path):
            self.send(signal.SIGCONT)
            while not os.path.exists(path):
                if self.proc.poll() is not None:
                    raise RuntimeError(f"the reference process ended ({self.proc.returncode}) "
                                       f"before {name}:\n{self.tail()}")
                time.sleep(0.2)
            if self.stopped:
                self.send(signal.SIGSTOP)
        return torch.load(path, weights_only=False)

    def close(self, join: bool) -> None:
        """With `join`, wait for the process to end (it has written every
        file by then) and raise if it failed; otherwise kill it.  Either way
        remove its directory."""
        self.send(signal.SIGCONT)
        try:
            if join and self.proc.wait(timeout=300) != 0:
                raise RuntimeError(f"the reference process failed ({self.proc.returncode}):\n"
                                   f"{self.tail()}")
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.log.close()
            shutil.rmtree(self.dir, ignore_errors=True)


def cpu_references(out_dir: str) -> None:
    """`--cpu-references`: the reference process.  It makes every case's
    modules on the card as its phase does, keeps their fingerprints and
    moves them to the CPU (written as "modules_on_cpu", which the run waits
    for before it times anything), then computes each CPU side in the order
    of CPU_REFERENCES into OUT_DIR/<name>.pt, with a thread for each core
    it may use (main sets its priority and cores)."""
    import torch

    from reflecting_reality_tpu_torch.tools.make_synthetic_fullscale import (
        write_byte_tokenizer,
    )

    torch.set_num_threads(len(os.sched_getaffinity(0)))

    def write(name, obj):
        torch.save(obj, os.path.join(out_dir, name + ".tmp"))
        os.replace(os.path.join(out_dir, name + ".tmp"), os.path.join(out_dir, name + ".pt"))

    cases = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sdxl_") as tok_dir:
        write_byte_tokenizer(tok_dir)
        for name in ("ip_adapter", "modes", "int8", "sdxl"):
            cls, mods, kw = parity_case(torch, name, tok_dir)
            weights = fingerprint(torch, mods)
            cpu_mods = {k: v.cpu() if isinstance(v, torch.nn.Module) else v
                        for k, v in mods.items()}
            cases[name] = (cls, cpu_mods, fp32_step_inputs(kw), weights)
            del mods
        torch.cuda.empty_cache()
        write("modules_on_cpu", {})
        for name in CPU_REFERENCES:
            if name == "baseline":
                write(name, baseline_parity_step(torch, "cpu"))
                continue
            t0 = time.perf_counter()
            cls, mods, fp32, weights = cases[name.removesuffix("_exact")]
            if name == "int8":
                cls = int8_pipeline_class()      # quantizes the exact step's modules in place
            cpu = cls(**mods, device="cpu")(**fp32)
            write(name, {"cpu": cpu, "fingerprint": weights,
                         "cpu_s": time.perf_counter() - t0})
            if name != "int8_exact":
                del cases[name]


def phase_ip_adapter(torch, gpu_line: str, tmp: str) -> dict:
    """The normals ip_adapter mode at full width, 512²: the pipeline (depth
    concat + the mean normal's token) in bf16 at 4 and 8 steps and one fp32
    step card vs CPU; then the training CLI in ip mode at its default fp32
    (batch 4, a latent cache with normals, a checkpoint at step
    IP_TRAIN_STEPS, a resume to +2) -> {path: {(kernel, key): launches}}."""
    from reflecting_reality_tpu_torch.cli import train as cli
    from reflecting_reality_tpu_torch.core.io import WEIGHTS_NAME, load_safetensors
    from reflecting_reality_tpu_torch.models.ip_adapter import NORMAL_PROJ_FILE, is_ip_param_name
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    t_phase = time.perf_counter()
    kw = pipeline_inputs(SEED + 7, IP_NORMAL)
    mods = full_width_modules(torch, "concat", "ip_adapter")
    pipe = StableDiffusionBrushNetPipeline(**mods, dtype=torch.bfloat16, device="cuda")
    bf16 = timed_calls(torch, pipe, kw, IP_REPEATS)
    other = pipe(**dict(kw, normals=[[0.0, -0.6, 0.8]]), num_inference_steps=4,
                 output_type="np")
    token_moves = int(abs(other.astype(int) - pipe(**kw, num_inference_steps=4,
                                                    output_type="np").astype(int)).max())
    del pipe, mods
    torch.cuda.empty_cache()
    cls, mods, kw32 = parity_case(torch, "ip_adapter")
    parity = dict(card_vs_cpu_one_step(torch, mods, kw32, cls, reference="ip_adapter"),
                  depth=PARITY_DEPTH)
    del mods
    torch.cuda.empty_cache()

    data, cache = os.path.join(tmp, "data_ip"), os.path.join(tmp, "cache_ip")
    os.makedirs(data)
    write_latent_cache(data, cache, CLI_SAMPLES, ip_normals=True)
    base, out = os.path.join(tmp, "base"), os.path.join(tmp, "ip_run")

    def argv(*extra):
        return ["--pretrained_model_name_or_path", base, "--train_data_dir", data,
                "--output_dir", out, "--logging_dir", os.path.join(out, "logs"),
                "--train_batch_size", str(TRAIN_BATCH), "--depth_conditioning_mode", "concat",
                "--normals_conditioning_mode", "ip_adapter", "--learning_rate", "5e-6",
                "--lr_warmup_steps", "0", "--precomputed_latents_dir", cache,
                "--dataloader_num_workers", "4", "--log_every", "1", "--validation_steps", "0",
                "--report_to", "none", "--seed", "0",
                "--checkpointing_steps", str(IP_TRAIN_STEPS), *extra]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    state = cli.main(argv("--max_train_steps", str(IP_TRAIN_STEPS)))
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches, train_by_shape = read_counters(), read_counters_by_shape()
    peak = torch.cuda.max_memory_allocated()
    ref = load_safetensors(os.path.join(base, "unet", WEIGHTS_NAME))
    frozen_same, ip_moved, n_ip = True, True, 0
    for name, p in state.trainable["unet"].named_parameters():
        if is_ip_param_name(name):
            n_ip += 1
            twin = ref[name.replace("_ip.", ".")].to(p.device, p.dtype)
            ip_moved &= not torch.equal(p.detach(), twin)
        else:
            frozen_same &= torch.equal(p.detach(), ref[name].to(p.device, p.dtype))
    trainable = sorted(state.trainable)
    opt_params = len(state.params)
    del state
    torch.cuda.empty_cache()
    ckpt = os.path.join(out, f"checkpoint-{IP_TRAIN_STEPS}")
    ckpt_files = sorted(os.listdir(ckpt))
    has_proj = os.path.isfile(os.path.join(ckpt, NORMAL_PROJ_FILE))
    ckpt_gb = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(ckpt) for f in fs) / 1e9

    reset_counters()
    t0 = time.perf_counter()
    state = cli.main(argv("--max_train_steps", str(IP_TRAIN_STEPS + 2),
                          "--resume_from_checkpoint", "latest"))
    torch.cuda.synchronize()
    resume_wall, resumed_step = time.perf_counter() - t0, state.step
    del state
    torch.cuda.empty_cache()
    rows = [r for r in read_metrics(out) if "loss" in r]
    shutil.rmtree(out)
    timed = [r["s_per_step"] for r in rows if 2 <= r["step"] <= IP_TRAIN_STEPS]
    per_step = {k: train_by_shape.get((k, FP32_TRAIN_KEY), 0) / IP_TRAIN_STEPS
                for k in ("flash", "flash_bwd_dq", "flash_bwd_dkv")}
    res = {"phase": "ip_adapter", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}",
           "pipeline_bf16": {k: v for k, v in bf16.items() if k not in UNPRINTED},
           "pipeline_other_normal_max_uint8_diff": token_moves,
           "pipeline_fp32_parity": parity,
           "train_cli_fp32": {
               "batch": TRAIN_BATCH, "mixed_precision": "no (the default)",
               "steps": IP_TRAIN_STEPS, "s_per_step_median_steps_2_on": statistics.median(timed),
               "s_per_step_each": [round(r["s_per_step"], 4) for r in rows],
               "losses": [r["loss"] for r in rows], "max_memory_allocated_bytes": peak,
               "run_wall_s": train_wall, "launches": train_launches,
               f"launches_per_step_at_{'x'.join(map(str, FP32_TRAIN_KEY[0]))}_fp32": per_step,
               "trainable": trainable, "optimizer_params": opt_params, "ip_leaves": n_ip,
               "non_ip_unet_bit_identical": frozen_same, "every_ip_leaf_moved": ip_moved,
               "checkpoint_files": ckpt_files, "checkpoint_gb": ckpt_gb,
               "resume_wall_s": resume_wall, "resumed_to_step": resumed_step},
           "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    bad = []
    if bf16["launches_8_steps"]["flash"] != 8 * attentions_per_unet_forward(ip=True) \
            or bf16["launches_8_steps"]["groupnorm"] == 0:
        bad.append(f"pipeline launches {bf16['launches_8_steps']}")
    if not token_moves > 0:
        bad.append("another normal gave the same image")
    b1 = attentions_per_unet_forward(**PARITY_DEPTH, ip=True)
    if not (parity["finite"] and parity["max_abs_err"] <= parity["max_abs_tol"]) \
            or parity["launches"]["flash"] != b1 or parity["launches"]["groupnorm"] == 0:
        bad.append(f"fp32 parity {parity} (B1: want {b1})")
    t = res["train_cli_fp32"]
    if not all(math.isfinite(x) for x in t["losses"]) or len(t["losses"]) != IP_TRAIN_STEPS + 2:
        bad.append(f"losses {t['losses']}")
    if not (frozen_same and ip_moved and n_ip > 0 and has_proj and "unet" in ckpt_files):
        bad.append(f"frozen {frozen_same}, IP moved {ip_moved} ({n_ip}), files {ckpt_files}")
    if any(n != 5 for n in per_step.values()) or train_launches["groupnorm"] == 0:
        bad.append(f"training launches per step at {FP32_TRAIN_KEY}: {per_step}")
    if resumed_step != IP_TRAIN_STEPS + 2:
        bad.append(f"resumed to step {resumed_step}")
    if bad:
        raise AssertionError(f"ip_adapter failed: {bad}")
    return {"ip_pipeline_8_steps": bf16["by_shape_8"],
            f"ip_train_cli_fp32_{IP_TRAIN_STEPS}_steps": train_by_shape}


def phase_approx(torch, gpu_line: str) -> dict:
    """The approximate modes at full width, bf16, 512²: the main path exact,
    with DeepCache every 3 steps and with encoder reuse every 3 steps, timed
    in turns in one process, each image against the exact one; then
    `tiled_decode` of a 128x128 latent (a 1024² image) against the plain
    decode -> {path: {(kernel, key): launches}}."""
    import numpy as np

    from reflecting_reality_tpu_torch.parallel.sharded_vae import tiled_decode
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    t_phase = time.perf_counter()
    kw = pipeline_inputs(SEED)
    pipe = StableDiffusionBrushNetPipeline(**full_width_modules(torch), dtype=torch.bfloat16,
                                           device="cuda")
    modes = {}
    for name in ("exact", "deep_cache", "encoder_reuse"):
        pipe.disable_deep_cache()
        pipe.disable_encoder_reuse()
        if name != "exact":
            getattr(pipe, f"enable_{name}")(3)
        modes[name] = timed_calls(torch, pipe, kw, APPROX_REPEATS)
    pipe.disable_deep_cache()
    pipe.disable_encoder_reuse()
    exact = modes["exact"]["image_8"].astype(np.int16)
    res = {"phase": "approx", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}",
           "dtype": "bfloat16", "interval": 3}
    for name, m in modes.items():
        diff = np.abs(m["image_8"].astype(np.int16) - exact)
        res[name] = {k: v for k, v in m.items() if k not in UNPRINTED}
        res[name].update(uint8_diff_from_exact_mean=float(diff.mean()),
                         uint8_diff_from_exact_max=int(diff.max()),
                         s_per_step_vs_exact=m["s_per_step"] / modes["exact"]["s_per_step"],
                         s_per_image_8_steps_vs_exact=(m["s_per_image_8_steps"]
                                                       / modes["exact"]["s_per_image_8_steps"]))

    vae = pipe.vae
    z = torch.randn(1, 4, 128, 128, generator=torch.Generator("cuda").manual_seed(SEED),
                    device="cuda").to(torch.bfloat16)
    decodes = {}
    with torch.inference_mode():
        for name, fn in (("plain", lambda: vae.decode(z)),
                         ("tiled", lambda: tiled_decode(vae, z, num_tiles=4, overlap=8))):
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            reset_counters()
            t0 = time.perf_counter()
            img = fn()
            torch.cuda.synchronize()
            decodes[name] = {"s": time.perf_counter() - t0, "by_shape": read_counters_by_shape(),
                             "peak_bytes_above_inputs": torch.cuda.max_memory_allocated() - before,
                             "image": img.float()}
    shapes = {tuple(d["image"].shape) for d in decodes.values()}
    tiled_by_shape = decodes["tiled"]["by_shape"]
    diff = (decodes["tiled"]["image"] - decodes["plain"]["image"]).abs()
    res["tiled_decode"] = {"latent": [1, 4, 128, 128], "num_tiles": 4, "overlap": 8,
                           "max_abs_diff": diff.max().item(), "mean_abs_diff": diff.mean().item(),
                           "launches": {k: sum(n for (kern, _), n in tiled_by_shape.items()
                                               if kern == k) for k in counters()},
                           **{f"{k}_{m}": v[m] for k, v in decodes.items()
                              for m in ("s", "peak_bytes_above_inputs")}}
    del pipe, vae, decodes
    torch.cuda.empty_cache()
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    bad = []
    for name in ("deep_cache", "encoder_reuse"):
        r = res[name]
        if not r["uint8_diff_from_exact_max"] > 0 or not r["launches_8_steps"]["flash"] > 0 \
                or r["launches_8_steps"]["groupnorm"] == 0:
            bad.append(f"{name}: {r}")
    # full steps (0, 3, 6 of 8) launch a forward's 32; a DeepCache step
    # recomputes down block 0 and the last up block (5 transformer blocks,
    # 10 attentions), an encoder-reuse step the mid block and the decoder
    # (10 blocks, 20)
    n = attentions_per_unet_forward()
    want = {"exact": 8 * n, "deep_cache": 3 * n + 5 * 10, "encoder_reuse": 3 * n + 5 * 20}
    for name, n in want.items():
        if res[name]["launches_8_steps"]["flash"] != n:
            bad.append(f"{name} B1 launches {res[name]['launches_8_steps']} (want {n})")
    t = res["tiled_decode"]
    if not (math.isfinite(t["max_abs_diff"]) and shapes == {(1, 3, 1024, 1024)}) \
            or t["launches"]["groupnorm"] == 0:
        bad.append(f"tiled decode {t}, shapes {shapes}")
    if bad:
        raise AssertionError(f"approx failed: {bad}")
    return {**{f"approx_{name}_8_steps": modes[name]["by_shape_8"]
               for name in ("deep_cache", "encoder_reuse")},
            "approx_tiled_decode_128x128": tiled_by_shape}


def phase_serve(torch, gpu_line: str, tmp: str, int8: bool = False, exact=None):
    """`cli/serve.py` as a user starts it (its parser, `build_pipeline` on the
    base folder and train_cli's checkpoint-8, `--max_batch 4`, `warmup` at
    512², with `--int8` when `int8`) behind its handler on 127.0.0.1 in a
    thread: /healthz, one solo request, then SERVE_REQUESTS concurrent ones
    at SERVE_STEPS steps -> ({path: {(kernel, key): launches}}, the burst's
    images/s).  `exact` is the exact server's images/s, printed beside.
    The launches are those the host made: under graphs, the captures' and
    no replay's (what the replays ran is read from a profiler trace)."""
    import base64
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    from PIL import Image

    from reflecting_reality_tpu_torch.cli import serve

    t_phase = time.perf_counter()
    args = serve.build_parser().parse_args([
        "--base_model_path", os.path.join(tmp, "base"),
        "--brushnet_path", os.path.join(tmp, "run", "checkpoint-8", "brushnet"),
        "--depth_conditioning_mode", "concat", "--max_batch", str(SERVE_MAX_BATCH),
        "--num_inference_steps", str(SERVE_STEPS), "--warmup", str(CLI_PX), "--port", "0",
        *(["--int8"] if int8 else [])])
    t0 = time.perf_counter()
    pipe = serve.build_pipeline(args)
    load_s = time.perf_counter() - t0
    server = serve.make_server(args, pipe)
    t0 = time.perf_counter()
    serve.warmup(server, args.warmup, args.num_inference_steps,
                 depth=args.depth_conditioning_mode is not None)
    warmup_s = time.perf_counter() - t0
    httpd = ThreadingHTTPServer((args.host, 0), serve.make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://{args.host}:{httpd.server_port}"

    def png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def payload(k):
        rng = np.random.RandomState(SEED + 100 + k)
        mask = np.zeros((CLI_PX, CLI_PX), np.uint8)
        mask[128:384, 160:352] = 255
        depth = (rng.rand(CLI_PX, CLI_PX) * 65535).astype(np.uint16)
        return {"prompt": f"a framed mirror in a hallway, request {k}",
                "image": png(rng.randint(0, 256, (CLI_PX, CLI_PX, 3), np.uint8)),
                "mask": png(mask), "depth": png(depth), "seed": k}

    def post(body):
        req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                     method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            status, reply = r.status, json.loads(r.read())
        return status, reply, time.perf_counter() - t

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        reset_counters()
        int8_counter().launches = 0
        solo_status, solo, solo_s = post(payload(0))
        results = [None] * SERVE_REQUESTS

        def go(k):
            results[k] = post(payload(k + 1))

        threads = [threading.Thread(target=go, args=(k,)) for k in range(SERVE_REQUESTS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        burst_s = time.perf_counter() - t0
        launched, by_shape = read_counters(), read_counters_by_shape()
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            stats = json.loads(r.read())
        # the solo request again, its steps replayed, against the direct
        # call on the same payload with graphs off (the eager pipeline)
        replayed = None if int8 else graph_kernels(torch, lambda: post(payload(0)))
        pipe.disable_cuda_graphs()
        eager = {}
        eager_kernels = graph_kernels(torch, lambda: eager.update(direct=pipe(
            **serve._parse_payload(payload(0), pipe, SERVE_STEPS))[0]))
        got = np.asarray(Image.open(io.BytesIO(base64.b64decode(solo["images"][0]))))
        solo_diff = int(np.abs(got.astype(np.int16) - eager["direct"].astype(np.int16)).max())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    lat = sorted(r[2] for r in results if r is not None)
    statuses = [r[0] for r in results if r is not None]
    res = {"phase": "serve_int8" if int8 else "serve", "gpu": gpu_line,
           "size": f"{CLI_PX}x{CLI_PX}", "dtype": "bfloat16",
           "steps": SERVE_STEPS, "max_batch": SERVE_MAX_BATCH, "requests": SERVE_REQUESTS,
           "healthz": health, "load_s": load_s, "warmup_s": warmup_s,
           "solo": {"status": solo_status, "latency_s": solo_s,
                    "max_uint8_diff_from_direct_call": solo_diff},
           "burst": {"statuses": statuses, "wall_s": burst_s,
                     "images_per_s": len(statuses) / burst_s,
                     "latency_p50_s": float(np.percentile(lat, 50)) if lat else None,
                     "latency_p95_s": float(np.percentile(lat, 95)) if lat else None,
                     "batch_sizes": sorted(r[1]["batch_size"] for r in results if r)},
           "stats": stats, "launches": launched, "eager_call_kernels": eager_kernels,
           "replayed_solo_kernels": replayed, "phase_wall_s": time.perf_counter() - t_phase}
    if int8:
        res["int8_mm_launches"] = int8_counter().launches
        res["exact_server_images_per_s"] = exact
        res["images_per_s_vs_exact"] = res["burst"]["images_per_s"] / exact
    emit(res)
    del pipe, server
    torch.cuda.empty_cache()
    bad = []
    if health.get("device") != torch.cuda.get_device_name(0) or solo_status != 200:
        bad.append(f"healthz {health}, solo {solo_status}")
    if statuses != [200] * SERVE_REQUESTS or solo_diff > 1:
        bad.append(f"statuses {statuses}, solo vs direct {solo_diff}")
    if stats["requests"] < 1 + SERVE_REQUESTS or stats["batches"] < 2 + 1 + 1 \
            or not max(res["burst"]["batch_sizes"]) > 1:
        bad.append(f"stats {stats}, batch sizes {res['burst']['batch_sizes']}")
    graphs = stats["graphs"]
    if int8:
        # int8 steps stay eager: every B1 and B2 launch is the host's
        if launched["flash"] == 0 or launched["groupnorm"] == 0 or graphs["replays"] > 0:
            bad.append(f"launches {launched}, graphs {graphs}")
        if not res["int8_mm_launches"] > 0:
            bad.append("no int8_mm launch")
    elif not (graphs["replays"] > 0 and graphs["eager_steps"] == 0
              and replayed["graph_launches"] == 2 * SERVE_STEPS
              and replayed["in_graphs"].get("flash_fwd_wgmma", 0) > 0
              and replayed["in_graphs"].get("gn_kernel", 0) > 0
              and replayed["in_graphs"] == eager_kernels["in_denoise"]):
        bad.append(f"graphs {graphs}, replayed solo {replayed}, eager call {eager_kernels}")
    if bad:
        raise AssertionError(f"{res['phase']} failed: {bad}")
    return ({"serve_int8_requests" if int8 else "serve_requests": by_shape},
            res["burst"]["images_per_s"])


def graph_kernels(torch, fn) -> dict:
    """fn() under the profiler: its CUDA graph launches, and the B1 and B2
    kernels it ran ({name: count}; the unqualified name, without template
    arguments): all of them, those a graph launch launched, and those
    launched inside a `rr.pipeline.denoise` range on the launching thread
    (the profiler records the ranges of the thread that started it), each
    kernel matched to its launch by the profiler's correlation id."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)
    calls = {e.get("args", {}).get("correlation"): e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    launches = [c for c, e in calls.items() if e["name"] in ("cudaGraphLaunch", "cuGraphLaunch")]
    denoise = [e for e in events if e["name"].startswith("rr.pipeline.denoise#")]

    def in_denoise(call) -> bool:
        return any(r["tid"] == call["tid"] and r["ts"] <= call["ts"] <= r["ts"] + r["dur"]
                   for r in denoise)

    counts = {"all": {}, "in_graphs": {}, "in_denoise": {}}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        # "void (anonymous namespace)::gn_kernel<__nv_bfloat16, 8, true, 0>(...)"
        name = re.search(r"\w+(?=[<(])|\w+$|$", e["name"]).group(0)
        if name not in ("flash_fwd_wgmma", "flash_fwd_tf32", "gn_kernel"):
            continue
        corr = e.get("args", {}).get("correlation")
        for where, yes in (("all", True), ("in_graphs", corr in launches),
                           ("in_denoise", corr in calls and in_denoise(calls[corr]))):
            if yes:
                counts[where][name] = counts[where].get(name, 0) + 1
    return {"graph_launches": len(launches), **counts}


# ------------------------------------------------------------------ int8

INT8_REPEATS = 2                    # timed 4- and 8-step calls of each mode
INT8_WANT = {"unet": 256, "brushnet": 92}   # modules JAX's default policy selects


def int8_counter():
    from reflecting_reality_tpu_torch.ops import quant

    return quant.int8_mm


def record_int8_gemms(torch, pipe, kw) -> dict:
    """One 1-step call of an int8 pipeline with the int8 layers' calls
    recorded -> {padded (M, K, N): what the GEMM replaces} (the conv's input
    shape, weight shape, stride and padding, or the linear's)."""
    from unittest import mock

    from reflecting_reality_tpu_torch.ops import attention, quant

    seen = {}
    real_conv, real_dense = quant.conv_int8_accumulate, quant.dense_int8

    def padded(m, k, n):               # pad_for_int_mm's sizes
        return (max(m, 17), quant._up8(k), quant._up8(n))

    def conv(xq, wq, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups=1):
        b, cin, h, w = xq.shape
        cout, kh, kw_, _ = wq.shape
        oh = (h + 2 * padding[0] - kh) // stride[0] + 1
        ow = (w + 2 * padding[1] - kw_) // stride[1] + 1
        seen.setdefault(padded(b * oh * ow, kh * kw_ * cin, cout),
                        {"op": "conv", "x": list(xq.shape), "w": [cout, cin, kh, kw_],
                         "stride": list(stride), "padding": list(padding)})
        return real_conv(xq, wq, stride, padding, dilation, groups)

    def dense(x, wq, scale, bias, dtype):
        m = x.numel() // x.shape[-1]
        seen.setdefault(padded(m, wq.shape[1], wq.shape[0]),
                        {"op": "linear", "x": list(x.shape), "w": list(wq.shape)})
        return real_dense(x, wq, scale, bias, dtype)

    with mock.patch.object(quant, "conv_int8_accumulate", conv), \
            mock.patch.object(quant, "dense_int8", dense), \
            mock.patch.object(attention, "dense_int8", dense):
        pipe(**kw, num_inference_steps=1, output_type="latent")
    return seen


def int8_gemm_table(torch, shapes: dict, launched: dict) -> list:
    """Each int8 GEMM shape the path launched: `int8_mm` held exactly
    against its fp64 product on the card, its time, the whole int8 layer's
    (quantize, im2col, GEMM, dequantize) and the bf16 conv or linear it
    replaces."""
    import torch.nn.functional as F

    from reflecting_reality_tpu_torch.ops import quant

    rows = []
    g = torch.Generator("cuda").manual_seed(SEED + 10)
    for key in sorted(launched):
        src = shapes.get(key)
        m, k, n = key
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        got = quant.int8_mm(a, w.t())
        exact = bool(torch.equal(got, quant.int8_mm_plain(a, w.t())))
        mm = lambda: quant.int8_mm(a, w.t())
        plain_ms = cuda_ms(torch, lambda: quant.int8_mm_plain(a, w.t()), iters=5, warmup=1)
        ops, nbytes = 2.0 * m * k * n, m * k + k * n + 4 * m * n
        row = {"mkn": list(key), "launches": launched[key], "exact": exact,
               "int8_mm_ms": cuda_ms(torch, mm), "int8_mm_device_ms": device_ms(torch, mm),
               "plain_fp64_ms": plain_ms, "bound_ms": bound(ops, nbytes, "int8")[0],
               "bound_by": bound(ops, nbytes, "int8")[1]}
        if src is not None:
            x = torch.randn(src["x"], generator=g, device="cuda").to(torch.bfloat16)
            wf = (0.02 * torch.randn(src["w"], generator=g, device="cuda")).to(torch.bfloat16)
            bias = torch.zeros(src["w"][0], device="cuda", dtype=torch.bfloat16)
            scale = torch.full((src["w"][0],), 1e-3, device="cuda")
            if src["op"] == "conv":
                wq = torch.randint(-127, 128, (src["w"][0], src["w"][2], src["w"][3], src["w"][1]),
                                   generator=g, device="cuda", dtype=torch.int8)
                bf16 = lambda: F.conv2d(x, wf, bias, src["stride"], src["padding"])
                layer = lambda: quant.conv_int8(x, wq, scale, bias, torch.bfloat16, src["stride"],
                                                src["padding"])
            else:
                wq = torch.randint(-127, 128, src["w"], generator=g, device="cuda",
                                   dtype=torch.int8)
                bf16 = lambda: F.linear(x, wf, bias)
                layer = lambda: quant.dense_int8(x, wq, scale, bias, torch.bfloat16)
            with torch.inference_mode():
                row.update(source=src, int8_layer_ms=cuda_ms(torch, layer),
                           int8_layer_device_ms=device_ms(torch, layer),
                           bf16_op_ms=cuda_ms(torch, bf16), bf16_op_device_ms=device_ms(torch, bf16))
            del x, wf, wq
        rows.append(row)
    return rows


def device_ms(torch, fn):
    """`graph_ms`, or the capture's error where fn cannot be captured."""
    try:
        return graph_ms(torch, fn)
    except RuntimeError as e:
        torch.cuda.synchronize()
        return f"not measured: {str(e).splitlines()[0][:100]}"


def int_mm_rules(torch) -> dict:
    """What this build's `torch._int_mm` accepts (the card's version): M,
    K, N at the edges and `b` row- or column-major."""
    out = {}
    cases = {"m16": (16, 64, 64, True), "m17": (17, 64, 64, True), "k12": (32, 12, 64, True),
             "n12": (32, 64, 12, True), "b_row_major": (32, 64, 64, False)}
    for name, (m, k, n, col) in cases.items():
        a = torch.ones(m, k, device="cuda", dtype=torch.int8)
        b = (torch.ones(n, k, device="cuda", dtype=torch.int8).t() if col
             else torch.ones(k, n, device="cuda", dtype=torch.int8))
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:
            out[name] = str(e).splitlines()[0][:120]
    return out


def phase_int8(torch, gpu_line: str) -> dict:
    """W8A8 int8 at full width, bf16, 512²: the main path exact and after
    `enable_int8()` in one process (s/step, s/image, peak memory, the
    quantized-module counts, the images' difference), every int8 GEMM shape
    the int8 path launched against fp64 and beside the bf16 op it replaces,
    and one fp32 int8 denoise step card vs CPU (PARITY_DEPTH) -> {path:
    {(kernel, key): launches}}."""
    import numpy as np

    from reflecting_reality_tpu_torch.ops import quant
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    t_phase = time.perf_counter()
    kw = pipeline_inputs(SEED)
    res = {"phase": "int8", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}", "dtype": "bfloat16",
           "int_mm_rules": int_mm_rules(torch)}
    pipe = StableDiffusionBrushNetPipeline(**full_width_modules(torch), dtype=torch.bfloat16,
                                           device="cuda")
    exact = timed_calls(torch, pipe, kw, INT8_REPEATS)
    t0 = time.perf_counter()
    pipe.enable_int8()
    res["quantize_s"] = time.perf_counter() - t0
    res["quantized"] = {name: len(quant.int8_modules(getattr(pipe, name))) for name in INT8_WANT}
    shapes = record_int8_gemms(torch, pipe, kw)
    counter = int8_counter()
    counter.launches = 0
    counter.launches_by_shape.clear()
    q = timed_calls(torch, pipe, kw, INT8_REPEATS)   # the counter holds every call's GEMMs
    counter.launches = 0
    counter.launches_by_shape.clear()
    reset_counters()
    img = pipe(**kw, num_inference_steps=8, output_type="np")
    torch.cuda.synchronize()
    gemm_launches = dict(counter.launches_by_shape)
    q["int8_mm_launches_8_steps"] = counter.launches
    diff = np.abs(q["image_8"].astype(np.int16) - exact["image_8"].astype(np.int16))
    for name, m in (("exact", exact), ("int8", q)):
        res[name] = {k: v for k, v in m.items() if k not in UNPRINTED}
    res["int8"].update(uint8_diff_from_exact_mean=float(diff.mean()),
                       uint8_diff_from_exact_max=int(diff.max()),
                       deterministic=bool(np.array_equal(img, q["image_8"])),
                       s_per_step_vs_exact=q["s_per_step"] / exact["s_per_step"],
                       s_per_image_8_steps_vs_exact=(q["s_per_image_8_steps"]
                                                     / exact["s_per_image_8_steps"]))
    res["gemms"] = int8_gemm_table(torch, shapes, gemm_launches)
    del pipe
    torch.cuda.empty_cache()

    # one fp32 int8 denoise step, card vs CPU.  Each side quantizes the same
    # fp32 weights (identical codes, and every int8 GEMM is exact), but the
    # float work between the products differs in its last bits, so an
    # activation at a code boundary rounds to the neighbouring code on one
    # side only; that moves the next layer's input by a code step, which
    # flips more codes downstream, until the two differ as much as two
    # quantizations of the same net.  So the step is held to the int8 mode's
    # own error: card int8 against CPU int8 within twice CPU int8 against
    # CPU exact, in max and in mean (the exact step itself at 1e-3, as the
    # other phases hold it); a wrong layout, scale or bias would stand far
    # outside that.
    cls, mods, kw = parity_case(torch, "int8")
    exact1, card_e, cpu_e = card_vs_cpu_one_step(torch, mods, kw, cls, keep=True,
                                                 reference="int8_exact")
    parity, card_q, cpu_q = card_vs_cpu_one_step(      # quantizes mods in place
        torch, mods, kw, int8_pipeline_class(), keep=True, exact=False, reference="int8")
    # the card's own sensitivity: the same int8 step on latents moved by 1e-6
    # of themselves (TF32 off, as in the comparison)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    lat = np.random.RandomState(SEED + 6).standard_normal(
        (1, CLI_PX // 8, CLI_PX // 8, 4)).astype(np.float32)
    try:
        moved = StableDiffusionBrushNetPipeline(**mods, device="cuda")(
            **dict(kw, num_inference_steps=1, output_type="latent",
                   deterministic_vae_encode=True, latents=lat * np.float32(1 + 1e-6)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del mods
    torch.cuda.empty_cache()
    # C5: whole int8 layers card vs CPU on the same input
    res["layers_card_vs_cpu"] = int8_layers_card_vs_cpu(torch)
    noise = np.abs(cpu_q - cpu_e)
    err = np.abs(card_q - cpu_q)
    parity.update(max_abs_tol=2 * float(noise.max()), mean_abs_err=float(err.mean()),
                  mean_abs_tol=2 * float(noise.mean()),
                  cpu_int8_vs_exact_max=float(noise.max()),
                  cpu_int8_vs_exact_mean=float(noise.mean()),
                  card_int8_vs_input_moved_1e6_max=float(np.abs(moved - card_q).max()),
                  exact_step_max_abs_err=exact1["max_abs_err"],
                  exact_step_max_abs_tol=exact1["max_abs_tol"], depth=PARITY_DEPTH)
    res["fp32_step_card_vs_cpu"] = parity
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    int8_checks(res, q, parity)
    return {"int8_inference_8_steps": q["by_shape_8"]}


def int8_checks(res: dict, q: dict, parity: dict) -> None:
    """The int8 phase's checks on its line `res`, the int8 path's timed
    calls `q` and the fp32 step card vs CPU `parity`."""
    bad = []
    for name, r in res["layers_card_vs_cpu"].items():
        if not (r["scale_equal"] and r["codes_differing_off_ties"] == 0 and r["output_within"]):
            bad.append(f"int8 layer {name} card vs CPU {r}")
    if res["quantized"] != INT8_WANT:
        bad.append(f"quantized {res['quantized']} (want {INT8_WANT})")
    if not all(r["exact"] for r in res["gemms"]) or not res["gemms"]:
        bad.append(f"int8_mm not exact: {[r['mkn'] for r in res['gemms'] if not r['exact']]}")
    if not q["int8_mm_launches_8_steps"] > 0 or not res["int8"]["deterministic"]:
        bad.append(f"int8_mm launches {q['int8_mm_launches_8_steps']}, "
                   f"deterministic {res['int8']['deterministic']}")
    n = 8 * attentions_per_unet_forward()
    if q["launches_8_steps"]["flash"] != n or q["launches_8_steps"]["groupnorm"] == 0:
        bad.append(f"int8 launches {q['launches_8_steps']} (B1: want {n})")
    if not res["int8"]["uint8_diff_from_exact_max"] > 0 \
            or not res["int8"]["uint8_diff_from_exact_mean"] < 16:
        bad.append(f"int8 vs exact {res['int8']}")
    if not (parity["finite"] and parity["max_abs_err"] <= parity["max_abs_tol"]
            and parity["mean_abs_err"] <= parity["mean_abs_tol"]
            and parity["exact_step_max_abs_err"] <= parity["exact_step_max_abs_tol"]) \
            or parity["launches"]["flash"] == 0:
        bad.append(f"fp32 int8 step card vs CPU {parity}")
    if bad:
        raise AssertionError(f"int8 failed: {bad}")


# -------------------------------------------------------------- baseline

BASELINE_STEPS = 4                  # timed steps of the baseline training step
BASELINE_KEY = ((TRAIN_BATCH, 4096, 8, 40), "float32", 4096)


def baseline_batch(n: int, seed: int) -> dict:
    """A loader-style NHWC batch at CLI_PX² (pixel values, the masked image,
    mask, depth, token ids) from a seed."""
    import numpy as np

    r = np.random.RandomState(seed)
    mask = np.zeros((n, CLI_PX, CLI_PX, 1), np.float32)
    mask[:, 128:384, 160:352] = 1.0
    pixels = r.uniform(-1, 1, (n, CLI_PX, CLI_PX, 3)).astype(np.float32)
    return {"pixel_values": pixels, "conditioning_pixel_values": pixels * (1 - mask),
            "masks": mask, "depths": r.uniform(-1, 1, (n, CLI_PX, CLI_PX, 1)).astype(np.float32),
            "input_ids": r.randint(0, 49408, (n, 77)).astype(np.int64)}


BASELINE_CONFIG = dict(learning_rate=5e-6, lr_warmup_steps=0, depth_conditioning_mode="concat")
# the leaves whose first AdamW moment the card-vs-CPU step compares
BASELINE_LEAVES = ("conv_in.weight",
                   "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
                   "mid_block.resnets.0.conv1.weight", "conv_out.weight")


def baseline_modules(torch, device: str, depth: dict = None) -> tuple:
    """The baseline's seeded 10-channel UNet, VAE and CLIP on `device`
    (`depth` cuts the UNet's and the VAE's)."""
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    torch.manual_seed(SEED + 20)
    with torch.device(device):
        return (UNet2DConditionModel(in_channels=10, **(depth or {})),
                AutoencoderKL(**(depth or {})), CLIPTextModel())


def baseline_parity_step(torch, device: str) -> dict:
    """One baseline training step at batch 1 and PARITY_DEPTH on `device`
    (the modules made on the CPU from their seed, the draws from theirs; the
    caller sets TF32) -> its loss, gradient norm and seconds and the first
    AdamW moment of BASELINE_LEAVES, on the CPU."""
    from reflecting_reality_tpu_torch.baseline.sd_inpainting import make_baseline_train_step
    from reflecting_reality_tpu_torch.training.train_step import TrainConfig

    gd = torch.Generator().manual_seed(SEED + 22)
    shape = (1, 4, CLI_PX // 8, CLI_PX // 8)
    draws = {"vae_noise": {"latents": torch.randn(shape, generator=gd),
                           "cond": torch.randn(shape, generator=gd)},
             "noise": torch.randn(shape, generator=gd), "timesteps": torch.tensor([321])}
    unet, vae, text = baseline_modules(torch, "cpu", PARITY_DEPTH)
    step, init = make_baseline_train_step(unet, vae, text, TrainConfig(**BASELINE_CONFIG),
                                          device=device)
    state = init()
    params = dict(unet.named_parameters())
    t0 = time.perf_counter()
    state, m = step(state, baseline_batch(1, SEED + 23), draws=draws)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "s": time.perf_counter() - t0,
            "mu": {n: state.optimizer.state[params[n]]["exp_avg"].detach().cpu()
                   for n in BASELINE_LEAVES}}


def phase_baseline(torch, gpu_line: str, tmp: str, data: str) -> dict:
    """The SD-inpainting baseline at full width: its training step (the whole
    10-channel UNet, fp32 as the CLI's default, 512² batch 4, depth concat;
    a warm step, BASELINE_STEPS timed ones, peak memory), one step card vs
    CPU at batch 1 on the same draws (`baseline_parity_step`),
    `save_pretrained` to checkpoint-N/unet, then
    `cli.test_baseline.main --image_mode` on it at its default fp32 (2 rows,
    4 seeds, 4 steps) -> {path: {(kernel, key): launches}}."""
    import numpy as np
    from PIL import Image

    from reflecting_reality_tpu_torch.baseline.sd_inpainting import make_baseline_train_step
    from reflecting_reality_tpu_torch.cli import test_baseline
    from reflecting_reality_tpu_torch.core.io import save_pretrained
    from reflecting_reality_tpu_torch.training.train_step import TrainConfig

    t_phase = time.perf_counter()
    res = {"phase": "baseline", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}",
           "batch": TRAIN_BATCH, "dtype": "float32 (the CLI's default)", "in_channels": 10}
    # one step, card vs CPU, batch 1, the same draws, TF32 off: the loss and
    # the first AdamW moment (0.1 x the clipped gradient) of a few leaves,
    # each at 1e-3 of its largest element (train_parity's tolerance)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        reset_counters()
        card = dict(baseline_parity_step(torch, "cuda"), launches=read_counters())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    cpu = REFERENCES.get("baseline")
    res["step_card_vs_cpu"] = {
        "loss": card["loss"], "cpu_loss": cpu["loss"],
        "loss_rel_err": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]), "loss_rel_tol": 1e-4,
        "grad_norm": card["grad_norm"], "cpu_grad_norm": cpu["grad_norm"],
        "card_s": card["s"], "cpu_s": cpu["s"], "launches": card["launches"],
        "depth": PARITY_DEPTH, "cpu_side": "reference process",
        "adam_mu": {n: {"max_abs_err": (card["mu"][n] - cpu["mu"][n]).abs().max().item(),
                        "max_abs_tol": 1e-3 * cpu["mu"][n].abs().max().item(),
                        "finite": bool(torch.isfinite(card["mu"][n]).all())}
                    for n in BASELINE_LEAVES}}

    unet, vae, text = baseline_modules(torch, "cuda")
    step, init = make_baseline_train_step(unet, vae, text, TrainConfig(**BASELINE_CONFIG),
                                          device="cuda")
    state = init()
    w0 = unet.conv_in.weight.detach().clone()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             baseline_batch(TRAIN_BATCH, SEED + 21).items()}
    g = torch.Generator("cuda").manual_seed(SEED)
    state, m = step(state, batch, g)             # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, losses = [], [float(m["loss"])]
    for _ in range(BASELINE_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch, g)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    train_by_shape = read_counters_by_shape()
    per_step = {k: train_by_shape.get((k, BASELINE_KEY), 0) / BASELINE_STEPS
                for k in ("flash", "flash_bwd_dq", "flash_bwd_dkv")}
    res["train"] = {"s_per_step_median": statistics.median(times), "s_each": times,
                    "samples_per_s": TRAIN_BATCH / statistics.median(times), "losses": losses,
                    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                    "conv_in_max_abs_change": (unet.conv_in.weight - w0).abs().max().item(),
                    "launches_per_step_at_4x4096x8x40_fp32": per_step,
                    "launches": read_counters()}
    ckpt = os.path.join(tmp, "baseline_run", f"checkpoint-{BASELINE_STEPS + 1}")
    t0 = time.perf_counter()
    save_pretrained(unet, os.path.join(ckpt, "unet"))
    res["checkpoint"] = {"s": time.perf_counter() - t0,
                         "gb": sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                                   os.walk(ckpt) for f in fs) / 1e9}
    del state, step, init, unet, vae, text, batch
    torch.cuda.empty_cache()

    # the test CLI on the checkpoint, --image_mode, its default fp32
    out = os.path.join(tmp, "baseline_infer")
    argv = ["--brushnet_path", ckpt, "--base_model_path", os.path.join(tmp, "base"),
            "--train_data_dir", data, "--output_dir", out, "--image_mode",
            "--depth_conditioning_mode", "concat", "--resolution", str(CLI_PX),
            "--num_inference_steps", "4", "--seed", str(SEED)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    test_baseline.main(argv)
    torch.cuda.synchronize()
    test_by_shape = read_counters_by_shape()
    sheets = sorted(os.listdir(out))
    arrays = [np.asarray(Image.open(os.path.join(out, f))) for f in sheets]
    res["test_cli"] = {"wall_s": time.perf_counter() - t0, "sheets": sheets,
                       "sheet_shapes": [list(a.shape) for a in arrays],
                       "sheet_std": [float(a.std()) for a in arrays], "launches": read_counters(),
                       "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    bad = []
    tr = res["train"]
    if not all(math.isfinite(x) for x in tr["losses"]) or not tr["conv_in_max_abs_change"] > 0:
        bad.append(f"train {tr}")
    if any(n != 5 for n in per_step.values()) or tr["launches"]["groupnorm"] == 0:
        bad.append(f"launches per step at {BASELINE_KEY}: {per_step} (want 5 each)")
    p = res["step_card_vs_cpu"]
    if not p["loss_rel_err"] <= p["loss_rel_tol"] or any(
            not (r["finite"] and r["max_abs_err"] <= r["max_abs_tol"]) for r in p["adam_mu"].values()):
        bad.append(f"card vs CPU {p}")
    b1 = attentions_per_unet_forward(**PARITY_DEPTH)
    if (p["launches"]["flash"], p["launches"]["flash_bwd_dq"], p["launches"]["flash_bwd_dkv"]) \
            != (b1, b1, b1):
        bad.append(f"card step launches {p['launches']} (want {b1} each)")
    t = res["test_cli"]
    if sheets != ["scene0.png", "scene1.png"] or any(s != [1024, 1024, 3]
                                                      for s in t["sheet_shapes"]) \
            or not min(t["sheet_std"]) > 0 or t["launches"]["flash"] != 2 * CLI_SEEDS * 4 * attentions_per_unet_forward():
        bad.append(f"test_baseline {t}")
    if bad:
        raise AssertionError(f"baseline failed: {bad}")
    shutil.rmtree(os.path.join(tmp, "baseline_run"))
    return {f"baseline_train_{BASELINE_STEPS}_steps": train_by_shape,
            "baseline_test_cli_fp32_4_steps": test_by_shape}


def phase_fp32_conv_cost(torch, gpu_line: str) -> dict:
    """C4's cost: the fp32 paths with cuDNN convolutions in full fp32 (as
    the port runs them) against one TF32 pass (PyTorch's default), in turns
    in one process, TF32 at its default: the fp32 pipeline step (512², one
    image, s/step from 2- and 4-step calls: `pipe(...)` against the bare
    `pipe.generate(...)`) and the fp32 training step (full width, batch 4
    from the latent cache's form: the step against the same step with its
    scope replaced by a no-op) -> {}."""
    from unittest import mock

    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )
    from reflecting_reality_tpu_torch.training import train_step as ts

    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = TF32_DEFAULT
    res = {"phase": "fp32_conv_cost", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}",
           "tf32_default": {"matmul": TF32_DEFAULT[0], "cudnn": TF32_DEFAULT[1]}}
    try:
        pipe = StableDiffusionBrushNetPipeline(**full_width_modules(torch), device="cuda")
        kw = pipeline_inputs(SEED)
        calls = {"fp32_convolutions": pipe, "one_tf32_pass": pipe.generate}
        each = {(name, n): [] for name in calls for n in (2, 4)}
        for fn in calls.values():
            fn(**kw, num_inference_steps=2)               # warm
        for _ in range(FP32_COST_REPEATS):
            for name, fn in calls.items():
                for n in (2, 4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(**kw, num_inference_steps=n)
                    torch.cuda.synchronize()
                    each[(name, n)].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) for k, v in each.items()}
        res["pipeline_s_per_step"] = {name: (med[(name, 4)] - med[(name, 2)]) / 2
                                      for name in calls}
        del pipe, calls
        torch.cuda.empty_cache()

        torch.manual_seed(SEED)
        with torch.device("cuda"):
            unet, vae, text = UNet2DConditionModel(), AutoencoderKL(), CLIPTextModel()
        brushnet = BrushNetModel.from_unet(unet, conditioning_channels=6)
        config = ts.TrainConfig(learning_rate=5e-6, lr_warmup_steps=0,
                                depth_conditioning_mode="concat")
        step, init = ts.make_train_step(unet, brushnet, vae, text, config, device="cuda")
        state = init()
        batch = ddp_global_batch(TRAIN_BATCH)
        gen = torch.Generator("cuda").manual_seed(SEED)
        bare = mock.patch.object(ts, "fp32_convolutions", lambda dtype: contextlib.nullcontext())
        modes = {"fp32_convolutions": contextlib.nullcontext, "one_tf32_pass": lambda: bare}
        times = {name: [] for name in modes}
        for i in range(1 + FP32_COST_REPEATS):
            for name, ctx in modes.items():
                with ctx():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, _ = step(state, batch, gen)
                    torch.cuda.synchronize()
                if i:                                     # the first round warms
                    times[name].append(time.perf_counter() - t0)
        res["train_step_s"] = {name: statistics.median(v) for name, v in times.items()}
        del state, step, init, unet, vae, text, brushnet
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    for key in ("pipeline_s_per_step", "train_step_s"):
        r = res[key]
        r["ratio"] = r["fp32_convolutions"] / r["one_tf32_pass"]
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    return {}


# ---------------------------------------------------------- multi-device

DDP_WORLD = 2                       # ranks of the ddp phase, sharing the one card
DDP_RANK_BATCH = 2                  # --train_batch_size of each rank
DDP_KEY = ((DDP_RANK_BATCH, 4096, 8, 40), "float32", 4096)   # each rank's level-0 self-attentions
DDP_SAMPLE_STRIDE = 97              # every 97th gradient element is compared
DDP_CLI_STEPS = 3                   # the 1-rank NCCL CLI run (checkpoint at its end) ...
DDP_CLI_RESUME_TO = 4               # ... and its resume
DP_SEEDS = 4                        # images of a data-parallel call
DP_REPEATS = 2                      # timed 4- and 8-step calls of each
SHARDS = 4                          # entries of the sharded decodes' mesh
FP32_COST_REPEATS = 2               # turns of each mode in the fp32_conv_cost phase


def ddp_global_batch(n: int) -> dict:
    """A global batch of `n` samples in the latent cache's form (the moments
    of a 512² image, the mask and depth at latent resolution), numpy."""
    import numpy as np

    rng = np.random.RandomState(SEED + 30)
    hl = CLI_PX // 8

    def moments():
        return np.concatenate([rng.standard_normal((n, hl, hl, 4)),
                               rng.uniform(-6.0, -2.0, (n, hl, hl, 4))], axis=-1
                              ).astype(np.float32)

    mask = np.zeros((n, hl, hl, 1), np.float32)
    mask[:, hl // 4: 3 * hl // 4, hl // 3: 2 * hl // 3] = 1.0
    return {"latent_moments": moments(), "cond_latent_moments": moments(), "masks": mask,
            "depths": rng.uniform(-1.0, 1.0, (n, hl, hl, 1)).astype(np.float32),
            "input_ids": rng.randint(0, 49408, (n, 77)).astype(np.int64)}


def ddp_step(rank: int, world: int, port: int, out: str, backend: str = "gloo") -> None:
    """One process of the ddp phase (`--ddp-step RANK WORLD PORT OUT
    [BACKEND]`): with world > 1 rank `rank` of a `backend` group on
    127.0.0.1:`port`, its rows of the global batch (gloo: every rank on the
    first card; nccl: rank r on card r, `chip_multicard.py`); with world 1
    the whole batch and no group.  Full width, fp32, TF32 off: one step (the parity step), then one
    timed step -> `out/ddp_<world>p_<rank>.pt`: loss, gradient norm, every
    DDP_SAMPLE_STRIDE-th element of the gradient recovered from AdamW's
    first moment and its largest |g|, seconds, launches by shape."""
    import datetime

    import torch

    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.parallel import multihost
    from reflecting_reality_tpu_torch.training.train_step import TrainConfig, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if world > 1:
        os.environ["LOCAL_RANK"] = str(rank if backend == "nccl" else 0)
        multihost.initialize(backend=backend, device="cuda",
                             init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=300))
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        unet, vae, text = UNet2DConditionModel(), AutoencoderKL(), CLIPTextModel()
    brushnet = BrushNetModel.from_unet(unet, conditioning_channels=6)
    fill_zero_convs(torch, brushnet, SEED, 0.02)
    config = TrainConfig(learning_rate=5e-6, lr_warmup_steps=0,
                         depth_conditioning_mode="concat")
    step, init = make_train_step(unet, brushnet, vae, text, config, device="cuda")
    state = init()
    full = ddp_global_batch(DDP_WORLD * DDP_RANK_BATCH)
    b = len(full["input_ids"]) // world
    local = {k: v[rank * b:(rank + 1) * b] for k, v in full.items()}
    generator = torch.Generator("cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    state, m = step(state, local, generator)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    by_shape = read_counters_by_shape()
    gn = float(m["grad_norm"])
    unclip = gn / config.max_grad_norm if gn >= config.max_grad_norm else 1.0
    with torch.no_grad():
        g = torch.cat([state.optimizer.state[p]["exp_avg"].reshape(-1) for p in state.params])
        g *= unclip / (1.0 - config.adam_beta1)
        sample, g_max, numel = g[::DDP_SAMPLE_STRIDE].cpu(), g.abs().max().item(), g.numel()
    del g
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m2 = step(state, local, generator)
    torch.cuda.synchronize()
    torch.save({"rank": rank, "world": world, "loss": float(m["loss"]), "grad_norm": gn,
                "loss_step2": float(m2["loss"]), "sample": sample, "g_max": g_max,
                "numel": numel, "first_step_s": first_s,
                "timed_step_s": time.perf_counter() - t0, "by_shape": by_shape,
                "peak_bytes": torch.cuda.max_memory_allocated()},
               os.path.join(out, f"ddp_{world}p_{rank}.pt"))


def phase_ddp(torch, gpu_line: str, tmp: str, cli_fp32_s_step: float) -> dict:
    """Data-parallel training on the one card: DDP_WORLD gloo processes
    against one process on the same global batch and draws, then the
    training CLI as one NCCL rank under torchrun's environment, with a
    checkpoint and a resume -> {path: {(kernel, key): launches}}."""
    import torch.distributed as dist

    from reflecting_reality_tpu_torch.cli import train as cli
    from reflecting_reality_tpu_torch.tools.multiprocess_dryrun import free_port, spawn

    t_phase = time.perf_counter()
    out = os.path.join(tmp, "ddp")
    os.makedirs(out)
    # the ranks and the reference are processes of their own: free this
    # one's cached blocks first.  The kernel libraries exist (phase build),
    # so the children load them and build nothing.
    torch.cuda.empty_cache()
    # the ranks and the one-process reference run side by side (they fit
    # on the card together; only their results are compared)
    script = os.path.join(ROOT, "chip_smoke.py")
    t0 = time.perf_counter()
    port = str(free_port())
    commands = [[sys.executable, script, "--ddp-step", str(r), str(DDP_WORLD), port, out]
                for r in range(DDP_WORLD)]
    commands.append([sys.executable, script, "--ddp-step", "0", "1", "0", out])
    spawn(commands, [os.path.join(out, f"rank{r}.log") for r in range(DDP_WORLD)]
          + [os.path.join(out, "one.log")], timeout_s=600)
    processes_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"ddp_{DDP_WORLD}p_{r}.pt"), weights_only=False)
             for r in range(DDP_WORLD)]
    one = torch.load(os.path.join(out, "ddp_1p_0.pt"), weights_only=False)
    r0 = ranks[0]
    g_err = (r0["sample"] - one["sample"]).abs().max().item()
    res = {"phase": "ddp", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}", "dtype": "float32",
           "tf32": False, "world": DDP_WORLD, "backend": "gloo (two ranks on one card)",
           "batch_per_rank": DDP_RANK_BATCH, "global_batch": DDP_WORLD * DDP_RANK_BATCH,
           "loss": r0["loss"], "one_process_loss": one["loss"],
           "loss_rel_err": abs(r0["loss"] - one["loss"]) / abs(one["loss"]),
           "grad_norm": r0["grad_norm"], "one_process_grad_norm": one["grad_norm"],
           "grad_norm_rel_err": abs(r0["grad_norm"] - one["grad_norm"]) / one["grad_norm"],
           "rel_tol": 1e-4, "grad_elements": one["numel"],
           "grad_elements_compared": len(one["sample"]), "grad_max_abs_err": g_err,
           "grad_max_abs_tol": 1e-3 * one["g_max"], "grad_max_abs": one["g_max"],
           "ranks_identical": all(r["loss"] == r0["loss"] and r["loss_step2"] ==
                                  r0["loss_step2"] and torch.equal(r["sample"], r0["sample"])
                                  for r in ranks),
           "rank_step_s_with_gloo_staging": [r["timed_step_s"] for r in ranks],
           "rank_first_step_s": [r["first_step_s"] for r in ranks],
           "one_process_step_s": one["timed_step_s"],
           "note": "the ranks' step seconds include gloo staging the gradients through the "
                   "host and three processes sharing one card (the ranks and the one-process "
                   "reference side by side): not a scaling figure",
           "rank_peak_bytes": [r["peak_bytes"] for r in ranks],
           "one_process_peak_bytes": one["peak_bytes"],
           "launches_per_rank_step_at_2x4096x8x40_fp32": {
               k: r0["by_shape"].get((k, DDP_KEY), 0)
               for k in ("flash", "flash_bwd_dq", "flash_bwd_dkv")},
           "ranks_and_one_process_wall_s": processes_s}

    # the training CLI as torchrun starts one process: NCCL, WORLD_SIZE=1
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    run = os.path.join(tmp, "ddp_cli")

    def argv(steps: int, *extra):
        return ["--pretrained_model_name_or_path", os.path.join(tmp, "base"),
                "--train_data_dir", os.path.join(tmp, "data"), "--output_dir", run,
                "--logging_dir", os.path.join(run, "logs"), "--train_batch_size",
                str(TRAIN_BATCH), "--depth_conditioning_mode", "concat", "--learning_rate",
                "5e-6", "--lr_warmup_steps", "0", "--precomputed_latents_dir",
                os.path.join(tmp, "cache"), "--dataloader_num_workers", "4", "--log_every", "1",
                "--validation_steps", "0", "--report_to", "none", "--seed", "0",
                "--max_train_steps", str(steps), "--checkpointing_steps", str(DDP_CLI_STEPS),
                "--checkpoints_total_limit", "1", *extra]

    os.environ.update(env)
    try:
        with references_paused():       # the NCCL CLI's s/step is quoted
            reset_counters()
            t0 = time.perf_counter()
            state = cli.main(argv(DDP_CLI_STEPS))
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            cli_by_shape = read_counters_by_shape()
            backend, world = dist.get_backend(), dist.get_world_size()
            del state
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            state = cli.main(argv(DDP_CLI_RESUME_TO, "--resume_from_checkpoint", "latest"))
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            resumed_step = state.step
            del state
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    torch.cuda.empty_cache()
    rows = [r for r in read_metrics(run) if "loss" in r]
    ckpts = sorted(d for d in os.listdir(run) if d.startswith("checkpoint-"))
    shutil.rmtree(run)
    shutil.rmtree(out)
    timed = [r["s_per_step"] for r in rows if r["step"] >= 2]
    res["cli_one_rank_nccl"] = {
        "backend": backend, "world": world, "steps": DDP_CLI_STEPS,
        "resumed_to": resumed_step, "losses": [r["loss"] for r in rows],
        "checkpoints_left": ckpts, "run_wall_s": cli_s, "resume_run_wall_s": resume_s,
        "cli_s_per_step_median_steps_2_on": statistics.median(timed),
        "train_cli_fp32_s_per_step_same_run": cli_fp32_s_step,
        "note": "the difference from train_cli_fp32 is the all-reduce path at world size 1 "
                "(and host noise between the two runs)"}
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    bad = []
    if not (res["loss_rel_err"] <= 1e-4 and res["grad_norm_rel_err"] <= 1e-4
            and g_err <= res["grad_max_abs_tol"] and math.isfinite(r0["loss"])):
        bad.append("two ranks against one process")
    if not res["ranks_identical"]:
        bad.append("the ranks differ")
    if any(n != 5 for n in res["launches_per_rank_step_at_2x4096x8x40_fp32"].values()):
        bad.append(f"B1/B3/B4 launches a rank step: "
                   f"{res['launches_per_rank_step_at_2x4096x8x40_fp32']} (want 5 each)")
    c = res["cli_one_rank_nccl"]
    # the periodic checkpoint at DDP_CLI_STEPS and the resumed run's final one
    if (c["backend"], c["world"], c["resumed_to"]) != ("nccl", 1, DDP_CLI_RESUME_TO) \
            or len(c["losses"]) != DDP_CLI_RESUME_TO \
            or not all(math.isfinite(x) for x in c["losses"]) \
            or c["checkpoints_left"] != [f"checkpoint-{DDP_CLI_STEPS}",
                                         f"checkpoint-{DDP_CLI_RESUME_TO}"]:
        bad.append(f"the one-rank NCCL CLI run: {c}")
    if bad:
        raise AssertionError(f"ddp failed: {bad}: {res}")
    return {f"ddp_rank0_step_batch_{DDP_RANK_BATCH}": r0["by_shape"],
            f"ddp_cli_nccl_{DDP_CLI_STEPS}_steps": cli_by_shape}


def phase_data_parallel(torch, gpu_line: str, tmp: str, data: str) -> dict:
    """`enable_data_parallel` over a mesh of two `cuda:0` entries at full
    width (bf16, DP_SEEDS seeds, 4 and 8 steps in turns, beside the same
    call without it and against each replica's rows called alone; fp32 with
    TF32 off, one step, against the undivided call), then `cli/test.py
    --data_parallel --batch_seeds` and `cli/serve.py --data_parallel` on the
    base folder and checkpoint-8 -> {path: {(kernel, key): launches}}."""
    import threading

    import numpy as np
    from PIL import Image

    from reflecting_reality_tpu_torch.cli import serve
    from reflecting_reality_tpu_torch.cli import test as cli_test
    from reflecting_reality_tpu_torch.parallel.mesh import make_mesh
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    lat = np.random.RandomState(SEED + 31).standard_normal(
        (DP_SEEDS, CLI_PX // 8, CLI_PX // 8, 4)).astype(np.float32)
    kw = dict(pipeline_inputs(SEED), num_images_per_prompt=DP_SEEDS, latents=lat,
              deterministic_vae_encode=True)
    pipe = StableDiffusionBrushNetPipeline(**full_width_modules(torch), dtype=torch.bfloat16,
                                           device="cuda")
    res = {"phase": "data_parallel", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}",
           "mesh": [str(d) for d in mesh], "seeds": DP_SEEDS,
           "note": "two replicas on one card run in turn on its one stream: a cost, not a "
                   "scaling figure"}
    # each replica's rows called alone (its batch, so the same kernels)
    half = DP_SEEDS // len(mesh)
    parts = np.concatenate([pipe(**dict(kw, num_images_per_prompt=half,
                                        latents=lat[i * half:(i + 1) * half]),
                                 num_inference_steps=8) for i in range(len(mesh))])
    runs = {}
    for name in ("single", "data_parallel"):
        if name == "data_parallel":
            pipe.enable_data_parallel(mesh)
        pipe(**kw, num_inference_steps=2)                 # warm
        each = {4: [], 8: []}
        for _ in range(DP_REPEATS):
            for steps in (4, 8):
                torch.cuda.synchronize()
                reset_counters()
                t0 = time.perf_counter()
                img = pipe(**kw, num_inference_steps=steps)
                torch.cuda.synchronize()
                each[steps].append(time.perf_counter() - t0)
                if steps == 8:
                    runs[name] = {"image": img, "by_shape": read_counters_by_shape(),
                                  "launches": read_counters()}
        med = {k: statistics.median(v) for k, v in each.items()}
        runs[name].update(s_per_step=(med[8] - med[4]) / 4, s_8_steps=med[8])
    pipe.disable_data_parallel()
    dp = runs["data_parallel"]["image"].astype(np.int16)
    res["bf16"] = {name: {k: r[k] for k in ("s_per_step", "s_8_steps", "launches")}
                   for name, r in runs.items()}
    # in bf16 a batch of 4 and two of 2 take different kernels, which round
    # differently; the fp32 step below holds the arithmetic itself
    res["bf16"]["uint8_max_diff_from_the_replicas_rows_alone"] = int(
        np.abs(dp - parts.astype(np.int16)).max())
    res["bf16"]["uint8_max_diff_from_one_call_of_4"] = int(
        np.abs(dp - runs["single"]["image"].astype(np.int16)).max())
    res["bf16"]["shape"] = list(runs["data_parallel"]["image"].shape)
    del pipe
    torch.cuda.empty_cache()

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        pipe = StableDiffusionBrushNetPipeline(**full_width_modules(torch), device="cuda")
        kw32 = dict(kw, num_inference_steps=1, output_type="latent",
                    deterministic_vae_encode=True)
        ref = pipe(**kw32)
        pipe.enable_data_parallel(mesh)
        got = pipe(**kw32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    scale = float(np.abs(ref).max())
    res["fp32_one_step"] = {"max_abs_err": float(np.abs(got - ref).max()),
                            "max_abs_tol": 1e-5 * scale, "output_max_abs": scale}
    del pipe
    torch.cuda.empty_cache()

    # cli/test.py --data_parallel on the one card: a mesh of one replica
    out = os.path.join(tmp, "infer", "data_parallel")
    reset_counters()
    t0 = time.perf_counter()
    cli_test.main(["--brushnet_path", os.path.join(tmp, "run", "checkpoint-8"),
                   "--base_model_path", os.path.join(tmp, "base"), "--train_data_dir", data,
                   "--output_dir", out, "--image_mode", "--depth_conditioning_mode", "concat",
                   "--resolution", str(CLI_PX), "--seed", str(SEED), "--weight_dtype", "bf16",
                   "--batch_seeds", "--data_parallel", "--num_inference_steps", "4"])
    torch.cuda.synchronize()
    test_by_shape = read_counters_by_shape()
    sheets = sorted(os.listdir(out))
    shapes = {np.asarray(Image.open(os.path.join(out, f))).shape for f in sheets}
    res["test_cli"] = {"wall_s": time.perf_counter() - t0, "sheets": sheets,
                       "sheet_shapes": [list(s) for s in shapes], "launches": read_counters()}
    shutil.rmtree(out)
    torch.cuda.empty_cache()

    # cli/serve.py --data_parallel: a burst of three requests at 4 steps
    args = serve.build_parser().parse_args([
        "--base_model_path", os.path.join(tmp, "base"),
        "--brushnet_path", os.path.join(tmp, "run", "checkpoint-8", "brushnet"),
        "--depth_conditioning_mode", "concat", "--max_batch", str(SERVE_MAX_BATCH),
        "--num_inference_steps", "4", "--data_parallel"])
    spipe = serve.build_pipeline(args)
    server = serve.make_server(args, spipe)
    rng = np.random.RandomState(SEED + 32)
    mask = np.zeros((CLI_PX, CLI_PX, 3), np.float32)
    mask[128:384, 160:352] = 1.0
    payloads = [{"prompt": f"a mirror, request {k}", "mask": mask, "seed": k,
                 "image": rng.rand(CLI_PX, CLI_PX, 3).astype(np.float32),
                 "depth": rng.rand(CLI_PX, CLI_PX, 1).astype(np.float32)} for k in range(3)]
    replies = [None] * 3

    def go(k):
        replies[k] = server.generate(payloads[k])

    try:
        go(0)                                             # warm
        threads = [threading.Thread(target=go, args=(k,)) for k in range(3)]
        reset_counters()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        burst_s = time.perf_counter() - t0
        serve_by_shape = read_counters_by_shape()
        stats = server.stats()
    finally:
        server.close()
    res["serve"] = {"mesh": [str(d) for d in spipe._dp_mesh], "burst_wall_s": burst_s,
                    "images_per_s": 3 / burst_s, "stats": stats,
                    "images": [len(r["images"]) if r else None for r in replies],
                    "launches": {k: sum(n for (kern, _), n in serve_by_shape.items()
                                        if kern == k) for k in counters()}}
    del spipe, server
    torch.cuda.empty_cache()
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    bad = []
    b = res["bf16"]
    if b["uint8_max_diff_from_the_replicas_rows_alone"] > 1 \
            or b["shape"] != [DP_SEEDS, CLI_PX, CLI_PX, 3] \
            or b["data_parallel"]["launches"]["flash"] != 8 * attentions_per_unet_forward() * 2:
        bad.append(f"bf16 {b}")
    f = res["fp32_one_step"]
    if not f["max_abs_err"] <= f["max_abs_tol"]:
        bad.append(f"fp32 {f}")
    if len(sheets) != CLI_ROWS or shapes != {(2 * CLI_PX, 2 * CLI_PX, 3)} \
            or res["test_cli"]["launches"]["flash"] == 0:
        bad.append(f"test_cli {res['test_cli']}")
    if res["serve"]["images"] != [1, 1, 1] or res["serve"]["mesh"] != ["cuda:0"] \
            or res["serve"]["launches"]["flash"] == 0:
        bad.append(f"serve {res['serve']}")
    if bad:
        raise AssertionError(f"data_parallel failed: {bad}")
    return {"data_parallel_8_steps": runs["data_parallel"]["by_shape"],
            "test_cli_data_parallel_4_steps": test_by_shape,
            "serve_data_parallel_requests": serve_by_shape}


def phase_sharded_vae(torch, gpu_line: str) -> dict:
    """The sharded decodes of a 128x128 latent (a 1024² image) over a mesh
    of SHARDS `cuda:0` entries, fp32, TF32 off: the exact one against the
    plain decode, the blended one against `tiled_decode` with as many
    tiles, JAX's tolerances -> {path: {(kernel, key): launches}}."""
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.parallel.mesh import make_mesh
    from reflecting_reality_tpu_torch.parallel.sharded_vae import (
        sharded_decode, sharded_decode_exact, tiled_decode,
    )

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=["cuda:0"] * SHARDS)
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        vae = AutoencoderKL().eval()
    z = 0.5 * torch.randn(1, 4, 128, 128, generator=torch.Generator("cuda").manual_seed(SEED),
                          device="cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    decodes = {}
    try:
        with torch.inference_mode():
            for name, fn in (("plain", lambda: vae.decode(z)),
                             ("exact", lambda: sharded_decode_exact(vae, z, mesh)),
                             ("tiled", lambda: tiled_decode(vae, z, num_tiles=SHARDS, overlap=8)),
                             ("blended", lambda: sharded_decode(vae, z, mesh, overlap=8))):
                fn()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                reset_counters()
                t0 = time.perf_counter()
                img = fn()
                torch.cuda.synchronize()
                decodes[name] = {"s": time.perf_counter() - t0,
                                 "peak_bytes_above_inputs":
                                     torch.cuda.max_memory_allocated() - before,
                                 "by_shape": read_counters_by_shape(), "image": img}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def close(a, b, rtol, atol):
        excess = ((a - b).abs() - (atol + rtol * b.abs())).max().item()
        return {"max_abs_diff": (a - b).abs().max().item(), "rtol": rtol, "atol": atol,
                "within": excess <= 0}

    res = {"phase": "sharded_vae", "gpu": gpu_line, "latent": [1, 4, 128, 128],
           "image": list(decodes["plain"]["image"].shape), "dtype": "float32", "tf32": False,
           "mesh": [str(d) for d in mesh],
           "exact_vs_plain": close(decodes["exact"]["image"], decodes["plain"]["image"],
                                   1e-4, 2e-5),
           "blended_vs_tiled": close(decodes["blended"]["image"], decodes["tiled"]["image"],
                                     1e-4, 1e-5),
           "note": "the shards run in turn on one card: a cost, not a scaling figure"}
    for name, d in decodes.items():
        res[name] = {"s": d["s"], "peak_bytes_above_inputs": d["peak_bytes_above_inputs"],
                     "launches": {k: sum(n for (kern, _), n in d["by_shape"].items()
                                         if kern == k) for k in counters()}}
    paths = {f"sharded_vae_{name}_128x128": decodes[name]["by_shape"]
             for name in ("exact", "blended")}
    del vae, decodes
    torch.cuda.empty_cache()
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    if not (res["exact_vs_plain"]["within"] and res["blended_vs_tiled"]["within"]) \
            or res["image"] != [1, 3, 1024, 1024] or res["exact"]["launches"]["groupnorm"] == 0:
        raise AssertionError(f"sharded_vae failed: {res}")
    return paths


# ---------------------------------------------------------------- phase 22

SDXL_PX = 1024
SDXL_REPEATS = 2                    # timed 4- and 8-step calls of each count
# stabilityai/stable-diffusion-xl-base-1.0, unet/config.json
SDXL_UNET = dict(
    sample_size=128, in_channels=4, out_channels=4,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(320, 640, 1280), layers_per_block=2,
    transformer_layers_per_block=(1, 2, 10), attention_head_dim=(5, 10, 20),
    cross_attention_dim=2048, use_linear_projection=True, norm_num_groups=32, norm_eps=1e-5,
    addition_embed_type="text_time", addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816)
# text_encoder/ (CLIP ViT-L/14) and text_encoder_2/ (OpenCLIP ViT-bigG/14) config.json
SDXL_TEXT = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072)
SDXL_TEXT_2 = dict(hidden_size=1280, num_hidden_layers=32, num_attention_heads=20,
                   intermediate_size=5120, projection_dim=1280)
# the fp32 card-vs-CPU step: the published widths, the transformer depth and
# the resnets a level (UNet, BrushNet and VAE: PARITY_DEPTH) cut so that the
# CPU's side stays well under a minute
SDXL_PARITY_DEPTH = dict(transformer_layers_per_block=(1, 1, 1), **PARITY_DEPTH)
# the one B2 shape of SDXL's fp32 step at two resnets a level that the cut
# depth does not give (an up-block resnet's input, 640 + 640 channels): the
# kernels phase holds it against its plain version
SDXL_FULL_DEPTH_NORM = ((2, 1280, 64, 64), "float32", True)
SDXL_PARITY_TEXT_LAYERS = 2


def sdxl_modules(torch, tok_dir: str, depth: dict = None, text_layers: int = None,
                 vae_depth: dict = None) -> dict:
    """Seeded SDXL-base modules at the published widths, made on the card
    (the UNet alone is 10.3 GB in fp32), BrushNet `config_from_unet` with 6
    conditioning channels (depth concat, its zero convs given small values),
    and the byte-level tokenizer of `tok_dir` for both encoders; `depth`,
    `text_layers` and `vae_depth` cut the depth."""
    from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import (
        CLIPTextModel, CLIPTextModelWithProjection,
    )
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    tok = CLIPTokenizer.from_pretrained(tok_dir)
    layers = {} if text_layers is None else {"num_hidden_layers": text_layers}
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(**dict(SDXL_UNET, **(depth or {})))
        mods = dict(unet=unet, vae=AutoencoderKL(**(vae_depth or {})),
                    brushnet=BrushNetModel(**BrushNetModel.config_from_unet(
                        unet, conditioning_channels=6)),
                    text_encoder=CLIPTextModel(**dict(SDXL_TEXT, **layers)),
                    text_encoder_2=CLIPTextModelWithProjection(
                        **dict(SDXL_TEXT_2, **layers), eos_token_id=tok.eos_token_id))
    fill_zero_convs(torch, mods["brushnet"], SEED, 0.02)
    return dict(mods, tokenizer=tok, tokenizer_2=tok, depth_conditioning_mode="concat")


def sdxl_inputs(seed: int) -> dict:
    import numpy as np

    rng = np.random.RandomState(seed)
    mask = np.zeros((SDXL_PX, SDXL_PX, 3), np.float32)
    mask[256:768, 320:704] = 1.0
    return dict(prompt="a photo of a mirror on the wall",
                image=rng.rand(SDXL_PX, SDXL_PX, 3).astype(np.float32), mask=mask,
                depth=rng.rand(SDXL_PX, SDXL_PX, 1).astype(np.float32), guidance_scale=7.5,
                scheduler="unipc", seed=SEED)


def sdxl_attention_keys(cfg: dict, dtype: str) -> dict:
    """{B1's launch key: launches} of one SDXL UNet forward at 1024² (CFG
    batch 2): a self- and a cross-attention (77 keys) in each transformer
    layer, at 4096 tokens in down/up block 1 and 1024 in block 2 and the
    mid block."""
    tl, lpb = cfg["transformer_layers_per_block"], cfg["layers_per_block"]
    heads, widths = cfg["attention_head_dim"], cfg["block_out_channels"]
    side = SDXL_PX // 8
    layers = {}
    for i, bt in enumerate(cfg["down_block_types"]):
        if bt.startswith("CrossAttn"):
            layers[i] = layers.get(i, 0) + (2 * lpb + 1) * tl[i]   # down and up blocks
    last = len(tl) - 1
    layers[last] = layers.get(last, 0) + tl[-1]                    # the mid block
    keys = {}
    for i, n in layers.items():
        q = (2, (side >> i) ** 2, heads[i], widths[i] // heads[i])
        keys[(q, dtype, q[1])] = keys[(q, dtype, 77)] = n
    return keys


def phase_sdxl(torch, gpu_line: str, entries: list, ptxas: dict) -> dict:
    """The SDXL BrushNet pipeline at the full published SDXL-base width from
    seeded weights, 1024², CFG 7.5, UniPC, depth concat: bf16 4- and 8-step
    calls in turns (s/step, s/image, peak memory, B1 and B2 launches by
    shape a denoise step, the attentions of a UNet forward by route, a
    traced 4-step call's idle share), one fp32 denoise step and decode card
    vs CPU at 1e-3 of the output's largest value (C4's rule) -> {path:
    {(kernel, key): launches}}."""
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn
    from reflecting_reality_tpu_torch.pipelines import StableDiffusionXLBrushNetPipeline
    from reflecting_reality_tpu_torch.tools.make_synthetic_fullscale import (
        write_byte_tokenizer,
    )

    t_phase = time.perf_counter()
    kw = sdxl_inputs(SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sdxl_") as tok_dir:
        write_byte_tokenizer(tok_dir)
        t0 = time.perf_counter()
        pipe = StableDiffusionXLBrushNetPipeline(**sdxl_modules(torch, tok_dir),
                                                 dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        params = {n: sum(p.numel() for p in getattr(pipe, n).parameters())
                  for n in ("unet", "brushnet", "vae", "text_encoder", "text_encoder_2")}
        bf16 = timed_calls(torch, pipe, kw, SDXL_REPEATS)
        # every UNet forward of the calls runs the same attentions
        st = pipe.stats()
        routes = {r: n / st["steps"] for r, n in st["attention"]["unet"].items()}
        profile = trace(torch, lambda: pipe(**kw, num_inference_steps=4, output_type="np"))
        del pipe
        torch.cuda.empty_cache()

        parity_by_shape = {}
        cls, mods, kw32 = parity_case(torch, "sdxl", tok_dir)
        parity = card_vs_cpu_one_step(torch, mods, kw32, cls, by_shape=parity_by_shape,
                                      reference="sdxl")
        del mods
        torch.cuda.empty_cache()

    per_step = []
    for (kern, key), n in sorted(bf16["by_shape_8"].items(), key=str):
        step = (n - bf16["by_shape_4"].get((kern, key), 0)) / 4
        row = {"kernel": kern, "key": list(key), "launches_8_steps": n, "per_step": step}
        if kern == "groupnorm":
            row["regime"] = gn.launch_plan(key[0], 32).regime
        per_step.append(row)
    want = sdxl_attention_keys(SDXL_UNET, "bfloat16")
    d64 = {k: v for k, v in ptxas.get("flash_attn_fwd", {}).items() if k.endswith("<64>")}
    res = {"phase": "sdxl", "gpu": gpu_line, "size": f"{SDXL_PX}x{SDXL_PX}",
           "source": "stabilityai/stable-diffusion-xl-base-1.0 unet/config.json",
           "dtype": "bfloat16", "cfg": 7.5, "scheduler": "unipc", "params": params,
           "modules_on_card_s": build_s,
           **{k: v for k, v in bf16.items() if k not in UNPRINTED},
           "s_per_image_50_steps_two_point_estimate": (bf16["s_per_image_8_steps"]
                                                       + 42 * bf16["s_per_step"]),
           "launches_by_shape_per_step": per_step,
           "attention_routes_per_unet_forward": routes,
           "profile_4_steps": profile,
           "b1_d64_ptxas": d64,
           "fp32_parity": dict(parity, depth=SDXL_PARITY_DEPTH,
                               text_layers=SDXL_PARITY_TEXT_LAYERS, vae_depth=PARITY_DEPTH),
           "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    bad = []
    if routes != {"flash": sum(want.values()), "plain": 0}:
        bad.append(f"attentions a UNet forward by route {routes} (want {sum(want.values())} "
                   "flash)")
    flash_8 = {key: n for (kern, key), n in bf16["by_shape_8"].items() if kern == "flash"}
    if flash_8 != {key: 8 * n for key, n in want.items()}:
        bad.append(f"bf16 B1 launches in 8 steps {flash_8} (want 8 x {want})")
    # every norm of a step on B2, block 0's 163,840 elements a group in the
    # split regime
    gn_step = {tuple(row["key"][0]) for row in per_step
               if row["kernel"] == "groupnorm" and row["per_step"] > 0}
    if (2, 320, SDXL_PX // 8, SDXL_PX // 8) not in gn_step:
        bad.append(f"bf16 B2 shapes a step {sorted(gn_step)}")
    f32_flash = {key: n for (kern, key), n in parity_by_shape.items() if kern == "flash"}
    want32 = sdxl_attention_keys(dict(SDXL_UNET, **SDXL_PARITY_DEPTH), "float32")
    if not (parity["finite"] and parity["max_abs_err"] <= parity["max_abs_tol"]) \
            or f32_flash != want32 or parity["launches"]["groupnorm"] == 0:
        bad.append(f"fp32 parity {parity}, B1 {f32_flash} (want {want32})")
    if not d64 or any(v.get("spill_stores") or v.get("spill_loads") for v in d64.values()):
        bad.append(f"B1's head-dim-64 instances spill or are missing: {d64}")
    if bad:
        raise AssertionError(f"sdxl failed: {bad}")
    return {"sdxl_bf16_8_steps": bf16["by_shape_8"], "sdxl_fp32_one_step": parity_by_shape}


def int8_layers_card_vs_cpu(torch) -> dict:
    """One `Int8Conv2d` (3x3, 640 -> 640, input (2, 640, 64, 64)) and one
    fused-qkv `Int8Linear` group (320 -> 3 x 320, input (2, 4096, 320)),
    full width, the same fp32 input on the card and the CPU, TF32 off.  The
    activation codes must be equal except at rounding ties (an x/s within
    two ulps of a half-integer; counted).  The outputs are held elementwise
    within two fp32 ulps of the CPU's (|d| <= 2^-22 |cpu|), the CPU's
    computed from the card's codes where a tie flipped one."""
    from unittest import mock

    from reflecting_reality_tpu_torch.ops import quant
    from reflecting_reality_tpu_torch.ops.attention import Attention

    g = torch.Generator().manual_seed(SEED + 40)
    conv = torch.nn.Conv2d(640, 640, 3, padding=1)
    attn = Attention(320, heads=8, dim_head=40)
    with torch.no_grad():
        for p in list(conv.parameters()) + list(attn.parameters()):
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    quant.quantize_modules(attn, quant.select_all)
    cases = {"conv3x3_2x640x64x64": (quant.Int8Conv2d(conv), torch.randn(2, 640, 64, 64,
                                                                         generator=g),
                                     lambda m, x: m(x)),
             "fused_qkv_2x4096x320": (attn, torch.randn(2, 4096, 320, generator=g),
                                      lambda m, x: m._fused(x, (m.to_q, m.to_k, m.to_v)))}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, (layer, x, fn) in cases.items():
            card_layer = copy.deepcopy(layer).cuda()
            with torch.no_grad():
                card = fn(card_layer, x.cuda()).cpu()
                q_card, s_card = (t.cpu() for t in quant.quantize_activation(x.cuda()))
                q_cpu, s_cpu = quant.quantize_activation(x)
                t = (x / s_cpu).abs()
                ties = (t - t.floor() - 0.5).abs() <= 2.0 ** -22 * t
                flipped = q_card != q_cpu
                with mock.patch.object(quant, "quantize_activation",
                                       lambda _x: (q_card, s_card)):
                    cpu = fn(layer, x)
            err = (card - cpu).abs()
            out[name] = {"scale_equal": bool(torch.equal(s_card, s_cpu)),
                         "codes": q_cpu.numel(), "ties": int(ties.sum()),
                         "codes_differing": int(flipped.sum()),
                         "codes_differing_off_ties": int((flipped & ~ties).sum()),
                         "output_max_abs_err": err.max().item(),
                         "output_bound": "|card - cpu| <= 2^-22 |cpu| elementwise",
                         "output_within": bool((err <= 2.0 ** -22 * cpu.abs()).all()),
                         "output_max_abs": cpu.abs().max().item()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


# ------------------------------------------------------------ phase 23-25

BACKEND_REPEATS = 2                 # timed 4- and 8-step calls of each attention backend
BACKEND_TRAIN_STEPS = 2             # timed training steps of each backend
BACKEND_TRACE_STEPS = 2             # steps of each backend's traced pipeline call
BACKENDS = ("flash", "xla")


def set_backend(modules, name: str) -> None:
    from reflecting_reality_tpu_torch.ops.attention import set_attention_backend

    for m in modules:
        set_attention_backend(m, name)


def train_batch(torch, n: int, px: int = 512) -> dict:
    """A seeded NHWC pixel batch on the card (the loader's form)."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    masks = np.zeros((n, px, px, 1), np.float32)
    masks[:, px // 4: 3 * px // 4, 5 * px // 16: 11 * px // 16] = 1.0
    return {k: torch.from_numpy(v).cuda() for k, v in {
        "pixel_values": rng.uniform(-1, 1, (n, px, px, 3)).astype(np.float32),
        "conditioning_pixel_values": rng.uniform(-1, 1, (n, px, px, 3)).astype(np.float32),
        "masks": masks,
        "depths": rng.uniform(-1, 1, (n, px, px, 1)).astype(np.float32),
        "input_ids": rng.randint(0, 49408, (n, 77)).astype(np.int64)}.items()}


def phase_attention_backend(torch, gpu_line: str, data: str, brushnet_path: str,
                            base: str) -> dict:
    """`--attention_backend xla` against the default `flash` on the card:
    one fp32 pipeline step (TF32 off) xla against flash at 1e-3 of the
    output's max; the 512² bf16 depth-concat pipeline (4 and 8 steps,
    BACKEND_REPEATS each) and one bf16 training step at batch 4
    (BACKEND_TRAIN_STEPS timed) under each backend, the backends in turns:
    s/step, peak memory (the training step's from a step of its own each,
    before the timed ones), a traced 2-step call each (device busy time,
    idle share),
    the launches (B1 40 in 8 steps and 5/5/5 a training step under flash,
    B1/B3/B4 none under xla, B2 under both), the 8-step images' uint8
    difference; then `cli.test.main --attention_backend xla` (bf16, batched
    seeds, 2 steps) on `base` and `brushnet_path` over `data`: its sheets,
    and no B1 launch -> {path: {(kernel, key): launches}}."""
    import numpy as np
    from PIL import Image

    from reflecting_reality_tpu_torch.cli import test as cli_test
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )
    from reflecting_reality_tpu_torch.training import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    mods = full_width_modules(torch)
    kw = pipeline_inputs(SEED)
    fp32 = dict(kw, num_inference_steps=1, output_type="latent", deterministic_vae_encode=True,
                latents=np.random.RandomState(SEED + 6).standard_normal(
                    (1, CLI_PX // 8, CLI_PX // 8, 4)).astype(np.float32))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out32, launches32 = {}, {}
    try:
        pipe = StableDiffusionBrushNetPipeline(**mods, device="cuda")
        for name in BACKENDS:
            set_backend((pipe.unet, pipe.brushnet, pipe.vae), name)
            reset_counters()
            out32[name] = pipe(**fp32)
            launches32[name] = read_counters()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    scale = float(np.abs(out32["flash"]).max())
    fp32_step = {"max_abs_err": float(np.abs(out32["xla"] - out32["flash"]).max()),
                 "max_abs_tol": 1e-3 * scale, "output_max_abs": scale,
                 "launches": launches32}

    # bf16: the same modules cast in place; the backends take turns
    pipe = StableDiffusionBrushNetPipeline(**mods, dtype=torch.bfloat16, device="cuda")
    attns = (pipe.unet, pipe.brushnet, pipe.vae)
    switch = {n: functools.partial(set_backend, attns, n) for n in BACKENDS}
    runs = timed_variants(torch, pipe, kw, BACKEND_REPEATS, switch)
    paths = {f"attention_backend_{n}_pipeline_8_steps": r["by_shape_8"] for n, r in runs.items()}
    traces = {}
    for n in BACKENDS:          # device time, which the host's spread does not move
        switch[n]()
        traces[n] = trace(torch, lambda: pipe(**kw, num_inference_steps=BACKEND_TRACE_STEPS,
                                              output_type="np"))
    diff = np.abs(runs["xla"]["image_8"].astype(np.int16)
                  - runs["flash"]["image_8"].astype(np.int16))
    del pipe, mods, attns, switch
    torch.cuda.empty_cache()

    torch.manual_seed(SEED)
    with torch.device("cuda"):
        unet, vae, text = UNet2DConditionModel(), AutoencoderKL(), CLIPTextModel()
    brushnet = BrushNetModel.from_unet(unet, conditioning_channels=6)
    fill_zero_convs(torch, brushnet, SEED, 0.02)
    for m in (unet, vae, text):
        m.to(torch.bfloat16)
    step, init_state = make_train_step(unet, brushnet, vae, text,
                                       TrainConfig(learning_rate=5e-6, lr_warmup_steps=0),
                                       dtype=torch.bfloat16)
    state = init_state()
    batch = train_batch(torch, TRAIN_BATCH)
    gen = torch.Generator("cuda").manual_seed(SEED)
    train = {n: {"s_each": [], "losses": [], "launches": dict.fromkeys(counters(), 0)}
             for n in BACKENDS}
    state, m = step(state, batch, gen)              # warm: AdamW makes its state
    for n, t in train.items():      # a step each from the same state: its peak
        set_backend((unet, brushnet, vae), n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m = step(state, batch, gen)
        t["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    for _ in range(BACKEND_TRAIN_STEPS):                    # the backends in turns
        for n, t in train.items():
            set_backend((unet, brushnet, vae), n)
            torch.cuda.synchronize()
            reset_counters()
            t0 = time.perf_counter()
            state, m = step(state, batch, gen)
            t["losses"].append(float(m["loss"]))
            t["s_each"].append(time.perf_counter() - t0)
            t["launches"] = {k: t["launches"][k] + v for k, v in read_counters().items()}
            path = paths.setdefault(f"attention_backend_{n}_train_{BACKEND_TRAIN_STEPS}_steps",
                                    {})
            for key, v in read_counters_by_shape().items():
                path[key] = path.get(key, 0) + v
    for t in train.values():
        t["s_per_step"] = statistics.median(t["s_each"])
        t["launches_per_step"] = {k: v / BACKEND_TRAIN_STEPS for k, v in t.pop("launches").items()}
    del state, step, m, batch, unet, brushnet, vae, text
    torch.cuda.empty_cache()

    sheets_dir = tempfile.mkdtemp(prefix="chip_smoke_xla_")
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        cli_test.main(["--brushnet_path", brushnet_path, "--base_model_path", base,
                       "--train_data_dir", data, "--output_dir", sheets_dir, "--image_mode",
                       "--depth_conditioning_mode", "concat", "--resolution", str(CLI_PX),
                       "--seed", str(SEED), "--weight_dtype", "bf16", "--batch_seeds",
                       "--num_inference_steps", "2", "--attention_backend", "xla"])
        torch.cuda.synchronize()
        sheets = [np.asarray(Image.open(os.path.join(sheets_dir, f)))
                  for f in sorted(os.listdir(sheets_dir))]
        paths["attention_backend_xla_test_cli"] = read_counters_by_shape()
        test_cli = {"wall_s": time.perf_counter() - t0, "launches": read_counters(),
                    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                    "sheets": [{"shape": list(a.shape), "dtype": str(a.dtype),
                                "std": float(a.std())} for a in sheets]}
    finally:
        shutil.rmtree(sheets_dir, ignore_errors=True)

    res = {"phase": "attention_backend", "gpu": gpu_line, "size": f"{CLI_PX}x{CLI_PX}",
           "fp32_step_xla_vs_flash": fp32_step,
           "pipeline_bf16": {n: {k: v for k, v in r.items() if k not in UNPRINTED}
                             for n, r in runs.items()},
           f"pipeline_bf16_traced_{BACKEND_TRACE_STEPS}_steps": traces,
           "image_8_uint8_max_diff": int(diff.max()),
           "image_8_uint8_mean_diff": float(diff.mean()),
           "xla_over_flash_s_per_step": runs["xla"]["s_per_step"] / runs["flash"]["s_per_step"],
           "xla_minus_flash_peak_gib": (runs["xla"]["max_memory_allocated_bytes"]
                                        - runs["flash"]["max_memory_allocated_bytes"]) / 2**30,
           "train_bf16_batch_4": train,
           "train_xla_over_flash_s_per_step": train["xla"]["s_per_step"]
           / train["flash"]["s_per_step"],
           "train_xla_minus_flash_peak_gib": (train["xla"]["max_memory_allocated_bytes"]
                                              - train["flash"]["max_memory_allocated_bytes"])
           / 2**30,
           "test_cli_xla": test_cli, "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    bad = []
    if not fp32_step["max_abs_err"] <= fp32_step["max_abs_tol"]:
        bad.append(f"fp32 xla vs flash {fp32_step}")
    n = attentions_per_unet_forward()
    if launches32["flash"]["flash"] != n or launches32["xla"]["flash"] != 0:
        bad.append(f"fp32 step launches {launches32}")
    for name, want in (("flash", 8 * n), ("xla", 0)):
        got = runs[name]["launches_8_steps"]
        if got["flash"] != want or got["groupnorm"] == 0:
            bad.append(f"{name} pipeline launches {got}")
        got = train[name]["launches_per_step"]
        trio = (got["flash"], got["flash_bwd_dq"], got["flash_bwd_dkv"])
        if trio != ((n, n, n) if name == "flash" else (0, 0, 0)) or got["groupnorm"] == 0:
            bad.append(f"{name} training launches {got}")
        if not all(math.isfinite(x) for x in train[name]["losses"]):
            bad.append(f"{name} losses {train[name]['losses']}")
    if test_cli["launches"]["flash"] != 0 or test_cli["launches"]["groupnorm"] == 0 or len(
            sheets) != CLI_ROWS or any(a.shape != (2 * CLI_PX, 2 * CLI_PX, 3) or not a.std() > 0
                                       for a in sheets):
        bad.append(f"test CLI under xla {test_cli}")
    if bad:
        raise AssertionError(f"attention_backend failed: {bad}")
    return paths


# (batch per card, remat, EMA, base UNet, frozen): the recipes planned and
# measured; the first is the tool's default, the reference recipe
AOT_RECIPES = (
    dict(batch_per_chip=2, policy="dots", use_ema=True, ema_dtype="fp32"),
    dict(batch_per_chip=2, policy="full", use_ema=True, ema_dtype="fp32"),
    dict(batch_per_chip=2, policy="full", use_ema=True, ema_dtype="bf16"),
    dict(batch_per_chip=4, policy="full", use_ema=False),
    dict(batch_per_chip=2, policy="dots", use_ema=True, ema_dtype="fp32", train_base_unet=True),
    dict(batch_per_chip=2, policy="dots", use_ema=True, ema_dtype="fp32", frozen_bf16=False),
)
# the recipes whose largest batch is searched for, each with the two batches
# of its straight line: the largest batch the search found on the H100 (PR
# 13) and the next, so that while that answer holds they are also its check
AOT_SEARCH = {0: (52, 53), 3: (59, 60)}
AOT_MAX_BATCH = 64                  # ... up to this batch per card
AOT_TOL = (0.10, 1.0)               # measured peak within 10% of the plan, or 1 GiB
# plans run at a lower priority than the rest: the tool's own CLI process,
# which plans and then measures, is the phase's longest chain
AOT_PLAN = ("import json, os, sys; os.nice(10); sys.path.insert(0, {root!r}); "
            "from reflecting_reality_tpu_torch.tools import aot_memory as am; "
            "print(json.dumps(am.plan(**json.loads(sys.argv[1]))))")
AOT_MEASURE = ("import json, sys; sys.path.insert(0, {root!r}); "
               "from reflecting_reality_tpu_torch.tools import aot_memory as am; "
               "[print(json.dumps(am.measure(**r)), flush=True) "
               "for line in sys.stdin for r in json.loads(line)]")


def aot_plan(recipe: dict) -> dict:
    """The memory plan of a recipe on fake cuda tensors, in a process of its
    own (it takes a CPU core)."""
    out = subprocess.run([sys.executable, "-c", AOT_PLAN.format(root=ROOT), json.dumps(recipe)],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"plan {recipe} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def aot_measure(recipes: list) -> subprocess.Popen:
    """Each recipe run for real on the card, one after another, in a process
    of its own (nothing of this one is in its way), which takes a further
    list a line on its standard input (`aot_measure_more`) until that
    closes: one JSON line a recipe (`aot_measured`)."""
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-c", AOT_MEASURE.format(root=ROOT)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
                            text=True)
    proc.err_file = err
    aot_measure_more(proc, recipes)
    return proc


def aot_measure_more(proc: subprocess.Popen, recipes: list) -> None:
    proc.stdin.write(json.dumps(recipes) + "\n")
    proc.stdin.flush()


def aot_measured(proc: subprocess.Popen, n: int, what: str) -> list:
    """The next `n` JSON lines of a measuring process; raise if it ended."""
    lines = []
    while len(lines) < n:
        line = proc.stdout.readline()
        if not line:
            proc.wait(timeout=60)
            proc.err_file.seek(0)
            raise RuntimeError(f"{what} failed:\n{proc.err_file.read()[-3000:]}")
        if line.startswith("{"):
            lines.append(json.loads(line))
    return lines


def aot_lines(proc: subprocess.Popen, n: int, what: str) -> list:
    """The last `n` JSON lines of a finished `proc`; raise if it failed."""
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed:\n{err[-3000:]}")
    return [json.loads(ln) for ln in out.strip().splitlines()[-n:]]


def phase_aot_memory(torch, gpu_line: str, before_largest) -> None:
    """`tools/aot_memory.py` at full width, 512², bf16 autocast: the tool's
    CLI as a user runs it (plan and measurement of the reference recipe,
    AOT_RECIPES[0]), the plan of each other recipe and the real runs of
    them (two steps, peak allocated) in processes started together, then
    the largest batch per card (<= AOT_MAX_BATCH) the plan fits into the
    card for the AOT_SEARCH recipes (a straight line through the plans at
    its two batches, then the plans at that batch and the next) and its real
    run: every measured peak within AOT_TOL of its plan.  Every plan starts
    at once, beside the measurements, and a recipe is planned once;
    `before_largest` waits for the work running beside this phase that
    holds card memory, before the largest batches run."""
    from concurrent.futures import ThreadPoolExecutor

    from reflecting_reality_tpu_torch.tools import aot_memory as am

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    this_process = {"allocated_gib": torch.cuda.memory_allocated() / am.GIB,
                    "reserved_gib": torch.cuda.memory_reserved() / am.GIB}
    hbm = torch.cuda.get_device_properties(0).total_memory / am.GIB
    budget = hbm - am.RESERVE_GIB
    cli = subprocess.Popen([sys.executable, "-m", "reflecting_reality_tpu_torch.tools.aot_memory"],
                           cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    others = list(AOT_RECIPES[1:])
    runs = aot_measure(others)
    pool = ThreadPoolExecutor(len(others) + 2 * len(AOT_SEARCH))
    planned = {}

    def plan_of(recipe):            # a future; each recipe planned once
        key = json.dumps(recipe, sort_keys=True)
        if key not in planned:
            planned[key] = pool.submit(aot_plan, recipe)
        return planned[key]

    def peak(p):
        return p["peak_gib_per_device"]

    probes = {i: [plan_of(dict(AOT_RECIPES[i], batch_per_chip=b)) for b in bs]
              for i, bs in AOT_SEARCH.items()}
    other_futures = [plan_of(r) for r in others]
    stages = {}
    largest = []
    for i, (b0, b1) in AOT_SEARCH.items():
        # past a few samples the peak is in the activations and grows by a
        # fixed amount a sample (at batch 2 it is in AdamW's update): a line
        # through the two probes, then the plans at its batch and the next
        p0, p1 = (peak(f.result()) for f in probes[i])
        b = max(1, min(AOT_MAX_BATCH, int((budget - p0) / ((p1 - p0) / (b1 - b0))) + b0))
        at, above = (plan_of(dict(AOT_RECIPES[i], batch_per_chip=b + d)) for d in (0, 1))
        at, above = at.result(), above.result()
        while peak(at) > budget and b > 1:                      # the line was optimistic
            b, above = b - 1, at
            at = plan_of(dict(AOT_RECIPES[i], batch_per_chip=b)).result()
        while peak(above) <= budget and b < AOT_MAX_BATCH:      # ... or pessimistic
            b, at = b + 1, above
            above = plan_of(dict(AOT_RECIPES[i], batch_per_chip=b + 1)).result()
        largest.append({"recipe": dict(AOT_RECIPES[i], batch_per_chip=b), "plan": at,
                        "next_batch_peak_gib": peak(above)})
    stages["plans_made"] = len(planned) + 1      # and the CLI's own
    stages["search_planned"] = time.perf_counter() - t_phase
    cli_stats = aot_lines(cli, 1, "tools/aot_memory.py")[0]
    stages["cli_done"] = time.perf_counter() - t_phase
    plans = [cli_stats] + [f.result() for f in other_futures]
    pool.shutdown()
    stages["other_plans_done"] = time.perf_counter() - t_phase
    measured = [cli_stats] + aot_measured(runs, len(others), "the measurements")
    t_first = time.perf_counter() - t_phase
    before_largest()
    stages["beside_done"] = time.perf_counter() - t_phase
    recipes = list(AOT_RECIPES) + [x["recipe"] for x in largest]
    plans += [x["plan"] for x in largest]
    aot_measure_more(runs, [x["recipe"] for x in largest])     # the same process
    measured += aot_measured(runs, len(largest), "the largest batches' measurements")
    runs.stdin.close()
    if runs.wait(timeout=60) != 0:
        runs.err_file.seek(0)
        raise RuntimeError(f"the measurements failed:\n{runs.err_file.read()[-3000:]}")
    runs.err_file.close()
    keep = ("argument_gib_per_device", "temp_gib_per_device", "peak_gib_per_device", "split")
    rows = [{"recipe": r, **{k: p[k] for k in keep},
             **{k: v for k, v in m.items() if k.startswith("measured") or k in ("fits", "oom")}}
            for r, p, m in zip(recipes, plans, measured)]
    for r in rows:
        if r.get("fits"):
            r["measured_over_planned"] = r["measured_peak_gib"] / r["peak_gib_per_device"]
    res = {"phase": "aot_memory", "gpu": gpu_line, "hbm_gib": hbm, "budget_gib": budget,
           "resolution": 512, "rows": rows,
           "largest_batch": [{"recipe": x["recipe"], "planned_peak_gib": peak(x["plan"]),
                              "next_batch_planned_peak_gib": x["next_batch_peak_gib"]}
                             for x in largest],
           "cli": cli_stats, "this_process": this_process, "first_wall_s": t_first,
           "stages_s": stages,
           "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    bad = [r for r in rows if not r.get("fits") or abs(
        r["measured_peak_gib"] - r["peak_gib_per_device"]) > max(
        AOT_TOL[0] * r["peak_gib_per_device"], AOT_TOL[1])]
    if bad:
        raise AssertionError(f"aot_memory: measured off the plan {bad}")


def aot_memory_beside_compilation_cache(torch, gpu_line: str) -> None:
    """Phases 24 and 25 side by side: the build cache's two processes
    (nvcc and a few MB on the card) run in a thread during the memory
    planner's first plans and measurements, and are waited for before its
    largest batches fill the card."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        cache = pool.submit(phase_compilation_cache, torch, gpu_line)
        phase_aot_memory(torch, gpu_line, before_largest=cache.result)


def cache_child(cache_dir: str, forbid_nvcc: bool) -> None:
    """`--cache-child`: a fresh process points the build directory at
    `cache_dir` through the test CLI's `--compilation_cache_dir` (as its
    main does first), builds or loads the kernel libraries (with
    `forbid_nvcc`, any nvcc call raises) and launches B1 and B2 once each
    from them against their plain versions; one JSON line."""
    import torch

    from reflecting_reality_tpu_torch.cli.test import build_parser
    from reflecting_reality_tpu_torch.core.jit_cache import enable_compilation_cache
    from reflecting_reality_tpu_torch.ops.kernels import build
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

    args = build_parser().parse_args(["--brushnet_path", "-", "--compilation_cache_dir",
                                      cache_dir])
    enable_compilation_cache(args.compilation_cache_dir)
    if forbid_nvcc:
        def no_nvcc():
            raise AssertionError("nvcc called with the libraries in the cache")
        build.nvcc = no_nvcc
    built_now = {n: not build.library_path(n).exists() for n in LIBRARIES}
    seconds = build_libraries()
    g = torch.Generator("cuda").manual_seed(SEED)
    q, k, v = (torch.randn((2, 4096, 8, 40), generator=g, device="cuda").bfloat16()
               for _ in range(3))
    x = torch.randn((2, 320, 64, 64), generator=g, device="cuda")
    w, b = torch.ones(320, device="cuda"), torch.zeros(320, device="cuda")
    plain, y_plain = fa.attention_plain(q, k, v).float(), gn.group_norm_plain(x, w, b, 32, 1e-5)
    # phase 3's tolerances: 4 bf16 ulps of B1's output max, 1e-5 of B2's
    checks = {"flash": ((fa.flash_attention_fwd(q, k, v)[0].float() - plain).abs().max().item(),
                        4 * bf16_ulp(plain.abs().max().item())),
              "groupnorm": ((gn.group_norm_silu_fwd(x, w, b, 32, 1e-5) - y_plain).abs().max()
                            .item(), 1e-5 * max(1.0, y_plain.abs().max().item()))}
    emit({"cache_dir": str(build.build_dir()), "built_now": built_now, "seconds": seconds,
          "libraries": {n: str(build.library_path(n)) for n in LIBRARIES},
          "max_abs_err_and_tol": checks})


def phase_compilation_cache(torch, gpu_line: str) -> None:
    """A fresh process builds the kernel libraries into a new directory
    through `--compilation_cache_dir`; a second process loads them from it
    without nvcc: each library and its ptxas log in the directory, the
    second process's build seconds under 1, B1 (bf16) and B2 (fp32) from
    the loaded libraries within phase 3's tolerances of their plain
    versions."""
    t_phase = time.perf_counter()
    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        runs = []
        for forbid in (False, True):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--cache-child",
                                  cache] + (["--no-nvcc"] if forbid else []),
                                 capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                raise RuntimeError(f"cache child failed:\n{out.stderr[-3000:]}")
            runs.append(dict(json.loads(out.stdout.strip().splitlines()[-1]),
                             process_s=time.perf_counter() - t0))
        files = sorted(os.listdir(cache))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    res = {"phase": "compilation_cache", "gpu": gpu_line, "files": files,
           "first": runs[0], "second": runs[1], "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    first, second = runs
    in_dir = all(os.path.dirname(p) == os.path.realpath(cache)
                 for r in runs for p in r["libraries"].values())
    logs = all(os.path.basename(p)[:-3] + ".log" in files for p in first["libraries"].values())
    if not (in_dir and logs and all(first["built_now"].values())
            and not any(second["built_now"].values())
            and max(second["seconds"].values()) < 1.0
            and all(e <= t for r in runs for e, t in r["max_abs_err_and_tol"].values())):
        raise AssertionError(f"compilation_cache failed: {res}")


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


def train_cli_fp32_alone() -> None:
    """The train_cli_fp32 phase on its own: the libraries built, a base
    folder and latent cache written to a tempfile dir, the phase's line."""
    import torch

    build_libraries()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        os.makedirs(os.path.join(tmp, "data"))
        write_base_folder(torch, os.path.join(tmp, "base"))
        write_latent_cache(os.path.join(tmp, "data"), os.path.join(tmp, "cache"), CLI_SAMPLES)
        phase_train_cli_fp32(torch, nvidia_smi(), tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ab_train_cli_fp32(other: str, blocks: int) -> None:
    """The train_cli_fp32 phase with the package of another checkout and
    with this one in turns, each in a process of its own: `blocks` times
    other, this, this, other; one `ab_train_cli_fp32` line."""
    runs = []
    order = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)] * blocks
    for name, tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--train-cli-fp32", tree],
                             capture_output=True, text=True, timeout=900, check=True).stdout
        res = next(json.loads(ln) for ln in out.splitlines()
                   if ln.startswith('{"phase": "train_cli_fp32"'))
        runs.append({"tree": name, **{k: v for k, v in res.items() if k not in ("phase", "gpu")}})
    emit({"phase": "ab_train_cli_fp32", "gpu": nvidia_smi(), "other": other, "runs": runs,
          "median_s_per_step": {n: statistics.median(r["cli_s_per_step_median_steps_2_on"]
                                                     for r in runs if r["tree"] == n)
                                for n in ("other", "this")}})


def measure_late(torch, entries: list, paths: dict) -> set:
    """A shape a path launched that phase_kernels did not list (a server's
    batch follows its traffic, SDXL's norms their widths) is measured and
    checked now, after the paths, and added to `entries` -> every launched
    (kernel, key)."""
    t_phase = time.perf_counter()
    measured = {e["key"] for e in entries}
    launched = {k for counts in paths.values() for k, n in counts.items() if n > 0}
    late = sorted(launched - measured, key=str)
    for kern, key in late:
        new = [e for e in kernel_entries(torch, kern, key) if e["key"] not in measured]
        for e in new:
            e["measured_after_paths"] = True
            measured.add(e["key"])
        entries += new
    emit({"phase": "kernels_late", "measured": [[k, list(key)] for k, key in late],
          "phase_wall_s": time.perf_counter() - t_phase})
    return launched


def sdxl_alone(torch) -> None:
    """`--sdxl`: the build, B1 at the SDXL shapes of phase 3, the sdxl phase
    and the late measurement of the shapes it launched."""
    gpu_line = nvidia_smi()
    ptxas = phase_build(torch)
    entries = [e for shape, dt, tk in FLASH_SHAPES if shape[2:] in ((10, 64), (20, 64))
               for e in kernel_entries(torch, "flash", (shape, dt, tk))]
    paths = phase_sdxl(torch, gpu_line, entries, ptxas)
    measure_late(torch, entries, paths)
    rows = [{k: e.get(k) for k in ("name", "ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "max_abs_err")}
            | {"launches_by_path": {p: c.get(e["key"], 0) for p, c in paths.items()}}
            for e in entries]
    emit({"phase": "kernels_detail", "kernels": rows})
    emit_phase_seconds()
    print(gpu_line, flush=True)


def phase_flux(torch, gpu_line: str) -> dict:
    """FLUX.1 Fill [dev] at its published widths in bf16 (seeded weights,
    the hash tokenizers): a 2-step warm-up call at 1024², then a
    `FLUX_STEPS`-step call counted -> {path: B1/B2 launches by shape}."""
    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer, T5HashTokenizer
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.flux_transformer import FluxTransformer2DModel
    from reflecting_reality_tpu_torch.models.t5 import T5EncoderModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.pipelines.flux_fill_pipeline import FluxFillPipeline

    import numpy as np

    t_phase = time.perf_counter()
    dt = torch.bfloat16
    g = torch.Generator("cuda").manual_seed(SEED)

    def seeded(module):
        module.to(dt).to_empty(device="cuda")
        with torch.no_grad():
            for name, p in sorted(module.named_parameters()):
                fan = math.prod(p.shape[1:]) if p.dim() > 1 else 0
                p.normal_(1.0 if fan == 0 and name.endswith("weight") else 0.0,
                          fan ** -0.5 if fan else 0.02, generator=g)
        return module.eval()

    with torch.device("meta"):
        mods = (FluxTransformer2DModel(in_channels=384, out_channels=64, guidance_embeds=True),
                AutoencoderKL(block_out_channels=(128, 256, 512, 512), latent_channels=16,
                              scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False,
                              use_post_quant_conv=False),
                CLIPTextModel(), T5EncoderModel())
    pipe = FluxFillPipeline(*map(seeded, mods), HashTokenizer(vocab_size=49408),
                            T5HashTokenizer(), dtype=dt, device="cuda")
    px = 1024
    img = np.zeros((1, px, px, 3), np.uint8)
    mask = np.zeros((1, px, px, 1), np.uint8)
    mask[:, 256:768, 256:768] = 255
    pipe("warm up", img, mask, num_inference_steps=2, guidance_scale=30.0, seed=1)
    torch.cuda.synchronize()
    reset_counters()
    before = pipe.stats()
    t0 = time.perf_counter()
    out = pipe("a framed mirror on the wall", img, mask, num_inference_steps=FLUX_STEPS,
               guidance_scale=30.0, seed=2)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    by_shape = read_counters_by_shape()
    after = pipe.stats()
    joint = {k: (after["attention"]["joint"][k] - before["attention"]["joint"][k]) / FLUX_STEPS
             for k in ("flash", "plain")}
    emit({"phase": "flux", "call_s": call_s, "steps": FLUX_STEPS,
          "joint_attention_per_step": joint, "stats": after,
          "image_mean": float(out.mean()), "finite": bool(np.isfinite(out).all()),
          "memory_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": {f"{k[0]} {k[1]}": n for k, n in by_shape.items()},
          "nvidia_smi": gpu_line, "phase_wall_s": time.perf_counter() - t_phase})
    if joint["flash"] != FLUX_JOINT_ATTENTIONS or joint["plain"]:
        raise AssertionError(f"FLUX joint attentions a step {joint}, not "
                             f"{FLUX_JOINT_ATTENTIONS} flash")
    del pipe, mods
    torch.cuda.empty_cache()
    return {f"flux_bf16_{FLUX_STEPS}_steps": by_shape}


def flux_alone(torch) -> None:
    """`--flux`: the build, B1 at FLUX.1's shape and a FLUX.1 Fill call."""
    gpu_line = nvidia_smi()
    phase_build(torch)
    entries = [e for shape, dt, tk in FLASH_SHAPES if shape[2:] == (24, 128)
               for e in kernel_entries(torch, "flash", (shape, dt, tk))]
    paths = phase_flux(torch, gpu_line)
    rows = [{k: e.get(k) for k in ("name", "ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "max_abs_err", "rel_l2_err")}
            | {"launches_by_path": {p: c.get(e["key"], 0) for p, c in paths.items()}}
            for e in entries]
    emit({"phase": "kernels_detail", "kernels": rows})
    emit_phase_seconds()
    print(gpu_line, flush=True)


def backend_memory_cache_alone(torch) -> None:
    """`--backend-memory-cache`: the build and phases 23-25 alone, the test
    CLI of phase 23 on a seeded base folder and BrushNet written here."""
    from reflecting_reality_tpu_torch.core.io import save_pretrained
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel

    gpu_line = nvidia_smi()
    phase_build(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        base, data = os.path.join(tmp, "base"), os.path.join(tmp, "msd")
        write_base_folder(torch, base)
        write_image_mode_data(data)
        torch.manual_seed(SEED)
        with torch.device("cuda"):
            brushnet = BrushNetModel(conditioning_channels=6)
        fill_zero_convs(torch, brushnet, SEED, 0.02)
        save_pretrained(brushnet, os.path.join(tmp, "ckpt", "brushnet"))
        del brushnet
        phase_attention_backend(torch, gpu_line, data, os.path.join(tmp, "ckpt"), base)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    aot_memory_beside_compilation_cache(torch, gpu_line)
    emit_phase_seconds()
    emit({"phase": "run", "seconds": time.perf_counter() - T_START})
    print(gpu_line, flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--cpu-references"]:
        # before torch starts a thread: the reference process's threads
        # keep off two cores and run at the lowest priority
        cores = sorted(os.sched_getaffinity(0))
        if len(cores) > 4:
            os.sched_setaffinity(0, cores[2:])
        os.nice(19)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 2
    alone = sys.argv[1:2] == ["--train-cli-fp32"]
    # the package of this checkout, or of the one --train-cli-fp32 names
    sys.path.insert(0, os.path.abspath(sys.argv[2]) if alone and len(sys.argv) > 2 else ROOT)
    import reflecting_reality_tpu_torch  # noqa: F401  (fails outside a checkout)

    if sys.argv[1:2] == ["--ddp-step"]:
        ddp_step(*map(int, sys.argv[2:5]), *sys.argv[5:7])
        return 0
    if sys.argv[1:2] == ["--ab-main-path"]:
        ab_main_path(os.path.abspath(sys.argv[2]), int(sys.argv[3]) if len(sys.argv) > 3 else 1)
        return 0
    if alone:
        train_cli_fp32_alone()
        return 0
    if sys.argv[1:2] == ["--ab-train-cli-fp32"]:
        ab_train_cli_fp32(os.path.abspath(sys.argv[2]),
                          int(sys.argv[3]) if len(sys.argv) > 3 else 1)
        return 0
    if sys.argv[1:2] == ["--sdxl"]:
        sdxl_alone(torch)
        return 0
    if sys.argv[1:2] == ["--flux"]:
        flux_alone(torch)
        return 0
    if sys.argv[1:2] == ["--train-cli-modes"]:
        train_cli_modes(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--cache-child"]:
        cache_child(sys.argv[2], sys.argv[3:4] == ["--no-nvcc"])
        return 0
    if sys.argv[1:2] == ["--cpu-references"]:
        cpu_references(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--backend-memory-cache"]:
        backend_memory_cache_alone(torch)
        return 0
    global TF32_DEFAULT, REFERENCES
    TF32_DEFAULT = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    REFERENCES = refs = CpuReferences()
    try:
        gpu_line = nvidia_smi()
        emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
              "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
              "capability": list(torch.cuda.get_device_capability(0)),
              "device_count": torch.cuda.device_count(), "nvidia_smi": gpu_line,
              "importable": {m: importlib.util.find_spec(m) is not None for m in ABSENT_MODULES},
              "clocks_max_sm_mhz": max_sm_clock_hz() / 1e6,
              "cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads(),
              "tf32_default": {"matmul": TF32_DEFAULT[0], "cudnn": TF32_DEFAULT[1]}})
        ptxas = phase_build(torch)
        refs.get("modules_on_cpu")      # the reference process is done with the card
        # it stops through the phases whose speed PERF.md quotes (the main
        # path, the training step and CLIs, the test CLI, the server, the
        # NCCL CLI, the replicas, SDXL), through the kernels' timings, and
        # through slice's and train_parity's own CPU sides
        with references_paused():
            entries = phase_kernels(torch)
            phase_slice(torch)
            by_shape, main_per_step = phase_main(torch, gpu_line)
            parity_by_shape = phase_train_parity(torch)
            train_by_shape, train_s_step = phase_train_main(torch, gpu_line)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            with references_paused():
                cli_by_shape = phase_train_cli(torch, gpu_line, train_s_step, tmp)
                test_by_shape, sheets, data = phase_test_cli(torch, gpu_line, tmp,
                                                             main_per_step, entries)
            phase_evaluate(torch, gpu_line, tmp, sheets, data)
            with references_paused():
                cli32_by_shape, cli32_s_step = phase_train_cli_fp32(torch, gpu_line, tmp)
            phase_fp32_conv_cost(torch, gpu_line)
            new_paths = phase_ip_adapter(torch, gpu_line, tmp)
            with references_paused():
                serve_paths, serve_rate = phase_serve(torch, gpu_line, tmp)
            new_paths.update(serve_paths)
            new_paths.update(phase_serve(torch, gpu_line, tmp, int8=True, exact=serve_rate)[0])
            new_paths.update(phase_baseline(torch, gpu_line, tmp, data))
            new_paths.update(phase_ddp(torch, gpu_line, tmp, cli32_s_step))
            with references_paused():
                new_paths.update(phase_data_parallel(torch, gpu_line, tmp, data))
            new_paths.update(phase_attention_backend(torch, gpu_line, data,
                                                     os.path.join(tmp, "run", "checkpoint-8"),
                                                     os.path.join(tmp, "base")))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        new_paths.update(phase_modes(torch, gpu_line))
        new_paths.update(phase_approx(torch, gpu_line))
        new_paths.update(phase_int8(torch, gpu_line))
        new_paths.update(phase_sharded_vae(torch, gpu_line))
        with references_paused():
            new_paths.update(phase_sdxl(torch, gpu_line, entries, ptxas))
    except BaseException:
        refs.close(join=False)
        raise
    REFERENCES = None
    refs.close(join=True)               # its CUDA context leaves the card before aot_memory
    aot_memory_beside_compilation_cache(torch, gpu_line)

    # each entry carries the launches of its own kernel, shape and dtype on
    # each path: the main path's 8-step call (and per denoise step), the
    # TRAIN_REPEATS timed training steps (and per training step), the
    # training CLI's first run (8 steps), the test CLI's bf16 8-step and
    # fp32 4-step runs (2 rows of 4 seeds each), train_parity's fp32 loss
    # and backward, the training CLI's default fp32 run, and the paths of
    # the later phases (ip_adapter to sdxl)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    paths = {"main_path_8_steps": by_shape[8],
             f"train_main_{TRAIN_REPEATS}_steps": train_by_shape,
             "train_cli_8_steps": cli_by_shape,
             "test_cli_bf16_8_steps": test_by_shape["a_8_steps"],
             "test_cli_fp32_4_steps": test_by_shape["b_fp32_4_steps"],
             "train_parity": parity_by_shape,
             f"train_cli_fp32_{CLI_FP32_STEPS}_steps": cli32_by_shape, **new_paths}
    launched = measure_late(torch, entries, paths)
    rows = []
    for e in entries:
        row = {k: e.get(k) for k in keys if k != "launches"}
        row["launches_by_path"] = {path: counts.get(e["key"], 0) for path, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        main_n = row["launches_by_path"]["main_path_8_steps"]
        row["launches_per_denoise_step"] = (main_n - by_shape[4].get(e["key"], 0)) / 4
        row["launches_per_train_step"] = train_by_shape.get(e["key"], 0) / TRAIN_REPEATS
        row["launches_per_cli_step"] = cli_by_shape.get(e["key"], 0) / 8
        row.update({k: e[k] for k in e if k not in row and k not in ("key", "kernel", "ms")})
        rows.append(row)
    emit({"phase": "kernels_detail", "kernels": rows})
    emit_phase_seconds()
    summary = [r for r in rows if r["launches"] > 0]
    missing = {e["kernel"] for e in entries} - {e["kernel"] for e, r in zip(entries, rows)
                                                 if r["launches"] > 0}
    if missing:
        raise AssertionError(f"no measured shape of {missing} ran on a path")
    unmeasured = launched - {e["key"] for e in entries}
    if unmeasured:
        raise AssertionError(f"launched on a path, never measured: {sorted(unmeasured, key=str)}")
    emit({"kernels": summary})
    emit({"phase": "run", "seconds": time.perf_counter() - T_START})
    print(gpu_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
