"""MirrorFusion training CLI, the port's counterpart of
`reflecting_reality_tpu/cli/train.py` (reference:
examples/brushnet/train_brushnet_mirror.py).

One run does the whole job with the port's own modules: it loads a
diffusers-layout SD-1.5 folder, builds BrushNet by `from_unet` surgery (or
loads one), reads SynMirror, MSD or a latent-moments cache, trains through
`training.train_step` (kernels B1-B4 on the card), writes reference-layout
checkpoints (`training.checkpoint`), resumes from them, and validates
through the port's pipeline.  Every flag name and default of the JAX
parser is kept, so reference launch scripts parse; `--device` is added
(default `cuda`, raising without a card; `cpu` runs the plain PyTorch
paths).

conditioning_channels follows the reference exactly (:968-979):
5 + {concat:1, latents:4}(depth) + {concat:3, latents:4}(normals).

Normals `ip_adapter` mode (JAX :85-151, :204-208, :319-363): the UNet is
built with IP-Adapter fields (`ip_num_tokens=4`, `--ip_adapter_scale`) and
its to_k_ip/to_v_ip start as copies of to_k/to_v; a fresh
`NormalProjModel` is drawn from a generator seeded 1 (JAX: PRNGKey(1)); the
batch's (B, 1, 3) mean mirror normal crosses in fp32 whatever the transport
dtype; only to_k_ip/to_v_ip, `normal_proj` and BrushNet train, and under
bf16 the IP leaves keep fp32 masters in the otherwise bf16 UNet.
Checkpoints add `unet/` and `ip_adapter/normal_proj.safetensors`.

Under `--mixed_precision bf16` the frozen UNet, VAE and CLIP are stored in
bf16 and the trainables keep fp32 masters; batches cross to the card in
bf16 (`--input_transport_dtype auto`), which the step consumes unchanged.
`--steps_per_dispatch K` uploads K batches at once and runs K steps on
them, with checkpoints, validation and logging on the boundaries; one
device `torch.Generator` seeded from `--seed` draws every step's random
numbers in the same order for any K.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from reflecting_reality_tpu_torch.core.device import resolve_device
from reflecting_reality_tpu_torch.core.jit_cache import enable_compilation_cache
from reflecting_reality_tpu_torch.core.tracing import device_memory_stats
from reflecting_reality_tpu_torch.data.loader import DataLoader, prefetch_to_device
from reflecting_reality_tpu_torch.data.synmirror import read_rows
from reflecting_reality_tpu_torch.ops.attention import set_attention_backend
from reflecting_reality_tpu_torch.parallel import multihost
from reflecting_reality_tpu_torch.training import checkpoint as ckpt
from reflecting_reality_tpu_torch.training.train_step import (
    TrainConfig,
    make_train_step,
    resolve_device_cache,
)

logger = logging.getLogger(__name__)


def conditioning_channels_for(depth_mode: Optional[str], normals_mode: Optional[str]) -> int:
    ch = 5
    ch += {"concat": 1, "latents": 4, None: 0}[depth_mode]
    ch += {"concat": 3, "latents": 4, "ip_adapter": 0, None: 0}[normals_mode]
    return ch


class JsonlTracker:
    """Always-on tracker: one JSON line per logged step in
    `logging_dir/metrics.jsonl`."""

    def __init__(self, logging_dir: str):
        os.makedirs(logging_dir, exist_ok=True)
        self.f = open(os.path.join(logging_dir, "metrics.jsonl"), "a")

    def log(self, values: dict, step: int):
        self.f.write(json.dumps({"step": step, **values}) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


def make_trackers(args):
    """The run's trackers; none on a rank other than 0."""
    if not multihost.is_main_process():
        return []
    trackers = [JsonlTracker(args.logging_dir)]
    if args.report_to in ("wandb", "all"):
        try:
            import wandb
        except ImportError as e:
            logger.warning("wandb unavailable (%s); logging to jsonl only", e)
        else:
            wandb.init(project=args.tracker_project_name, config=vars(args))
            trackers.append(wandb)
    return trackers


def log_to_trackers(trackers, values: dict, step: int):
    for t in trackers:
        t.log(values, step=step)


def load_models(args):
    """SD-1.5 components (CPU, fp32) and the BrushNet twin: loaded from
    `--brushnet_model_name_or_path`, else built by `from_unet` surgery; in
    ip_adapter mode the UNet's IP leaves copied from to_k/to_v and a fresh
    `NormalProjModel`.  -> (unet, brushnet, vae, text_encoder, tokenizer,
    normal_proj or None)."""
    from reflecting_reality_tpu_torch.core.io import load_pretrained
    from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer
    from reflecting_reality_tpu_torch.models import ip_adapter
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import load_text_encoder
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    base = args.pretrained_model_name_or_path
    ip_mode = args.normals_conditioning_mode == "ip_adapter"
    normal_proj = None
    if ip_mode:
        # base SD checkpoints lack the decoupled IP projections: they start
        # as copies of to_k/to_v
        unet = ip_adapter.init_ip_params_from_unet(load_pretrained(
            UNet2DConditionModel, base, subfolder="unet", allow_missing=ip_adapter.IP_NAMES,
            ip_num_tokens=ip_adapter.DEFAULT_NUM_TOKENS, ip_scale=args.ip_adapter_scale))
        normal_proj = ip_adapter.build_normal_proj(
            unet.cross_attention_dim, generator=torch.Generator().manual_seed(1))
    else:
        unet = load_pretrained(UNet2DConditionModel, base, subfolder="unet")
    vae = load_pretrained(AutoencoderKL, base, subfolder="vae")
    text = load_text_encoder(base)
    tokenizer = CLIPTokenizer.from_pretrained(base, subfolder="tokenizer")
    if args.brushnet_model_name_or_path:
        brushnet = load_pretrained(BrushNetModel, args.brushnet_model_name_or_path)
    else:
        torch.manual_seed(args.seed or 0)
        brushnet = BrushNetModel.from_unet(unet, conditioning_channels=conditioning_channels_for(
            args.depth_conditioning_mode, args.normals_conditioning_mode))
    return unet, brushnet, vae, text, tokenizer, normal_proj


def _dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 1e9


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    enable_compilation_cache(args.compilation_cache_dir)
    multihost.initialize(device=args.device)
    rank, world = multihost.rank_and_world()
    device = resolve_device(multihost.local_device(args.device))
    dtype = {"no": torch.float32, "fp16": torch.float32, "bf16": torch.bfloat16}[
        args.mixed_precision]
    transport_dtype = None
    if args.input_transport_dtype == "bf16" or (
            args.input_transport_dtype == "auto" and args.mixed_precision == "bf16"):
        transport_dtype = torch.bfloat16
    # ip_adapter mode reads batch["normals"] in fp32 (freq_encode to 2^5):
    # the host-side cast would change it
    transport_exempt = ("normals",) if args.normals_conditioning_mode == "ip_adapter" else ()

    t_load = time.time()
    logger.info("Loading models from %s ...", args.pretrained_model_name_or_path)
    unet, brushnet, vae, text, tokenizer, normal_proj = load_models(args)
    for m in (unet, brushnet, vae):     # the training step's and validation's attentions
        set_attention_backend(m, args.attention_backend)
    logger.info("Models loaded in %.1fs", time.time() - t_load)

    rows = read_rows(os.path.join(args.train_data_dir, args.train_csv), args.max_train_samples)
    host_cache = None
    if args.precomputed_latents_dir:
        from reflecting_reality_tpu_torch.data.latent_cache import LatentCachedDataset

        if args.random_flip:
            raise SystemExit("--precomputed_latents_dir caches one deterministic variant; "
                             "drop --random_flip or train without the cache")
        dataset = LatentCachedDataset(
            args.precomputed_latents_dir, rows, tokenizer,
            proportion_empty_prompts=args.proportion_empty_prompts,
            mirror_prompt=args.mirror_prompt, caption_column=args.caption_column,
            seed=args.seed)
        if args.device_cache:
            from reflecting_reality_tpu_torch.data.latent_cache import (
                DeviceCacheIndexDataset, materialize_cache)

            max_gb = float(os.environ.get("RR_DEVICE_CACHE_MAX_GB", 4.0))
            host_cache = materialize_cache(dataset, transport_dtype=transport_dtype,
                                           max_bytes=int(max_gb * 1e9),
                                           transport_exempt=transport_exempt)
            dataset = DeviceCacheIndexDataset(dataset)
    elif args.device_cache:
        raise SystemExit("--device_cache requires --precomputed_latents_dir")
    else:
        from reflecting_reality_tpu_torch.data.synmirror import HDF5Dataset, MSDDataset

        ds_cls = {"synmirror": HDF5Dataset, "msd": MSDDataset}[args.dataset_type]
        dataset = ds_cls(
            args.train_data_dir, rows, tokenizer,
            resolution=args.resolution,
            proportion_empty_prompts=args.proportion_empty_prompts,
            mirror_prompt=args.mirror_prompt, caption_column=args.caption_column,
            random_flip=args.random_flip, seed=args.seed,
            depth=args.depth_conditioning_mode is not None,
            normals_conditioning_mode=args.normals_conditioning_mode or False,
            hint_map_dir=args.hint_map_dir, cam_states=args.cam_states)
    # each rank reads its rows of every global batch (JAX :273-282)
    loader = DataLoader(dataset, args.train_batch_size * world, shuffle=True,
                        num_workers=args.dataloader_num_workers or 8, seed=args.seed or 0,
                        process_index=rank, process_count=world)
    if len(loader) == 0:
        raise ValueError(f"dataset ({len(dataset)} samples) smaller than the global batch "
                         f"({args.train_batch_size} x {world})")

    config = TrainConfig(
        learning_rate=args.learning_rate, scale_lr=args.scale_lr,
        lr_scheduler=args.lr_scheduler, lr_warmup_steps=args.lr_warmup_steps,
        lr_num_cycles=args.lr_num_cycles, lr_power=args.lr_power,
        max_train_steps=args.max_train_steps, adam_weight_decay=args.adam_weight_decay,
        adam_epsilon=args.adam_epsilon, max_grad_norm=args.max_grad_norm,
        snr_gamma=args.snr_gamma,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        gradient_checkpointing=args.gradient_checkpointing,
        gradient_checkpointing_policy=args.gradient_checkpointing_policy,
        train_base_unet=args.train_base_unet, use_ema=args.use_ema, ema_dtype=args.ema_dtype,
        depth_conditioning_mode=args.depth_conditioning_mode,
        normals_conditioning_mode=args.normals_conditioning_mode,
    )
    if args.mixed_precision == "bf16":
        # reference policy (train_brushnet_mirror.py:1125-1167): frozen modules
        # stored in half precision, trainables keep fp32 masters
        for m in (vae, text):
            m.to(torch.bfloat16)
        if not args.train_base_unet:
            # in ip_adapter mode the IP leaves are trainable: fp32 masters
            from reflecting_reality_tpu_torch.models.ip_adapter import is_ip_param_name

            for name, p in unet.named_parameters():
                if normal_proj is None or not is_ip_param_name(name):
                    p.data = p.data.to(torch.bfloat16)
    step_fn, init_state = make_train_step(unet, brushnet, vae, text, config, dtype=dtype,
                                          device=device, normal_proj=normal_proj)
    t_up = time.time()
    state = init_state()
    logger.info("State resident in %.1fs", time.time() - t_up)

    trackers = make_trackers(args)
    try:
        resume_path = None
        if args.resume_from_checkpoint:
            resume_path = (ckpt.latest_checkpoint(args.output_dir)
                           if args.resume_from_checkpoint == "latest"
                           else args.resume_from_checkpoint)
        if resume_path:
            t_resume = time.time()
            ckpt.load_state(resume_path, state)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            logger.info("Resumed from %s at step %d", resume_path, state.step)
            log_to_trackers(trackers, {"resume_s": time.time() - t_resume,
                                       "resumed_from": resume_path}, state.step)

        device_cache = None
        if host_cache is not None:
            # one upload of the whole sample cache; per step only the index
            # and input_ids cross (train_step.resolve_device_cache)
            device_cache = {k: (v.pin_memory() if device.type == "cuda" else v)
                            .to(device, non_blocking=True) for k, v in host_cache.items()}
            logger.info("Device cache: %d samples, %.2f GB resident", len(dataset),
                        sum(v.nbytes for v in device_cache.values()) / 1e9)
            del host_cache

        os.makedirs(args.output_dir, exist_ok=True)
        if rank == 0:
            with open(os.path.join(args.output_dir, "args.json"), "w") as f:
                json.dump(vars(args), f, indent=2, default=str)
        _train_loop(args, state, step_fn, loader, trackers, device, dtype, tokenizer,
                    transport_dtype, device_cache, transport_exempt)
        log_to_trackers(trackers, {"device_memory": device_memory_stats()}, state.step)
    finally:
        for t in trackers:
            if isinstance(t, JsonlTracker):
                t.close()
    logger.info("Done at step %d", state.step)
    return state


def _train_loop(args, state, step_fn, loader, trackers, device, dtype, tokenizer,
                transport_dtype, device_cache, transport_exempt=()):
    on_card = device.type == "cuda"
    generator = torch.Generator(device).manual_seed(args.seed or 0)
    custom_steps = set(args.custom_checkpoints or [])
    async_saver = ckpt.AsyncCheckpointer() if args.async_save else None
    nan_steps = 0
    step = first_step = state.step
    last_saved = None
    K = max(1, args.steps_per_dispatch)
    for name, cadence in (("checkpointing_steps", args.checkpointing_steps),
                          ("validation_steps", args.validation_steps),
                          ("log_every", args.log_every)):
        if cadence and K > cadence:
            logger.warning("steps_per_dispatch=%d exceeds %s=%d: the events of one dispatch "
                           "collapse into one, once per %d-step dispatch", K, name, cadence, K)
    world = multihost.rank_and_world()[1]
    global_batch = args.train_batch_size * world
    logger.info("Training on %s, batch %d (%d x %d processes), start step %d", device,
                global_batch, args.train_batch_size, world, step)

    def epochs():
        # one batch stream across epochs (shuffle and item-RNG epoch advance
        # inside loader.__iter__), bounded at the batches the loop consumes,
        # so the prefetch producer ends with the loop
        remaining = args.max_train_steps - first_step
        while remaining > 0:
            for b in iter(loader):
                yield b
                remaining -= 1
                if remaining <= 0:
                    return

    def save(sync: bool, keep) -> None:
        nonlocal last_saved
        t0 = time.time()
        if async_saver is not None and not sync:
            async_saver.wait()                # the previous write, if still running
            t1 = time.time()
            async_saver.save(args.output_dir, step, state,
                             total_limit=args.checkpoints_total_limit, keep=keep)
            log_to_trackers(trackers, {"checkpoint_async_wait_s": t1 - t0,
                                       "checkpoint_async_snapshot_s": time.time() - t1}, step)
        else:
            path = ckpt.save_state(args.output_dir, step, state,
                                   total_limit=args.checkpoints_total_limit if not sync
                                   else None, keep=keep)
            log_to_trackers(trackers, {"checkpoint_s": time.time() - t0,
                                       "checkpoint_gb": _dir_gb(path)}, step)
            logger.info("Saved %s", path)
        last_saved = step

    h2d_events = [] if on_card else None
    stream = prefetch_to_device(epochs(), device, group=K, transport_dtype=transport_dtype,
                                transport_exempt=transport_exempt, h2d_events=h2d_events)
    t_window, window_start = time.time(), step
    t_ready = time.perf_counter()
    try:
        for batch in stream:
            t_batch = time.perf_counter()
            k = min(next(iter(batch.values())).shape[0] if K > 1 else 1,
                    args.max_train_steps - step)
            metrics = []
            for i in range(k):
                b = {key: v[i] for key, v in batch.items()} if K > 1 else batch
                if device_cache is not None:
                    b = resolve_device_cache(b, device_cache)
                state, m = step_fn(state, b, generator)
                metrics.append(m)
            t_done = time.perf_counter()
            prev, step = step, step + k
            window = range(prev + 1, step + 1)
            h2d_ms = None
            if h2d_events:
                start, end = h2d_events.pop(0)
                h2d_ms = start.elapsed_time(end) if end.query() else None
            wait_s, dispatch_s = t_batch - t_ready, t_done - t_batch
            timing = {"data_wait_s": wait_s, "dispatch_s": dispatch_s,
                      "s_per_step": (wait_s + dispatch_s) / k,
                      "samples_per_s": global_batch * k / (wait_s + dispatch_s),
                      "steps_in_dispatch": k}
            if h2d_ms is not None:
                timing["h2d_ms"] = h2d_ms

            logged = [s for s in window if s % args.log_every == 0]
            if logged:
                sps = (step - window_start) / (time.time() - t_window)
                t_window, window_start = time.time(), step
            for s in logged:
                m = metrics[s - prev - 1]
                loss = float(m["loss"])
                log_to_trackers(trackers, {"loss": loss, "grad_norm": float(m["grad_norm"]),
                                           "steps_per_sec": round(sps, 3), **timing}, s)
                # a non-finite loss poisons nothing (the step skips its
                # update) but training on is pointless: stop, with a usable
                # last checkpoint
                if not np.isfinite(loss):
                    nan_steps += 1
                    logger.error("non-finite loss %s at step %d (%d/%d)", loss, s, nan_steps,
                                 args.max_nonfinite_steps)
                    if nan_steps >= args.max_nonfinite_steps:
                        if async_saver is not None:
                            async_saver.wait()
                        ckpt.save_state(args.output_dir, step, state, total_limit=None,
                                        keep=custom_steps)
                        raise FloatingPointError(
                            f"loss non-finite for {nan_steps} consecutive logged steps; "
                            f"aborting at step {step}")
                else:
                    nan_steps = 0

            rounded_custom = custom_steps.intersection(window) - {step}
            if any(s % args.checkpointing_steps == 0 for s in window) \
                    or custom_steps.intersection(window):
                # with K > 1 the save lands on the dispatch boundary; a custom
                # step rounded to it keeps its pin through the boundary step
                if rounded_custom:
                    logger.warning("custom checkpoint step(s) %s rounded to dispatch boundary "
                                   "%d (steps_per_dispatch=%d); checkpoint-%d is pinned in "
                                   "their place", sorted(rounded_custom), step, K, step)
                save(False, custom_steps | ({step} if rounded_custom else set()))

            if args.validation_steps and any(s % args.validation_steps == 0 for s in window) \
                    and multihost.is_main_process():
                run_validation(args, state, tokenizer, trackers, step, dtype, device)
            if step >= args.max_train_steps:
                break
            t_ready = time.perf_counter()
    finally:
        stream.close()
    if async_saver is not None:
        async_saver.wait()      # surface a background write error before exit
        for path, seconds in async_saver.written.items():
            log_to_trackers(trackers, {"checkpoint_async_write_s": seconds,
                                       "checkpoint_gb": _dir_gb(path) if os.path.isdir(path)
                                       else "pruned"},
                            int(path.rsplit("-", 1)[1]))
    if last_saved != step:      # the final checkpoint, written synchronously
        save(True, custom_steps)


def run_validation(args, state, tokenizer, trackers, step, dtype, device):
    """log_validation (reference :91-294): the port's pipeline over the live
    modules (no weight copy; eval mode, inference_mode, autocast in the
    training dtype), `--num_inference_steps` UniPC steps for each of
    `--num_images_per_validation` seeds per validation row; logs best-of-seed
    PSNR/SSIM (and LPIPS with `--lpips_weights`) and writes a score-stamped
    grid sheet per row.  The depth and normals planes go in as in the JAX
    CLI (:731-744); `--summarizer` shortens the prompts first."""
    import h5py
    from PIL import Image, ImageDraw

    from reflecting_reality_tpu_torch.data.synmirror import (
        apply_transforms_depth, apply_transforms_normals, extract_data_from_hdf5,
        normals_to_uint8, read_rows,
    )
    from reflecting_reality_tpu_torch.metrics.functional import psnr_ssim
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    modules = list(state.trainable.values()) + list(state.frozen.values())
    was_training = [m.training for m in modules]
    pipe = StableDiffusionBrushNetPipeline(
        vae=state.frozen["vae"], text_encoder=state.frozen["text"], tokenizer=tokenizer,
        unet=state.trainable.get("unet", state.frozen.get("unet")),
        brushnet=state.trainable["brushnet"],
        depth_conditioning_mode=args.depth_conditioning_mode,
        normals_conditioning_mode=args.normals_conditioning_mode,
        normal_proj=state.trainable.get("normal_proj"),
        dtype=dtype, device=device, cast_modules=False)
    rows = read_rows(os.path.join(args.train_data_dir, args.test_csv))
    if args.validation_csv_indices:
        rows = [rows[i] for i in args.validation_csv_indices]
    else:
        rows = rows[:args.num_validation_images]

    summarize = None
    if args.summarizer:
        # validation-prompt summarization (reference :948-951,213-214)
        from reflecting_reality_tpu_torch.tools.summarize_captions import summarize_fn

        summarize = summarize_fn(args.summarizer)

    # validation LPIPS (reference log_validation logs PSNR/SSIM/LPIPS,
    # train_brushnet_mirror.py:238), when an --lpips_weights file is given
    lpips_calc = None
    if args.lpips_weights:
        from reflecting_reality_tpu_torch.metrics.calculator import MetricsCalculator

        lpips_calc = MetricsCalculator([], lpips_weights=args.lpips_weights, device=device)

    def stamp(img_arr, psnr, ssim, lpips=None):
        im = Image.fromarray(img_arr)
        draw = ImageDraw.Draw(im)
        draw.rectangle([0, 0, im.width, 12], fill=(0, 0, 0))
        text = f"PSNR {psnr:.2f}  SSIM {ssim:.3f}"
        if lpips is not None:
            text += f"  LPIPS {lpips:.3f}"
        draw.text((2, 1), text, fill=(255, 255, 0))
        return im

    val_dir = os.path.join(args.output_dir, "validation", f"step-{step}")
    os.makedirs(val_dir, exist_ok=True)
    best_psnrs, best_ssims, best_lpips = [], [], []
    try:
        for row in rows:
            try:
                with h5py.File(os.path.join(args.train_data_dir, str(row["path"])), "r") as f:
                    data = extract_data_from_hdf5(f)
            except (OSError, KeyError) as e:
                logger.warning("validation sample %s unreadable: %s", row.get("path"), e)
                continue
            depth = None
            if args.depth_conditioning_mode is not None:
                depth = apply_transforms_depth(data["depth"], data["mask"],
                                               resolution=args.resolution)
            normals = None
            if args.normals_conditioning_mode in ("concat", "latents"):
                # the raw normals image; the pipeline preprocesses it
                # (reference get_hdf5_data :131-132)
                normals = Image.fromarray(normals_to_uint8(data["normals"]), mode="RGB")
            elif args.normals_conditioning_mode == "ip_adapter":
                # the (1, 3) unit mean mirror normal (JAX :746-750)
                normals = apply_transforms_normals(data["normals"], mask=data["mask"],
                                                   normals_conditioning_mode="ip_adapter")
            prompt = args.mirror_prompt + str(row[args.caption_column])
            if summarize is not None:
                prompt = summarize(prompt)
            scores = []
            for k in range(args.num_images_per_validation):
                out = pipe(prompt, Image.fromarray(data["masked_image"]),
                           Image.fromarray(data["mask"]).convert("RGB"), depth=depth,
                           normals=normals, height=args.resolution, width=args.resolution,
                           num_inference_steps=args.num_inference_steps, guidance_scale=7.5,
                           seed=k, brushnet_conditioning_scale=args.brushnet_conditioning_scale,
                           )[0]
                p, s = psnr_ssim(out.astype(np.float32), data["image"].astype(np.float32),
                                 device=device)
                lp = None
                if lpips_calc is not None:
                    lp = lpips_calc.calculate_lpips(
                        out.astype(np.float32) / 127.5 - 1.0,
                        data["image"].astype(np.float32) / 127.5 - 1.0)
                scores.append((p, s, lp, out))
            stamped = [stamp(o, p, s, lp) for p, s, lp, o in scores]
            cols = max(1, len(stamped) // 2)
            w, h = stamped[0].size
            grid = Image.new("RGB", (cols * w, 2 * h))
            for k, im in enumerate(stamped):
                grid.paste(im, (k % cols * w, k // cols * h))
            grid.save(os.path.join(val_dir, f"{row['uid']}.png"))
            best = max(scores, key=lambda x: x[1])
            best_psnrs.append(best[0])
            best_ssims.append(best[1])
            if best[2] is not None:
                best_lpips.append(best[2])
    finally:
        for m, training in zip(modules, was_training):
            m.train(training)
    if not best_psnrs:
        logger.warning("validation produced no samples at step %d", step)
        return
    scalars = {"val/psnr": float(np.mean(best_psnrs)), "val/ssim": float(np.mean(best_ssims))}
    if best_lpips:
        scalars["val/lpips"] = float(np.mean(best_lpips))
    log_to_trackers(trackers, scalars, step)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MirrorFusion training (PyTorch port)")
    # model
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True)
    p.add_argument("--brushnet_model_name_or_path", type=str, default=None)
    p.add_argument("--revision", type=str, default=None)
    p.add_argument("--variant", type=str, default=None)
    p.add_argument("--tokenizer_name", type=str, default=None)
    p.add_argument("--summarizer", type=str, default=None,
                   help="summarization model for long validation prompts, "
                        "e.g. sshleifer/distilbart-cnn-6-6 (reference :395-398); word "
                        "truncation where transformers cannot build it")
    # io
    p.add_argument("--output_dir", type=str, default="runs/brushnet-model")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--report_to", type=str, default="wandb")
    p.add_argument("--tracker_project_name", type=str, default="train_brushnet_mirror")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="upload this many batches as one stacked (K, batch, ...) transfer "
                        "and run K optimizer steps on it; checkpoints, validation and "
                        "logging land on the K-step boundaries. The RNG/step stream is "
                        "the same as K=1")
    p.add_argument("--attention_backend", type=str, default="flash", choices=["flash", "xla"],
                   help="attention: 'flash' (kernels B1/B3/B4 for every attention on the "
                        "card whose head dim they take; wider heads and the CPU take "
                        "the plain path) or 'xla' (the plain einsum-softmax path everywhere, "
                        "differentiated by torch autograd)")
    p.add_argument("--serialize_dispatch", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="accepted for launch-script compatibility; the port's step waits "
                        "on the host for its loss and gradient norm every step, so steps "
                        "never overlap whatever the value")
    p.add_argument("--input_transport_dtype", type=str, default="auto",
                   choices=["auto", "fp32", "bf16"],
                   help="host->card dtype of float batch arrays: the loader casts on the "
                        "host before the pinned upload. 'auto' = bf16 under "
                        "--mixed_precision bf16 (the step casts every float input to bf16 "
                        "anyway), halving the upload")
    p.add_argument("--precomputed_latents_dir", type=str, default=None,
                   help="VAE-moments cache from tools/precompute_latents.py; training "
                        "draws from the cached moments instead of encoding pixels")
    p.add_argument("--device_cache", action="store_true",
                   help="with --precomputed_latents_dir: upload the whole moments cache to "
                        "the card once and gather batches by index there; per step only "
                        "the index and input_ids cross (cap RR_DEVICE_CACHE_MAX_GB, "
                        "default 4)")
    p.add_argument("--max_nonfinite_steps", type=int, default=3,
                   help="abort (after a final checkpoint) once the loss is non-finite for "
                        "this many consecutive logged steps")
    # training
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--compilation_cache_dir", type=str, default=None,
                   help="build and load the kernel libraries (nvcc's lib<name>-<hash>.so, "
                        "keyed by their sources) here instead of the package's _build "
                        "directories")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=20000)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--async_save", action="store_true",
                   help="write periodic checkpoints from a background thread (pinned "
                        "host snapshot first); the final checkpoint still saves "
                        "synchronously")
    p.add_argument("--custom_checkpoints", type=int, nargs="+", default=None)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--gradient_checkpointing_policy", type=str, default="full",
                   choices=["full", "dots"],
                   help="full = recompute whole branch forwards (reference semantics); "
                        "dots = save the outputs of matrix products and convolutions, "
                        "recompute the rest")
    p.add_argument("--learning_rate", type=float, default=5e-6)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--lr_num_cycles", type=int, default=1)
    p.add_argument("--lr_power", type=float, default=1.0)
    p.add_argument("--dataloader_num_workers", type=int, default=0)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-08)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--mixed_precision", type=str, default="no",
                   choices=["no", "fp16", "bf16"])
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--ema_dtype", type=str, default="fp32", choices=["fp32", "bf16"],
                   help="EMA shadow-weight storage; bf16 halves the copy")
    p.add_argument("--set_grads_to_none", action="store_true",
                   help="accepted for reference-CLI compatibility; the port's step always "
                        "sets gradients to None after an update")
    p.add_argument("--enable_xformers_memory_efficient_attention", action="store_true",
                   help="accepted for reference-CLI compatibility; a no-op (attention "
                        "runs kernel B1)")
    # data
    p.add_argument("--dataset_name", type=str, default=None)
    p.add_argument("--dataset_config_name", type=str, default=None)
    p.add_argument("--train_data_dir", type=str, required=True)
    p.add_argument("--dataset_type", type=str, default="synmirror", choices=["synmirror", "msd"])
    p.add_argument("--train_csv", type=str, default="train.csv")
    p.add_argument("--test_csv", type=str, default="test.csv")
    p.add_argument("--caption_column", type=str, default="auto_caption")
    p.add_argument("--mirror_prompt", type=str, default="A perfect plane mirror reflection of ")
    p.add_argument("--image_column", type=str, default="image")
    p.add_argument("--conditioning_image_column", type=str, default="conditioning_image")
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--proportion_empty_prompts", type=float, default=0.2)
    p.add_argument("--random_flip", action="store_true")
    p.add_argument("--hint_map_dir", type=str, default=None)
    p.add_argument("--cam_states", action="store_true")
    # conditioning
    p.add_argument("--depth_conditioning_mode", type=str, default=None,
                   choices=[None, "concat", "latents"])
    p.add_argument("--normals_conditioning_mode", type=str, default=None,
                   choices=[None, "concat", "latents", "ip_adapter"])
    p.add_argument("--ip_adapter_scale", type=float, default=1.0)
    p.add_argument("--train_base_unet", action="store_true")
    # validation
    p.add_argument("--num_validation_images", type=int, default=4)
    p.add_argument("--validation_csv_indices", type=int, nargs="+", default=None)
    p.add_argument("--num_images_per_validation", type=int, default=4)
    p.add_argument("--brushnet_conditioning_scale", type=float, default=1.0)
    p.add_argument("--num_inference_steps", type=int, default=20)
    p.add_argument("--validation_steps", type=int, default=1000)
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="validation LPIPS-squeeze weights: the .npz of the JAX package's "
                        "tools/convert_lpips.py, or a torch checkpoint")
    # the port
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu' (the plain "
                        "PyTorch paths)")
    return p


if __name__ == "__main__":
    main()
