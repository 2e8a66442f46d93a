"""SD-inpainting baseline training CLI, the port's counterpart of
`reflecting_reality_tpu/cli/train_baseline.py` (reference:
baseline/sd_inpainting/train_sdinpainting.py).

The flag surface is the training CLI's (`cli.train.build_parser`); the
baseline reads the SynMirror/MSD dataset flags, the optimizer and schedule
flags, `--mixed_precision`, the conditioning modes, logging and
checkpointing, and ignores the BrushNet-only ones, as in JAX.  It loads the
base UNet, inflates conv_in to `baseline_in_channels` inputs (the first
min(old, 9) copied, the rest zero), trains the whole UNet with the VAE and
text encoder frozen, and writes `checkpoint-N/unet` (config.json +
safetensors) every `--checkpointing_steps` and at the end.

`--mixed_precision bf16` computes in bf16 under autocast with every weight
kept as stored, fp32 from the base folder: the JAX CLI's `dtype=` sets its
modules' compute dtype and leaves the parameters as loaded.  `--device`
(default `cuda`, raising without a card; `cpu` runs the plain PyTorch
paths).  The JAX CLI replicates over a device mesh; this one is
data-parallel under torchrun as `cli.train` is (`torchrun --nproc_per_node N
-m reflecting_reality_tpu_torch.cli.train_baseline ...`): a global batch of
`--train_batch_size` x N, the loader striding by rank, gradients averaged
across the ranks, `--scale_lr` by N, and logs and checkpoints from rank 0.
"""

from __future__ import annotations

import json
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)


def load_inflated_unet(base: str, in_channels: int):
    """The base folder's UNet with conv_in widened to `in_channels`."""
    from reflecting_reality_tpu_torch.baseline.sd_inpainting import inflate_conv_in
    from reflecting_reality_tpu_torch.core.io import empty_module, load_into, load_pretrained
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel

    unet = load_pretrained(UNet2DConditionModel, base, subfolder="unet")
    old_in = unet.conv_in.weight.shape[1]
    if old_in == in_channels:
        return unet
    state = unet.state_dict()
    state["conv_in.weight"] = inflate_conv_in(state["conv_in.weight"], in_channels,
                                              preserve=min(old_in, 9))
    module = empty_module(UNet2DConditionModel, unet.to_config(), in_channels=in_channels)
    return load_into(module, state, where=f"{base}/unet (inflated)")


def main(argv=None):
    from reflecting_reality_tpu_torch.baseline.sd_inpainting import (
        baseline_in_channels, make_baseline_train_step,
    )
    from reflecting_reality_tpu_torch.cli.train import (
        JsonlTracker, build_parser, log_to_trackers, make_trackers,
    )
    from reflecting_reality_tpu_torch.core.device import resolve_device
    from reflecting_reality_tpu_torch.core.io import load_pretrained, save_pretrained
    from reflecting_reality_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from reflecting_reality_tpu_torch.data.synmirror import HDF5Dataset, MSDDataset, read_rows
    from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer
    from reflecting_reality_tpu_torch.models.clip_text import load_text_encoder
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.parallel import multihost
    from reflecting_reality_tpu_torch.training.train_step import TrainConfig

    parser = build_parser()
    parser.description = "SD-inpainting baseline training (PyTorch port)"
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    multihost.initialize(device=args.device)
    rank, world = multihost.rank_and_world()
    device = resolve_device(multihost.local_device(args.device))
    dtype = {"no": torch.float32, "fp16": torch.float32, "bf16": torch.bfloat16}[
        args.mixed_precision]
    base = args.pretrained_model_name_or_path

    unet = load_inflated_unet(base, baseline_in_channels(args.depth_conditioning_mode,
                                                         args.normals_conditioning_mode))
    vae = load_pretrained(AutoencoderKL, base, subfolder="vae")
    text = load_text_encoder(base)
    tokenizer = CLIPTokenizer.from_pretrained(base, subfolder="tokenizer")

    rows = read_rows(os.path.join(args.train_data_dir, args.train_csv), args.max_train_samples)
    ds_cls = {"synmirror": HDF5Dataset, "msd": MSDDataset}[args.dataset_type]
    dataset = ds_cls(
        args.train_data_dir, rows, tokenizer, resolution=args.resolution,
        proportion_empty_prompts=args.proportion_empty_prompts,
        mirror_prompt=args.mirror_prompt, caption_column=args.caption_column,
        random_flip=args.random_flip, seed=args.seed,
        depth=args.depth_conditioning_mode is not None,
        normals_conditioning_mode=args.normals_conditioning_mode or False,
    )
    loader = DataLoader(dataset, args.train_batch_size * world, shuffle=True,
                        num_workers=args.dataloader_num_workers or 8, seed=args.seed or 0,
                        process_index=rank, process_count=world)
    if len(loader) == 0:
        raise ValueError("dataset smaller than the batch")

    config = TrainConfig(
        learning_rate=args.learning_rate, scale_lr=args.scale_lr,
        lr_scheduler=args.lr_scheduler, lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=args.max_train_steps,
        adam_weight_decay=args.adam_weight_decay, adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm, snr_gamma=args.snr_gamma,
        depth_conditioning_mode=args.depth_conditioning_mode,
        normals_conditioning_mode=args.normals_conditioning_mode,
    )
    step_fn, init_state = make_baseline_train_step(unet, vae, text, config, dtype=dtype,
                                                   device=device)
    state = init_state()

    trackers = make_trackers(args)
    os.makedirs(args.output_dir, exist_ok=True)
    if rank == 0:
        with open(os.path.join(args.output_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=2, default=str)

    generator = torch.Generator(device).manual_seed(args.seed or 0)
    step = 0
    t0 = time.time()
    try:
        while step < args.max_train_steps:
            stream = prefetch_to_device(iter(loader), device)
            try:
                for batch in stream:
                    state, metrics = step_fn(state, batch, generator)
                    step += 1
                    if step % args.log_every == 0:
                        log_to_trackers(trackers, {
                            "loss": float(metrics["loss"]),
                            "steps_per_sec": round(args.log_every / (time.time() - t0), 3),
                        }, step)
                        t0 = time.time()
                    if step % args.checkpointing_steps == 0 or step >= args.max_train_steps:
                        path = os.path.join(args.output_dir, f"checkpoint-{step}", "unet")
                        if rank == 0:
                            save_pretrained(unet, path)
                            logger.info("Saved %s", path)
                        multihost.barrier(f"checkpoint-{step}")
                    if step >= args.max_train_steps:
                        break
            finally:
                stream.close()
    finally:
        for t in trackers:
            if isinstance(t, JsonlTracker):
                t.close()
    logger.info("Done at step %d", step)
    return state


if __name__ == "__main__":
    main()
