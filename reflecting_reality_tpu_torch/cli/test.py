"""MirrorFusion inference CLI, the port's counterpart of
`reflecting_reality_tpu/cli/test.py` (reference:
examples/brushnet/test_brushnet.py).

It reads test.csv, loads the MirrorFusion checkpoint(s) into the port's
pipeline, generates `--num_images_per_validation` seeds per sample and
writes 2xN grid sheets named uid_cam.png (uid.png under `--image_mode`),
with `--all_ckpt` sweeps, `--ckpt_modulo`, predicted-geometry sources
(marigold / depth_pro / geowizard), `--blended` paste-back, MSD
`--image_mode`, skip-existing restart, `--use_ema`, `--batch_seeds` and
`--summarizer`.  Every flag name and default of the JAX parser is kept, so
reference launch scripts parse; `--device` is added (default `cuda`,
raising without a card; `cpu` runs the plain PyTorch paths).

`drive_rows` keeps JAX's one-deep overlap: a row's pipeline call returns
its uint8 images still on the card (`output_type="device"`) with their copy
to pinned host memory queued right behind them, and the previous row's
fetch, PIL conversion and PNG writes run while the card denoises this row.
`h5py` is imported only where an HDF5 sample is read, so `--image_mode`
runs without it.

Normals `ip_adapter` mode reads the checkpoint's `ip_adapter/` beside its
`brushnet/` and takes `--ip_adapter_scale`; `--deep_cache N` and
`--encoder_reuse N` switch the pipeline's approximate modes on, `--int8`
the W8A8 int8 mode (`--int8_all` with it: every conv and linear, JAX's
`select_all`; without `--int8` it does nothing, as in JAX).
`--data_parallel` (JAX :117-146) splits each batched-seeds call over the
visible cards (`enable_data_parallel(make_mesh())`, one replica a card; the
CPU is one device): it needs `--batch_seeds` and a seed count divisible by
the card count.  Under torchrun (`torchrun --nproc_per_node N -m
reflecting_reality_tpu_torch.cli.test ...`) each process joins the group,
takes `cuda:LOCAL_RANK` and its contiguous share of the rows
(`split_between_processes`), and `--data_parallel` then splits over that
one card.  `--attention_backend xla` puts every attention of the UNet,
BrushNet and VAE on the plain einsum-softmax path (`ops.attention.
set_attention_backend` on each module; the default `flash` sends the long
self-attentions to kernel B1 on the card).  `--compilation_cache_dir`
builds and loads the kernel libraries there (`core/jit_cache.py`).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from reflecting_reality_tpu_torch.core.device import resolve_device
from reflecting_reality_tpu_torch.core.jit_cache import enable_compilation_cache
from reflecting_reality_tpu_torch.data.synmirror import (
    MIRROR_PROMPT,
    apply_transforms_depth,
    apply_transforms_normals,
    extract_data_from_hdf5,
    normals_to_uint8,
)
from reflecting_reality_tpu_torch.ops.attention import set_attention_backend
from reflecting_reality_tpu_torch.parallel import multihost
from reflecting_reality_tpu_torch.parallel.mesh import make_mesh, split_between_processes

logger = logging.getLogger(__name__)


# -- predicted-geometry readers (reference test_brushnet.py:22-56) -----------

def read_from_marigold(geometric_data_path, uid, f_name):
    p = os.path.join(geometric_data_path, "marigold", "depth_npy", f"{uid}_{f_name}_pred.npy")
    return np.load(p) if os.path.exists(p) else None


def read_from_depth_pro(geometric_data_path, rel_path):
    p = os.path.join(geometric_data_path, "depth_pro", rel_path.replace(".hdf5", ".npz"))
    if not os.path.exists(p):
        logger.warning("File does not exist: %s", p)
        return None
    return np.load(p)["depth"]


def read_from_geowizard(geometric_data_path, uid, f_name, mode):
    sub = {"depth": "depth_npy", "normal": "normal_npy"}.get(mode)
    if sub is None:
        logger.error("Wrong mode for reading from geowizard: %s", mode)
        return None
    p = os.path.join(geometric_data_path, "geowizard", sub, f"{uid}_{f_name}_pred.npy")
    return np.load(p) if os.path.exists(p) else None


def image_grid(imgs, num_images: int):
    """2-row grid sheet of the per-seed outputs (reference :59-69)."""
    from PIL import Image

    rows = min(2, num_images)
    assert len(imgs) == num_images
    cols = -(-num_images // rows)
    w, h = imgs[0].size
    grid = Image.new("RGB", size=(cols * w, rows * h))
    for i, img in enumerate(imgs):
        grid.paste(img, box=(i % cols * w, i // cols * h))
    return grid


def get_blended_image(gt_image, gen_image, mask):
    """mask region from gen, rest from gt (reference :76-85)."""
    from PIL import Image

    gt_image = gt_image.convert("RGBA")
    gen_image = gen_image.convert("RGBA")
    mask = mask.convert("RGBA")
    blended = Image.blend(gt_image, gen_image, alpha=0.5)
    blended.paste(gen_image, (0, 0), mask)
    return blended


def data_parallel_mesh(args, device: torch.device):
    """`--data_parallel`'s mesh, the visible cards (this process's one card
    under torchrun; the CPU is one device), with JAX's checks."""
    mesh = (make_mesh(device_type=device.type) if multihost.rank_and_world()[1] == 1
            else make_mesh(devices=[device]))
    n = len(mesh)
    if not args.batch_seeds:
        raise SystemExit("--data_parallel requires --batch_seeds")
    if args.num_images_per_validation % n:
        raise SystemExit(
            f"--data_parallel: num_images_per_validation "
            f"({args.num_images_per_validation}) must be divisible by "
            f"the local device count ({n})")
    return mesh


def run_inference(args, brushnet_path: str, output_dir: str, test_df) -> None:
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    device = resolve_device(multihost.local_device(args.device))
    dtype = {"fp32": torch.float32, "fp16": torch.float32, "bf16": torch.bfloat16}[
        args.weight_dtype]
    if args.use_ema:
        # the EMA shadow weights (checkpoint-N/ema/*, written by train.py
        # --use_ema)
        d = brushnet_path.rstrip("/")
        if os.path.basename(d) == "brushnet":
            d = os.path.dirname(d)
        ema_path = os.path.join(d, "ema", "brushnet")
        if not os.path.isdir(ema_path):
            raise SystemExit(f"--use_ema: no EMA weights at {ema_path}")
        brushnet_path = ema_path
    unet_path = None
    maybe_unet = os.path.join(os.path.dirname(brushnet_path.rstrip("/")), "unet")
    if os.path.basename(brushnet_path.rstrip("/")) == "brushnet" and os.path.isdir(maybe_unet):
        unet_path = maybe_unet

    # under bf16 every module is stored in bf16, the VAE too: JAX keeps the
    # VAE's weights in fp32 but computes in bf16, the same arithmetic
    pipe = StableDiffusionBrushNetPipeline.from_pretrained(
        args.base_model_path,
        brushnet_path=brushnet_path,
        unet_path=unet_path,
        depth_conditioning_mode=args.depth_conditioning_mode,
        normals_conditioning_mode=args.normals_conditioning_mode,
        ip_adapter_scale=args.ip_adapter_scale,
        dtype=dtype,
        device=device,
    )
    for m in (pipe.unet, pipe.brushnet, pipe.vae):
        set_attention_backend(m, args.attention_backend)
    if args.deep_cache:
        pipe.enable_deep_cache(args.deep_cache)
    if args.encoder_reuse:
        pipe.enable_encoder_reuse(args.encoder_reuse)
    if args.int8:
        # W8A8 int8 (ops/quant.py): an approximation mode, not for parity evals
        from reflecting_reality_tpu_torch.ops.quant import select_all

        pipe.enable_int8(select=select_all if args.int8_all else None)
    if args.data_parallel:
        pipe.enable_data_parallel(data_parallel_mesh(args, device))
    os.makedirs(output_dir, exist_ok=True)

    common = dict(
        height=args.resolution,
        width=args.resolution,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.CFG,
        brushnet_conditioning_scale=args.brushnet_conditioning_scale,
        output_type="device",
    )

    def generate(prompt, validation_image, validation_mask, depth_image, normal_image):
        if args.batch_seeds:
            # all seeds in one batched call: each row of the batch draws its
            # own noise, not the numbers of the sequential per-seed calls
            calls = [dict(num_images_per_prompt=args.num_images_per_validation,
                          seed=args.seed)]
        else:
            calls = [dict(seed=args.seed + k) for k in range(args.num_images_per_validation)]
        return [fetch(pipe(prompt, validation_image, validation_mask, depth=depth_image,
                           normals=normal_image, **common, **call))
                for call in calls]

    drive_rows(args, test_df, output_dir, generate,
               lambda handles: fetched_images(pipe.image_processor, handles))


def fetch(images: torch.Tensor):
    """Queue uint8 device images' copy to pinned host memory right behind
    the call's work -> (host tensor, event that marks the copy done)."""
    if images.device.type != "cuda":
        return images, None
    host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
    host.copy_(images, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def fetched_images(image_processor, handles):
    """`fetch` handles -> PIL images; waits for the copies only, so the
    next row's work, already queued, keeps the card busy."""
    images = []
    for host, done in handles:
        if done is not None:
            done.synchronize()
        images += image_processor.postprocess(host.numpy(), output_type="pil")
    return images


def drive_rows(args, test_df, output_dir, generate, finalize=None) -> None:
    """The reference per-row drive (test_brushnet.py:163-266), as JAX's
    `drive_rows`: work split across processes, HDF5/MSD sample assembly,
    predicted-geometry sources, skip-existing restart, --blended paste-back
    and 2xN grid sheets.  `generate(prompt, image, mask, depth, normals) ->
    [PIL]` supplies the model.

    With `finalize`, `generate` returns a handle of queued device work and
    `finalize(handle) -> [PIL]` waits for it; the loop then runs one row
    deep: row i's fetch and grid save run while the card works on row i+1."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)

    summarize = None
    if args.summarizer:
        # long-caption summarization before CLIP (reference test_brushnet.py
        # :128-131,192-193: distilbart over the prefixed prompt)
        from reflecting_reality_tpu_torch.tools.summarize_captions import summarize_fn

        summarize = summarize_fn(args.summarizer)

    def write_out(outs, out_path, gt_image, validation_mask):
        images = []
        for out in outs:
            if args.blended:
                out = get_blended_image(gt_image, out, validation_mask.convert("L"))
            images.append(out.convert("RGB"))
        image_grid(images, args.num_images_per_validation).save(out_path)

    pending = None
    indices = split_between_processes(list(range(len(test_df))))
    for index in indices:
        row = test_df.iloc[index]
        caption = str(row[args.caption_column])
        uid = row["uid"]
        depth_image = None
        normal_image = None
        prompt = args.mirror_prompt + caption
        if summarize is not None:
            prompt = summarize(prompt)

        if args.image_mode:
            img_path = os.path.join(args.train_data_dir, "images", str(row["path"]))
            mask_path = os.path.join(args.train_data_dir, "masks", str(row["path"]))
            gt_image = Image.open(img_path)
            validation_mask = Image.open(mask_path).convert("L")
            black = Image.new("RGB", gt_image.size, "black")
            validation_image = Image.composite(black, gt_image, validation_mask)
            out_name = f"{uid}.png"
            if args.depth_conditioning_mode is not None:
                depth_path = os.path.join(
                    args.train_data_dir, "depth", str(row["path"]).replace(".png", ".npz")
                )
                depth_image = apply_transforms_depth(
                    np.load(depth_path)["depth"], np.array(validation_mask),
                    resolution=args.resolution,
                )
            validation_mask = validation_mask.convert("RGB")
        else:
            import h5py

            rel_path = str(row["path"])
            f_name = os.path.split(rel_path)[1].split(".")[0]
            out_name = f"{uid}_{f_name}.png"
            with h5py.File(os.path.join(args.train_data_dir, rel_path), "r") as f:
                data = extract_data_from_hdf5(f)
            gt_image = Image.fromarray(data["image"], mode="RGB")
            validation_image = Image.fromarray(data["masked_image"], mode="RGB")
            validation_mask = Image.fromarray(data["mask"]).convert("RGB")

            if args.depth_conditioning_mode is not None:
                if args.depth_source == "gt":
                    raw_depth = data["depth"]
                elif args.depth_source == "marigold":
                    raw_depth = read_from_marigold(args.geometric_input_data_dir, uid, f_name)
                elif args.depth_source == "depth_pro":
                    raw_depth = read_from_depth_pro(args.geometric_input_data_dir, rel_path)
                else:
                    raise ValueError(args.depth_source)
                if raw_depth is None:
                    logger.error("%s depth missing for %s_%s", args.depth_source, uid, f_name)
                    continue
                depth_image = apply_transforms_depth(
                    raw_depth, data["mask"], resolution=args.resolution
                )
            if args.normals_conditioning_mode is not None:
                if args.normal_source == "gt":
                    raw_normals = data["normals"]
                else:
                    raw_normals = read_from_geowizard(
                        args.geometric_input_data_dir, uid, f_name, mode="normal"
                    )
                    if raw_normals is None:
                        logger.error("geowizard normals missing for %s_%s", uid, f_name)
                        continue
                if args.normals_conditioning_mode == "ip_adapter":
                    # (1, 3) unit mean mirror normal, not an image
                    # (dataset.py:168-192 ip_adapter transform)
                    normal_image = apply_transforms_normals(
                        raw_normals, mask=data["mask"],
                        normals_conditioning_mode="ip_adapter",
                    )
                else:
                    normal_image = Image.fromarray(normals_to_uint8(raw_normals), mode="RGB")

        out_path = os.path.join(output_dir, out_name)
        if os.path.exists(out_path):  # idempotent restart (reference :182-185)
            continue

        outs = generate(prompt, validation_image, validation_mask, depth_image, normal_image)
        if finalize is None:
            write_out(outs, out_path, gt_image, validation_mask)
        else:
            # one-deep pipeline: queue this row, then drain the previous
            # one while the card works on this row
            if pending is not None:
                write_out(finalize(pending[0]), *pending[1:])
            pending = (outs, out_path, gt_image, validation_mask)
    if finalize is not None and pending is not None:
        write_out(finalize(pending[0]), *pending[1:])


def main(argv=None):
    import pandas as pd

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    enable_compilation_cache(args.compilation_cache_dir)
    multihost.initialize(device=args.device)
    device = resolve_device(multihost.local_device(args.device))  # fail before reading
    if args.data_parallel:
        data_parallel_mesh(args, device)

    test_df = pd.read_csv(os.path.join(args.train_data_dir, args.csv))
    if args.infer_list:
        with open(args.infer_list) as f:
            infer_list = [x.strip() for x in f.readlines()]
        test_df = test_df[test_df["path"].isin(infer_list)]
        print(f"Processing {len(test_df)} files from the list.")
    if not args.infer_list and args.num_samples:
        test_df = test_df.sample(args.num_samples, random_state=args.seed)

    if args.all_ckpt:
        # sweep every checkpoint-N under brushnet_path (reference :269-283)
        from reflecting_reality_tpu_torch.training.checkpoint import checkpoint_steps

        for step in checkpoint_steps(args.brushnet_path):
            if args.ckpt_modulo and step % args.ckpt_modulo != 0:
                continue
            ckpt = os.path.join(args.brushnet_path, f"checkpoint-{step}")
            run_inference(
                args, os.path.join(ckpt, "brushnet"),
                args.output_dir or os.path.join(ckpt, "inference"), test_df,
            )
    else:
        brushnet_path = args.brushnet_path
        if os.path.isdir(os.path.join(brushnet_path, "brushnet")):
            brushnet_path = os.path.join(brushnet_path, "brushnet")
        run_inference(
            args, brushnet_path,
            args.output_dir or os.path.join(os.path.dirname(brushnet_path), "inference"),
            test_df,
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MirrorFusion inference (PyTorch port)")
    p.add_argument("--brushnet_path", type=str, required=True)
    p.add_argument("--weight_dtype", type=str, default="fp32",
                   choices=["fp32", "fp16", "bf16"],
                   help="fp16 runs in fp32, as in the JAX package (the kernels take bf16 "
                        "and fp32)")
    p.add_argument("--base_model_path", type=str,
                   default="runwayml/stable-diffusion-v1-5")
    p.add_argument("--brushnet_conditioning_scale", type=float, default=1.0)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--CFG", type=float, default=7.5)
    p.add_argument("--mirror_prompt", type=str, default=MIRROR_PROMPT)
    p.add_argument("--summarizer", type=str, default=None,
                   help="summarization model for long prompts, e.g. "
                        "sshleifer/distilbart-cnn-6-6 (reference :298-301); word "
                        "truncation where transformers cannot build it")
    p.add_argument("--num_images_per_validation", type=int, default=4)
    p.add_argument("--data_parallel", action="store_true",
                   help="split each batched-seeds call over the visible cards (needs "
                        "--batch_seeds and a seed count divisible by the card count)")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 mode (ops/quant.py): the UNet's and BrushNet's large convs "
                        "and projections in int8 with int32 accumulation; approximate, not "
                        "for parity evals")
    p.add_argument("--int8_all", action="store_true",
                   help="with --int8: quantize every conv and linear (ops.quant.select_all) "
                        "instead of the default policy's sizes; for tiny configs, where the "
                        "default selects nothing")
    p.add_argument("--deep_cache", type=int, default=None,
                   help="DeepCache interval: full dual branch every N steps, the shallow "
                        "UNet between (approximate)")
    p.add_argument("--encoder_reuse", type=int, default=None,
                   help="encoder-reuse interval: full dual branch every N steps, the UNet's "
                        "mid block and decoder between (approximate; exclusive with "
                        "--deep_cache)")
    p.add_argument("--use_ema", action="store_true",
                   help="load the EMA shadow weights (checkpoint-N/ema/) "
                        "instead of the raw trained weights")
    p.add_argument("--batch_seeds", action="store_true",
                   help="generate all seeds in one batched pipeline call "
                        "(independent noise per row, not the numbers of the "
                        "sequential per-seed calls)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--compilation_cache_dir", type=str, default=None,
                   help="build and load the kernel libraries (nvcc's lib<name>-<hash>.so, "
                        "keyed by their sources) here instead of the package's _build "
                        "directories")
    p.add_argument("--attention_backend", type=str, default="flash",
                   choices=["flash", "xla"],
                   help="attention: 'flash' (kernel B1 for every attention on the card whose "
                        "head dim it takes; wider heads and the CPU take the plain path) or "
                        "'xla' (the plain einsum-softmax path everywhere)")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--train_data_dir", type=str, default="data/blenderproc")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--csv", type=str, default="test.csv")
    p.add_argument("--caption_column", type=str, default="auto_caption")
    p.add_argument("--blended", action="store_true")
    p.add_argument("--all_ckpt", action="store_true")
    p.add_argument("--ckpt_modulo", type=int, default=None)
    p.add_argument("--image_mode", action="store_true")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--depth_conditioning_mode", type=str, default=None,
                   choices=[None, "concat", "latents"])
    p.add_argument("--normals_conditioning_mode", type=str, default=None,
                   choices=[None, "concat", "latents", "ip_adapter"])
    p.add_argument("--ip_adapter_scale", type=float, default=1.0)
    p.add_argument("--geometric_input_data_dir", type=str, default=None)
    p.add_argument("--depth_source", type=str, default="gt",
                   choices=["gt", "marigold", "depth_pro", "geowizard"])
    p.add_argument("--normal_source", type=str, default="gt",
                   choices=["gt", "geowizard"])
    p.add_argument("--hint_map_dir", type=str, default=None)
    p.add_argument("--infer_list", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu' (the plain "
                        "PyTorch paths)")
    return p


if __name__ == "__main__":
    main()
