"""Precompute VAE encoder moments for SynMirror training, the port's
counterpart of `reflecting_reality_tpu/tools/precompute_latents.py`.

The encoder is frozen, so each sample's posterior never changes; only the
draw does.  This tool encodes the dataset once with the port's VAE (on the
card unless `--device cpu`) and stores the DiagonalGaussian moments (mean ‖
logvar); training then draws from them every step (`latent_moments` batch
keys in `training/train_step.assemble_conditioning_latents`).

Per sample, `<uid>_<stem>.npz` (or `<row index>.npz`, `data.latent_cache.
cache_name`) holds the keys of the JAX tool:
  latent_moments        (hl, wl, 8) VAE moments of pixel_values
  cond_latent_moments   (hl, wl, 8) VAE moments of the masked image
  masks                 (hl, wl, 1) the mirror mask, nearest-resized to latents
  depths                (hl, wl, 1) in depth `concat` mode
  depth_latent_moments / normals_latent_moments / normals  per mode

Captions are not cached (tokenisation and the empty-prompt dropout stay at
train time).  random_flip must be off.

Usage:
  python -m reflecting_reality_tpu_torch.tools.precompute_latents \\
    --pretrained_model_name_or_path <sd15> --train_data_dir <dir> \\
    --output_dir <cache_dir> [--resolution 512] [--batch_size 8] \\
    [--depth_conditioning_mode concat] [--save_dtype float16] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def nearest_resize_hw(x: np.ndarray, hl: int, wl: int) -> np.ndarray:
    """numpy twin of `training.train_step.nearest_resize` for one HWC map."""
    h, w = x.shape[:2]
    ri = (np.arange(hl) * h // hl).astype(np.int64)
    ci = (np.arange(wl) * w // wl).astype(np.int64)
    return x[ri][:, ci]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True)
    p.add_argument("--train_data_dir", type=str, required=True)
    p.add_argument("--train_csv", type=str, default="train.csv")
    p.add_argument("--caption_column", type=str, default="auto_caption")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--depth_conditioning_mode", type=str, default="concat",
                   choices=[None, "concat", "latents"])
    p.add_argument("--normals_conditioning_mode", type=str, default=None,
                   choices=[None, "concat", "latents", "ip_adapter"])
    p.add_argument("--save_dtype", type=str, default="float32", choices=["float32", "float16"],
                   help="moments storage dtype (float16 halves the disk)")
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the VAE encodes: 'cuda' (default; raises without a card) "
                        "or 'cpu'")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from reflecting_reality_tpu_torch.core.device import resolve_device
    from reflecting_reality_tpu_torch.core.io import load_pretrained
    from reflecting_reality_tpu_torch.data.latent_cache import cache_name
    from reflecting_reality_tpu_torch.data.loader import DataLoader
    from reflecting_reality_tpu_torch.data.synmirror import HDF5Dataset, read_rows
    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    device = resolve_device(args.device)
    vae = load_pretrained(AutoencoderKL, args.pretrained_model_name_or_path,
                          subfolder="vae").to(device).eval()
    rows = read_rows(os.path.join(args.train_data_dir, args.train_csv))
    # captions are not cached; the hash tokenizer lets the dataset run
    # without vocab files
    dataset = HDF5Dataset(
        args.train_data_dir, rows, HashTokenizer(),
        resolution=args.resolution, proportion_empty_prompts=0.0,
        caption_column=args.caption_column, random_flip=False,
        depth=args.depth_conditioning_mode is not None,
        normals_conditioning_mode=args.normals_conditioning_mode or False,
    )
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=False,
                        drop_last=False, num_workers=4)

    @torch.inference_mode()
    def moments_of(img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(img).to(device).permute(0, 3, 1, 2)
        d = vae.encode(x)
        return torch.cat([d.mean, d.logvar], dim=1).permute(0, 2, 3, 1).float().cpu().numpy()

    os.makedirs(args.output_dir, exist_ok=True)
    save_dtype = np.dtype(args.save_dtype)
    vs = 2 ** (len(vae.block_out_channels) - 1)
    hl = wl = args.resolution // vs
    idx = 0
    for batch in loader:
        b = batch["pixel_values"].shape[0]
        names = [cache_name(rows[idx + j], idx + j) for j in range(b)]
        if args.skip_existing and all(
                os.path.exists(os.path.join(args.output_dir, n)) for n in names):
            idx += b
            continue
        lat = moments_of(batch["pixel_values"])
        cond = moments_of(batch["conditioning_pixel_values"])
        extras = {}
        if args.depth_conditioning_mode == "latents":
            extras["depth_latent_moments"] = moments_of(np.repeat(batch["depths"], 3, axis=-1))
        if args.normals_conditioning_mode == "latents":
            extras["normals_latent_moments"] = moments_of(batch["normals"])
        for j, name in enumerate(names):
            sample = {
                "latent_moments": lat[j].astype(save_dtype),
                "cond_latent_moments": cond[j].astype(save_dtype),
                # nearest-resized to latents: the identity under the step's resize
                "masks": nearest_resize_hw(batch["masks"][j], hl, wl).astype(np.float32),
            }
            if args.depth_conditioning_mode == "concat":
                sample["depths"] = nearest_resize_hw(batch["depths"][j], hl, wl).astype(np.float32)
            elif args.depth_conditioning_mode == "latents":
                sample["depth_latent_moments"] = extras["depth_latent_moments"][j].astype(save_dtype)
            if args.normals_conditioning_mode == "concat":
                sample["normals"] = nearest_resize_hw(batch["normals"][j], hl, wl).astype(np.float32)
            elif args.normals_conditioning_mode == "latents":
                sample["normals_latent_moments"] = (
                    extras["normals_latent_moments"][j].astype(save_dtype))
            elif args.normals_conditioning_mode == "ip_adapter":
                sample["normals"] = np.asarray(batch["normals"][j], np.float32)
            np.savez(os.path.join(args.output_dir, name), **sample)
        idx += b
        if idx % (args.batch_size * 20) == 0:
            logger.info("encoded %d / %d samples", idx, len(dataset))
    logger.info("done: %d samples -> %s", idx, args.output_dir)


if __name__ == "__main__":
    main()
