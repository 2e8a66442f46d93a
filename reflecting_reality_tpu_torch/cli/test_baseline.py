"""SD-inpainting baseline inference CLI, the port's counterpart of
`reflecting_reality_tpu/cli/test_baseline.py` (reference:
baseline/sd_inpainting/test_sdinpainting.py).

The inference CLI's flag surface and its shared drive (`cli.test.drive_rows`:
HDF5/MSD rows, predicted-geometry sources, `--blended`, skip-existing
restart, 2xN sheets), driving `SDInpaintingPipeline` on the 9(+)-channel
UNet, so the baseline's sheets go through the same metrics downstream.
`--brushnet_path` names the UNet (a `checkpoint-N` folder or its `unet/`);
with `--all_ckpt` it is the run's root and every `checkpoint-N` is swept
(`--ckpt_modulo` keeps every N-th step).  Flags of the BrushNet tester that
the baseline does not read are ignored, as in JAX (`--attention_backend`
among them); `--compilation_cache_dir` is read (`core/jit_cache.py`).
`--device` defaults to `cuda` (raising without a card; `cpu` runs the plain
PyTorch paths).
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)


def run_inference(args, unet_path: str, output_dir: str, test_df) -> None:
    import torch

    from reflecting_reality_tpu_torch.baseline.sd_inpainting import SDInpaintingPipeline
    from reflecting_reality_tpu_torch.cli.test import drive_rows, fetch, fetched_images
    from reflecting_reality_tpu_torch.core.io import load_pretrained
    from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer
    from reflecting_reality_tpu_torch.models.clip_text import load_text_encoder
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    dtype = {"fp32": torch.float32, "fp16": torch.float32, "bf16": torch.bfloat16}[
        args.weight_dtype]
    pipe = SDInpaintingPipeline(
        vae=load_pretrained(AutoencoderKL, args.base_model_path, subfolder="vae"),
        text_encoder=load_text_encoder(args.base_model_path),
        tokenizer=CLIPTokenizer.from_pretrained(args.base_model_path, subfolder="tokenizer"),
        unet=load_pretrained(UNet2DConditionModel, unet_path),
        depth_conditioning_mode=args.depth_conditioning_mode,
        normals_conditioning_mode=args.normals_conditioning_mode,
        dtype=dtype, device=args.device,
    )

    def generate(prompt, validation_image, validation_mask, depth_image, normal_image):
        # uint8 images left on the card, their copy queued: drive_rows
        # writes the previous row's sheet while the card denoises this one
        return [fetch(pipe(prompt, validation_image, validation_mask, depth=depth_image,
                           normals=normal_image, height=args.resolution,
                           width=args.resolution, num_inference_steps=args.num_inference_steps,
                           guidance_scale=args.CFG, seed=args.seed + k, output_type="device"))
                for k in range(args.num_images_per_validation)]

    drive_rows(args, test_df, output_dir, generate,
               lambda handles: fetched_images(pipe.image_processor, handles))


def _resolve_unet(path: str) -> str:
    return os.path.join(path, "unet") if os.path.isdir(os.path.join(path, "unet")) else path


def main(argv=None):
    import pandas as pd

    from reflecting_reality_tpu_torch.cli.test import build_parser
    from reflecting_reality_tpu_torch.core.device import resolve_device
    from reflecting_reality_tpu_torch.core.jit_cache import enable_compilation_cache

    parser = build_parser()
    parser.description = "SD-inpainting baseline inference (PyTorch port)"
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    enable_compilation_cache(args.compilation_cache_dir)
    resolve_device(args.device)     # fail before reading anything

    test_df = pd.read_csv(os.path.join(args.train_data_dir, args.csv))
    if args.infer_list:
        with open(args.infer_list) as f:
            infer_list = [x.strip() for x in f.readlines()]
        test_df = test_df[test_df["path"].isin(infer_list)]
    if not args.infer_list and args.num_samples:
        test_df = test_df.sample(args.num_samples, random_state=args.seed)

    root = args.brushnet_path  # the flag is reused (reference --unet_path)
    if args.all_ckpt:
        from reflecting_reality_tpu_torch.training.checkpoint import checkpoint_steps

        for step in checkpoint_steps(root):
            if args.ckpt_modulo and step % args.ckpt_modulo != 0:
                continue
            ckpt = os.path.join(root, f"checkpoint-{step}")
            run_inference(args, _resolve_unet(ckpt),
                          args.output_dir or os.path.join(ckpt, "inference"), test_df)
    else:
        unet_path = _resolve_unet(root)
        run_inference(args, unet_path,
                      args.output_dir or os.path.join(os.path.dirname(unet_path), "inference"),
                      test_df)


if __name__ == "__main__":
    main()
