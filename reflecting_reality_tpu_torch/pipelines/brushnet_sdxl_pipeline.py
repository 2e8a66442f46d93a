"""StableDiffusionXLBrushNetPipeline in PyTorch (counterpart of
`reflecting_reality_tpu/pipelines/brushnet_sdxl_pipeline.py`; reference:
src/diffusers/pipelines/brushnet/pipeline_brushnet_sd_xl.py, which the
MirrorFusion scripts do not use).

What SDXL changes against the SD-1.5 pipeline it subclasses:
- two text encoders: the prompt embeds are concat(encoder 1's and encoder
  2's penultimate hidden states) (768 + 1280 = 2048 at full width), the
  pooled embeds encoder 2's projected EOS state; with no negative prompt
  both negatives are zeros (`force_zeros_for_empty_prompt`, JAX :110-116);
- micro-conditioning: `add_time_ids` = (orig_h, orig_w, crop_top,
  crop_left, target_h, target_w) in fp32, one row a model-batch row, enter
  the UNet and BrushNet with the pooled embeds through their `text_time`
  `add_embedding` (JAX :373-383);
- VAE scaling 0.13025 and 1024² images;
- the BrushNet branch runs at full CFG batch: its `text_time` term differs
  between the halves, so the base pipeline's half-batch dedup is off
  (`_brushnet_cfg_dedup`, JAX :151-154); `guess_mode` raises (JAX :127).

The conditioning latents (masked-image latents, the mask, the depth plane),
UniPC and DDIM, DeepCache, encoder reuse, VAE tiling, the sharded VAE,
`enable_data_parallel` and `enable_int8` are the base pipeline's.  The
text_time term is computed once a call (one row a sample) and added to each
step's time embedding.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from reflecting_reality_tpu_torch.schedulers.common import NoiseSchedule


def _repeat_halves(x: torch.Tensor, n: int, do_cfg: bool) -> torch.Tensor:
    """Repeat each row n times inside each CFG half, so the [negative...,
    positive...] layout holds (JAX :328-335)."""
    if n == 1:
        return x
    halves = x.chunk(2) if do_cfg else (x,)
    return torch.cat([h.repeat_interleave(n, dim=0) for h in halves])


class StableDiffusionXLBrushNetPipeline(StableDiffusionBrushNetPipeline):
    """The SDXL BrushNet pipeline over torch modules: `text_encoder` (CLIP-L,
    `CLIPTextModel`) and `text_encoder_2` (bigG, `CLIPTextModelWithProjection`)
    with their tokenizers, a `text_time` UNet and BrushNet, the VAE."""

    _MODULES = StableDiffusionBrushNetPipeline._MODULES + ("text_encoder_2",)

    def __init__(
        self,
        vae,
        text_encoder,
        text_encoder_2,
        tokenizer,
        tokenizer_2,
        unet,
        brushnet,
        schedule: Optional[NoiseSchedule] = None,
        depth_conditioning_mode: Optional[str] = None,
        normals_conditioning_mode: Optional[str] = None,
        vae_scale_factor: int = 8,
        scaling_factor: float = 0.13025,
        force_zeros_for_empty_prompt: bool = True,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device, None] = None,
        cast_modules: bool = True,
    ):
        super().__init__(
            vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, unet=unet,
            brushnet=brushnet, schedule=schedule,
            depth_conditioning_mode=depth_conditioning_mode,
            normals_conditioning_mode=normals_conditioning_mode,
            vae_scale_factor=vae_scale_factor, scaling_factor=scaling_factor, dtype=dtype,
            device=device, cast_modules=cast_modules)
        self.force_zeros_for_empty_prompt = force_zeros_for_empty_prompt
        to = (dtype,) if cast_modules else ()
        self.text_encoder_2 = text_encoder_2.to(self.device, *to).eval()
        self.tokenizer_2 = tokenizer_2

    # ----------------------------------------------------------------- text

    @torch.inference_mode()
    def encode_prompt_xl(
        self,
        prompt: Union[str, Sequence[str]],
        negative_prompt: Union[str, Sequence[str], None] = None,
        do_classifier_free_guidance: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (prompt embeds (2B, T, 2048), pooled (2B, 1280)), CFG layout
        [negative..., positive...] (B rows each without CFG)."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        if negative_prompt is None:
            negatives = [""] * len(prompts)
        elif isinstance(negative_prompt, str):
            negatives = [negative_prompt] * len(prompts)
        else:
            negatives = list(negative_prompt)

        def encode(texts):
            # device-side memo beside the base pipeline's: repeated prompts
            # skip both tokenizers and both encoders
            key = ("xl", tuple(texts))
            out = self._prompt_cache.get(key)
            if out is None:
                ids1, ids2 = (torch.as_tensor(np.asarray(tok(texts)), dtype=torch.long,
                                              device=self.device)
                              for tok in (self.tokenizer, self.tokenizer_2))
                _, h1 = self.text_encoder(ids1, output_hidden_states=True)
                _, pooled, h2 = self.text_encoder_2(ids2, output_hidden_states=True)
                # the penultimate hidden states (SDXL's fixed clip-skip)
                out = (torch.cat([h1[-2], h2[-2]], dim=-1), pooled)
                if len(self._prompt_cache) < 256:
                    self._prompt_cache[key] = out
            return out

        pos, pos_pool = encode(prompts)
        if not do_classifier_free_guidance:
            return pos, pos_pool
        if negative_prompt is None and self.force_zeros_for_empty_prompt:
            neg, neg_pool = torch.zeros_like(pos), torch.zeros_like(pos_pool)
        else:
            neg, neg_pool = encode(negatives)
        return torch.cat([neg, pos]), torch.cat([neg_pool, pos_pool])

    # ----------------------------------------------------------------- call

    @torch.inference_mode()
    def generate(
        self,
        prompt: Union[str, Sequence[str]],
        image,                                  # masked image (hole zeroed)
        mask,                                   # white = mirror region
        depth=None,
        normals=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        negative_prompt: Union[str, Sequence[str], None] = None,
        num_images_per_prompt: int = 1,
        seed: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        latents=None,                           # (B, H/8, W/8, 4) NHWC initial noise
        brushnet_conditioning_scale: float = 1.0,
        control_guidance_start: float = 0.0,
        control_guidance_end: float = 1.0,
        original_size: Optional[Tuple[int, int]] = None,
        crops_coords_top_left: Tuple[int, int] = (0, 0),
        target_size: Optional[Tuple[int, int]] = None,
        guess_mode: bool = False,
        scheduler: str = "unipc",
        solver_order: int = 2,
        dispatch: str = "scan",
        output_type: str = "np",
        deterministic_vae_encode: bool = False,
    ):
        """Generate, as the base pipeline's `generate`; `original_size`,
        `crops_coords_top_left` and `target_size` are SDXL's size and crop
        conditioning (default: the image's own size, no crop)."""
        if guess_mode:
            raise ValueError("guess_mode is handled by the SD-1.5 path only")
        self._check_modes(dispatch, guess_mode)
        do_cfg = guidance_scale > 1.0
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        batch_size = len(prompts) * num_images_per_prompt

        prompt_embeds, pooled = self.encode_prompt_xl(prompt, negative_prompt, do_cfg)
        prompt_embeds = _repeat_halves(prompt_embeds, num_images_per_prompt, do_cfg).to(self.dtype)
        pooled = _repeat_halves(pooled, num_images_per_prompt, do_cfg)
        latents0, cond, (h, w) = self._latents_and_conditioning(
            image, mask, depth, normals, height, width, batch_size, seed, generator, latents,
            deterministic_vae_encode)
        time_ids = torch.tensor(
            [list(original_size or (h, w)) + list(crops_coords_top_left)
             + list(target_size or (h, w))], dtype=torch.float32, device=self.device)
        added = {"text_embeds": pooled, "time_ids": time_ids.expand(pooled.shape[0], 6)}
        return self._sample(
            latents0, cond, prompt_embeds, prompt_embeds, added, batch_size, output_type,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            brushnet_conditioning_scale=brushnet_conditioning_scale,
            control_guidance_start=control_guidance_start,
            control_guidance_end=control_guidance_end, guess_mode=False,
            scheduler=scheduler, solver_order=solver_order)
