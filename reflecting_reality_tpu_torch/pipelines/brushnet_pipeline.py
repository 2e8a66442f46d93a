"""StableDiffusionBrushNetPipeline in PyTorch: the exact inference path
(counterpart of `reflecting_reality_tpu/pipelines/brushnet_pipeline.py`;
reference: src/diffusers/pipelines/brushnet/pipeline_brushnet.py:128,848).

Each call: CLIP-encode the prompt (memoized) -> VAE-encode the masked image
and concatenate the latent-resolution mask and depth planes into the
conditioning latents -> a Python denoise loop (UniPC or DDIM), each step
running the conv-only BrushNet once at half batch, tiling its 28 residuals
across both CFG halves, running the UNet with them injected, combining CFG
and stepping the sampler -> VAE decode and uint8 conversion on the device.

Reference contracts kept exactly (see the JAX module for line references):
bicubic resize to [-1, 1]; the mask trick (3ch mask -> channel-sum < 0, so
1 = keep, 0 = mirror hole); conditioning latents = concat(vae(masked
image)·sf, nearest mask, depth, normals) (JAX :1013-1098), where depth is
a 1ch nearest downsample (`concat`) or the VAE encode of its 3-channel
repeat (`latents`), and normals a 3ch nearest downsample (`concat`) or
their VAE encode (`latents`); one packed upload carries image | depth |
normals | mask; the brushnet_keep window; CFG layout [uncond, cond];
guess_mode runs the branch on the cond half and zero-pads the uncond half.

Random numbers: one torch.Generator draws the initial noise, then the VAE
sampling noise of the image, the depth and the normals encodes, in that
order.  JAX splits its key four ways instead (:987), so the two draw
different numbers; parity tests pass `latents=` and
`deterministic_vae_encode=True`.

The host boundary is numpy NHWC, as in JAX; inside, tensors are NCHW on the
pipeline's device.  DeepCache, encoder reuse, int8, VAE tiling, the sharded
VAE, data parallelism, per-step dispatch, the normals ip_adapter mode and
SDXL are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from reflecting_reality_tpu_torch.core.device import resolve_device
from reflecting_reality_tpu_torch.ops.embeddings import precompute_time_embeddings
from reflecting_reality_tpu_torch.pipelines.image_processor import ImageProcessor
from reflecting_reality_tpu_torch.schedulers.common import NoiseSchedule, ddim_timesteps
from reflecting_reality_tpu_torch.schedulers.ddim import ddim_step
from reflecting_reality_tpu_torch.schedulers.unipc import UniPCSampler


IP_ADAPTER_UNPORTED = ("normals_conditioning_mode='ip_adapter' is not ported to the PyTorch "
                       "package yet (ROADMAP.md queue A, item 14)")


def _tile(res):
    """Tile half-batch BrushNet residuals to both CFG halves (exact dedup)."""
    down, mid, up = res
    return ([torch.cat([d, d]) for d in down], torch.cat([mid, mid]),
            [torch.cat([u, u]) for u in up])


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return x.permute(0, 3, 1, 2).contiguous()


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float image -> uint8, the same clip/scale/round as
    `ImageProcessor.postprocess`, on the image's device."""
    return torch.round(torch.clamp(image.float() / 2.0 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


class StableDiffusionBrushNetPipeline:
    """Inference pipeline over torch modules (vae, text_encoder, unet,
    brushnet) plus a tokenizer, moved to `device` and cast to `dtype`.
    `device` defaults to the card; pass device="cpu" for the plain path."""

    def __init__(
        self,
        vae,
        text_encoder,
        tokenizer,                # callable(list[str]) -> (B, 77) int
        unet,
        brushnet,
        schedule: Optional[NoiseSchedule] = None,
        depth_conditioning_mode: Optional[str] = None,     # None | "concat" | "latents"
        normals_conditioning_mode: Optional[str] = None,   # None | "concat" | "latents"
        vae_scale_factor: int = 8,
        scaling_factor: float = 0.18215,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device, None] = None,
        cast_modules: bool = True,
    ):
        """`cast_modules=False` uses the modules as they are (moved to
        `device` if they are elsewhere, never cast) and runs every call
        under `torch.autocast` in `dtype`: the training CLI's validation
        runs the live modules this way, fp32 BrushNet masters and all."""
        if normals_conditioning_mode == "ip_adapter":
            raise NotImplementedError(IP_ADAPTER_UNPORTED)
        if depth_conditioning_mode not in (None, "concat", "latents"):
            raise ValueError(f"depth_conditioning_mode={depth_conditioning_mode!r}")
        if normals_conditioning_mode not in (None, "concat", "latents"):
            raise ValueError(f"normals_conditioning_mode={normals_conditioning_mode!r}")
        self.device = resolve_device(device)
        self.dtype = dtype
        to = (dtype,) if cast_modules else ()
        self.vae = vae.to(self.device, *to).eval()
        self.text_encoder = text_encoder.to(self.device, *to).eval()
        self.unet = unet.to(self.device, *to).eval()
        self.brushnet = brushnet.to(self.device, *to).eval()
        self.autocast = not cast_modules and dtype != torch.float32
        self.tokenizer = tokenizer
        self.schedule = schedule or NoiseSchedule.create(
            num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
            beta_schedule="scaled_linear",
        )
        self.depth_conditioning_mode = depth_conditioning_mode
        self.normals_conditioning_mode = normals_conditioning_mode
        self.vae_scale_factor = vae_scale_factor
        self.scaling_factor = scaling_factor
        self.image_processor = ImageProcessor(vae_scale_factor=vae_scale_factor)
        self._prompt_cache = {}

    @classmethod
    def from_pretrained(
        cls,
        base_path: str,
        brushnet_path: str,
        unet_path: Optional[str] = None,
        depth_conditioning_mode: Optional[str] = None,
        normals_conditioning_mode: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device, None] = None,
    ) -> "StableDiffusionBrushNetPipeline":
        """Load from diffusers-layout folders: a base SD-1.5 folder with
        unet/vae/text_encoder/tokenizer subfolders, a MirrorFusion brushnet
        folder, and optionally a fine-tuned unet folder."""
        from reflecting_reality_tpu_torch.core.io import load_pretrained
        from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer
        from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
        from reflecting_reality_tpu_torch.models.clip_text import load_text_encoder
        from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
        from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

        device = resolve_device(device)  # fail before loading anything
        if normals_conditioning_mode == "ip_adapter":
            raise NotImplementedError(IP_ADAPTER_UNPORTED)
        return cls(
            vae=load_pretrained(AutoencoderKL, base_path, subfolder="vae"),
            text_encoder=load_text_encoder(base_path),
            tokenizer=CLIPTokenizer.from_pretrained(base_path, subfolder="tokenizer"),
            unet=load_pretrained(UNet2DConditionModel, unet_path or base_path,
                                 subfolder=None if unet_path else "unet"),
            brushnet=load_pretrained(BrushNetModel, brushnet_path),
            depth_conditioning_mode=depth_conditioning_mode,
            normals_conditioning_mode=normals_conditioning_mode,
            dtype=dtype,
            device=device,
        )

    # ------------------------------------------------------------------ text

    @torch.inference_mode()
    def encode_prompt(
        self,
        prompt: Union[str, Sequence[str]],
        negative_prompt: Union[str, Sequence[str], None] = None,
        num_images_per_prompt: int = 1,
        do_classifier_free_guidance: bool = True,
    ) -> torch.Tensor:
        """CLIP-encode prompts; CFG layout [uncond..., cond...]."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        if negative_prompt is None:
            negatives = [""] * len(prompts)
        elif isinstance(negative_prompt, str):
            negatives = [negative_prompt] * len(prompts)
        else:
            negatives = list(negative_prompt)

        def encode(texts):
            # device-side memo: the CFG uncond batch repeats every call
            key = tuple(texts)
            out = self._prompt_cache.get(key)
            if out is None:
                ids = torch.as_tensor(np.asarray(self.tokenizer(texts)), dtype=torch.long,
                                      device=self.device)
                out = self.text_encoder(ids)
                if len(self._prompt_cache) < 256:
                    self._prompt_cache[key] = out
            return out

        cond = encode(prompts).repeat_interleave(num_images_per_prompt, dim=0)
        if not do_classifier_free_guidance:
            return cond
        uncond = encode(negatives).repeat_interleave(num_images_per_prompt, dim=0)
        return torch.cat([uncond, cond])

    # -------------------------------------------------------------- branches

    def _brushnet_cfg_dedup(self, do_cfg: bool, guess_mode: bool) -> bool:
        """MirrorFusion's BrushNet is conv-only, so under CFG its two batch
        halves see identical inputs: run it once at half batch and tile the
        28 residuals (exact)."""
        return do_cfg and not guess_mode and not self.brushnet.has_cross_attention

    def _residuals(self, latents, latent_in, brushnet_embeds, cond_latents, cond_scale,
                   temb, do_cfg, guess_mode):
        """One BrushNet evaluation -> (down, mid, up) at the model batch."""
        d = self.dtype
        if self._brushnet_cfg_dedup(do_cfg, guess_mode):
            return _tile(self.brushnet(
                latents.to(d), None, brushnet_embeds[latents.shape[0]:], cond_latents,
                conditioning_scale=cond_scale, temb=temb))
        if guess_mode and do_cfg:
            down, mid, up = self.brushnet(
                latents.to(d), None, brushnet_embeds[brushnet_embeds.shape[0] // 2:],
                cond_latents, conditioning_scale=cond_scale, guess_mode=True, temb=temb)
            return ([torch.cat([torch.zeros_like(x), x]) for x in down],
                    torch.cat([torch.zeros_like(mid), mid]),
                    [torch.cat([torch.zeros_like(x), x]) for x in up])
        cond_b = torch.cat([cond_latents, cond_latents]) if do_cfg else cond_latents
        return self.brushnet(latent_in.to(d), None, brushnet_embeds, cond_b,
                             conditioning_scale=cond_scale, guess_mode=guess_mode, temb=temb)

    # ----------------------------------------------------------------- call

    def __call__(self, *args, **kwargs):
        """Generate (see `generate`), under autocast where the pipeline runs
        modules it did not cast."""
        if not self.autocast:
            return self.generate(*args, **kwargs)
        with torch.autocast(self.device.type, dtype=self.dtype):
            return self.generate(*args, **kwargs)

    @torch.inference_mode()
    def generate(
        self,
        prompt: Union[str, Sequence[str]],
        image,                                  # masked image (hole zeroed)
        mask,                                   # white = mirror region
        depth=None,
        normals=None,                           # normals image (concat / latents modes)
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
        guess_mode: bool = False,
        scheduler: str = "unipc",
        solver_order: int = 2,
        output_type: str = "np",
        deterministic_vae_encode: bool = False,
    ):
        """Generate; returns images per `output_type`: "np" (uint8 NHWC),
        "pil", "latent" (the decoded float image, NHWC numpy, before the
        uint8 conversion, as in JAX) or "device" (uint8 NHWC tensor left on
        the device)."""
        dev, dtype, sf = self.device, self.dtype, self.scaling_factor
        do_cfg = guidance_scale > 1.0
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0 if seed is None else seed)

        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        batch_size = len(prompts) * num_images_per_prompt

        # 1. text
        prompt_embeds = self.encode_prompt(prompt, negative_prompt, num_images_per_prompt,
                                           do_cfg).to(dtype)

        # 2. host image prep (NHWC float32 [-1, 1]); mask -> 1 = keep, 0 = hole
        image_np = self.image_processor.preprocess(image, height, width)
        mask_np = self.image_processor.preprocess(mask, height, width)
        h, w = image_np.shape[1:3]
        mask_np = (mask_np.sum(-1, keepdims=True) < 0).astype(np.float32)
        reps = batch_size if (image_np.shape[0] == 1 and batch_size > 1) else 1
        uniq = image_np.shape[0]
        hl, wl = h // self.vae_scale_factor, w // self.vae_scale_factor

        depth_np = normals_np = None
        if self.depth_conditioning_mode is not None:
            if depth is None:
                raise ValueError("depth_conditioning_mode set but no depth given")
            depth_np = self.image_processor.preprocess(depth, h, w)[..., :1]
            if depth_np.shape[0] == 1 and uniq > 1:
                depth_np = np.repeat(depth_np, uniq, axis=0)
        if self.normals_conditioning_mode is not None:
            if normals is None:
                raise ValueError("normals_conditioning_mode set but no normals given")
            normals_np = self.image_processor.preprocess(normals, h, w)
            if normals_np.shape[0] == 1 and uniq > 1:
                normals_np = np.repeat(normals_np, uniq, axis=0)
        parts = [p for p in (image_np, depth_np, normals_np, mask_np) if p is not None]

        # 3. conditioning latents: one packed upload (image | depth | normals |
        # mask), NCHW on the device
        packed = _nchw(np.concatenate(parts, axis=-1)).to(dev, dtype)
        image_dev, mask_dev = packed[:, :3], packed[:, -1:]
        depth_dev = packed[:, 3:4] if depth_np is not None else None
        ofs = 3 if depth_np is None else 4
        normals_dev = packed[:, ofs:ofs + 3] if normals_np is not None else None
        rows = torch.as_tensor(np.arange(hl) * h // hl, device=dev)
        cols = torch.as_tensor(np.arange(wl) * w // wl, device=dev)

        def down(a):  # interpolate_nearest's indices, on the device
            return a[:, :, rows][:, :, :, cols]

        def rep(a):
            return a.repeat_interleave(reps, dim=0) if reps > 1 else a

        def encode(x):
            dist = self.vae.encode(x.to(dtype))
            if deterministic_vae_encode:
                return rep(dist.mode * sf)
            if reps > 1:
                dist = type(dist)(rep(dist.mean), rep(dist.logvar))
            return dist.sample(generator) * sf

        # the initial noise is drawn first, then the VAE's sampling noise of
        # the image, the depth and the normals encodes, in that order
        if latents is None:
            latents0 = torch.randn((batch_size, self.unet.in_channels, hl, wl),
                                   generator=generator, device=dev, dtype=torch.float32)
        else:
            latents0 = _nchw(latents).to(dev, torch.float32)

        cond = encode(image_dev)
        cond = torch.cat([cond, rep(down(mask_dev)).to(cond.dtype)], dim=1)
        if self.depth_conditioning_mode == "concat":
            cond = torch.cat([cond, rep(down(depth_dev)).to(cond.dtype)], dim=1)
        elif self.depth_conditioning_mode == "latents":  # 3-channel repeat -> VAE encode
            cond = torch.cat([cond, encode(depth_dev.repeat(1, 3, 1, 1)).to(cond.dtype)], dim=1)
        if self.normals_conditioning_mode == "concat":
            cond = torch.cat([cond, rep(down(normals_dev)).to(cond.dtype)], dim=1)
        elif self.normals_conditioning_mode == "latents":
            cond = torch.cat([cond, encode(normals_dev).to(cond.dtype)], dim=1)
        cond = cond.to(dtype)

        # 4. brushnet_keep windowing
        keeps = [
            1.0 - float(i / num_inference_steps < control_guidance_start
                        or (i + 1) / num_inference_steps > control_guidance_end)
            for i in range(num_inference_steps)
        ]
        cond_scales = [float(np.float32(k * brushnet_conditioning_scale)) for k in keeps]

        # 5. denoise loop
        if scheduler == "unipc":
            sampler = UniPCSampler(self.schedule, num_inference_steps, solver_order=solver_order)
            timesteps = sampler.timesteps
            state = sampler.init_state(latents0)
        elif scheduler == "ddim":
            timesteps = ddim_timesteps(self.schedule.num_train_timesteps, num_inference_steps)
        else:
            raise ValueError(scheduler)
        temb_u = precompute_time_embeddings(self.unet, timesteps)
        temb_b = precompute_time_embeddings(self.brushnet, timesteps)

        lat = latents0
        for i in range(num_inference_steps):
            latent_in = torch.cat([lat, lat]) if do_cfg else lat
            down_res, mid_res, up_res = self._residuals(
                lat, latent_in, prompt_embeds, cond, cond_scales[i], temb_b[i:i + 1],
                do_cfg, guess_mode)
            pred = self.unet(latent_in.to(dtype), None, prompt_embeds,
                             down_block_add_samples=down_res, mid_block_add_sample=mid_res,
                             up_block_add_samples=up_res, temb=temb_u[i:i + 1])
            if do_cfg:
                uncond, text = pred.float().chunk(2)
                pred = uncond + float(np.float32(guidance_scale)) * (text - uncond)
            if scheduler == "unipc":
                lat, state = sampler.step(pred, i, lat, state)
            else:
                t_prev = int(timesteps[i + 1]) if i + 1 < num_inference_steps else -1
                lat = ddim_step(self.schedule, pred, int(timesteps[i]), t_prev, lat)

        # 6. decode
        image_out = self.vae.decode((lat / sf).to(dtype)).float()
        if output_type == "latent":
            return _nhwc(image_out).cpu().numpy()
        image_u8 = _nhwc(to_uint8(image_out))
        if output_type == "device":
            return image_u8
        return self.image_processor.postprocess(image_u8.cpu().numpy(), output_type=output_type)
