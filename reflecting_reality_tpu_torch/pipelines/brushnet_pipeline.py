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
pipeline's device.

Normals `ip_adapter` mode (JAX :72-88, :116-180, :1099-1115): `normals` is
the (1, 3) unit mean mirror normal; `normal_proj` freq-encodes and projects
it to one token, appended to both CFG halves of the UNet's prompt embeds
(whose cross-attentions split it off into `to_k_ip`/`to_v_ip`), while
BrushNet keeps the 77 text tokens.

Approximate modes, each off by default: DeepCache (`enable_deep_cache`)
and encoder reuse (`enable_encoder_reuse`) run the full dual branch on
steps i % interval == 0, caching the UNet's deep trunk (or its encoder
output and skip stack) and the BrushNet residuals, and on the other steps
only the shallow (or decoder-only) UNet forward (JAX :598-703); VAE tiling
(`enable_vae_tiling`, `parallel.sharded_vae.tiled_decode`).  The call's
`dispatch` ("scan" | "per_step") is accepted for JAX's callers: the loop
here is already one step at a time, so both give the same images.  W8A8
int8 (`enable_int8`, `ops/quant.py`) quantizes the UNet's and BrushNet's
convs and projections once, in place; it composes with the modes above.

Multi-device (JAX :295-343, :480-511, :1170-1180), over a mesh of
`parallel.mesh.make_mesh` (an ordered tuple of devices, repeats allowed):
- `enable_data_parallel(mesh)`: the text encode, the conditioning latents
  and the initial noise are computed on the pipeline's device for the whole
  batch, as without it; then the batch is split into the mesh's equal parts
  (the CFG halves of the prompt embeds split alike) and each part runs its
  own denoise loop (its own sampler state) and decode on its entry's
  replica of the UNet, BrushNet and VAE (the pipeline's own modules on
  entries of its device, one copy per other device), each part from a host
  thread of its own, as `torch.nn.parallel.parallel_apply` runs replicas;
  the decoded images are gathered in order on the pipeline's device and
  converted there.  The batch must divide by the mesh size.
- `enable_sharded_vae(mesh, exact=True)`: the decode runs
  `parallel.sharded_vae.sharded_decode_exact` (or the blended
  `sharded_decode`) over the mesh.  The decode takes sharded > tiled >
  plain.  The two are mutually exclusive, with JAX's errors.
The SDXL pipeline (`brushnet_sdxl_pipeline.py`) subclasses this one.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from reflecting_reality_tpu_torch.core.device import fp32_convolutions, resolve_device
from reflecting_reality_tpu_torch.ops.embeddings import (
    precompute_time_embeddings, text_time_embedding,
)
from reflecting_reality_tpu_torch.pipelines.image_processor import ImageProcessor
from reflecting_reality_tpu_torch.schedulers.common import NoiseSchedule, ddim_timesteps
from reflecting_reality_tpu_torch.schedulers.ddim import ddim_step
from reflecting_reality_tpu_torch.schedulers.unipc import UniPCSampler


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


class _Replica(NamedTuple):
    """The modules one part of a data-parallel batch runs on."""

    unet: torch.nn.Module
    brushnet: torch.nn.Module
    vae: torch.nn.Module
    device: torch.device


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float image -> uint8, the same clip/scale/round as
    `ImageProcessor.postprocess`, on the image's device."""
    return torch.round(torch.clamp(image.float() / 2.0 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


class StableDiffusionBrushNetPipeline:
    """Inference pipeline over torch modules (vae, text_encoder, unet,
    brushnet) plus a tokenizer, moved to `device` and cast to `dtype`.
    `device` defaults to the card; pass device="cpu" for the plain path."""

    # the module attributes `to` moves (None where a mode has no module)
    _MODULES = ("vae", "text_encoder", "unet", "brushnet", "normal_proj")

    def __init__(
        self,
        vae,
        text_encoder,
        tokenizer,                # callable(list[str]) -> (B, 77) int
        unet,
        brushnet,
        schedule: Optional[NoiseSchedule] = None,
        depth_conditioning_mode: Optional[str] = None,     # None | "concat" | "latents"
        normals_conditioning_mode: Optional[str] = None,   # + "ip_adapter"
        normal_proj=None,         # NormalProjModel, ip_adapter mode
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
        if depth_conditioning_mode not in (None, "concat", "latents"):
            raise ValueError(f"depth_conditioning_mode={depth_conditioning_mode!r}")
        if normals_conditioning_mode not in (None, "concat", "latents", "ip_adapter"):
            raise ValueError(f"normals_conditioning_mode={normals_conditioning_mode!r}")
        if normals_conditioning_mode == "ip_adapter" and normal_proj is None:
            raise ValueError("normals_conditioning_mode='ip_adapter' needs normal_proj "
                             "(a NormalProjModel)")
        self.device = resolve_device(device)
        self.dtype = dtype
        to = (dtype,) if cast_modules else ()
        self.vae = vae.to(self.device, *to).eval()
        self.text_encoder = text_encoder.to(self.device, *to).eval()
        self.unet = unet.to(self.device, *to).eval()
        self.brushnet = brushnet.to(self.device, *to).eval()
        self.normal_proj = (normal_proj.to(self.device, *to).eval()
                            if normal_proj is not None else None)
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
        self._vae_tiling = None     # (num_tiles, overlap) when enabled
        self._deep_cache = None     # interval when enabled (DeepCache)
        self._encoder_reuse = None  # interval when enabled (encoder reuse)
        self._sharded_vae = None    # (mesh, exact, VAE replicas) when enabled
        self._dp_mesh = None        # the data-parallel mesh when enabled
        self._dp_replicas = None    # its replicas, built at the first call

    @classmethod
    def from_pretrained(
        cls,
        base_path: str,
        brushnet_path: str,
        unet_path: Optional[str] = None,
        depth_conditioning_mode: Optional[str] = None,
        normals_conditioning_mode: Optional[str] = None,
        ip_adapter_path: Optional[str] = None,
        ip_adapter_scale: float = 1.0,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device, None] = None,
    ) -> "StableDiffusionBrushNetPipeline":
        """Load from diffusers-layout folders: a base SD-1.5 folder with
        unet/vae/text_encoder/tokenizer subfolders, a MirrorFusion brushnet
        folder, and optionally a fine-tuned unet folder.

        ip_adapter mode: the UNet is built with IP-Adapter fields
        (`ip_num_tokens=4`, `ip_scale=ip_adapter_scale`) and its trained
        to_k_ip/to_v_ip come from the unet folder; `NormalProjModel` loads
        from `ip_adapter_path`, by default the `ip_adapter/` folder beside
        the brushnet folder (the layout `training.checkpoint` writes)."""
        from reflecting_reality_tpu_torch.core.io import load_pretrained
        from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer
        from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
        from reflecting_reality_tpu_torch.models.clip_text import load_text_encoder
        from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
        from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

        device = resolve_device(device)  # fail before loading anything
        unet_overrides, normal_proj = {}, None
        if normals_conditioning_mode == "ip_adapter":
            from reflecting_reality_tpu_torch.models.ip_adapter import (
                DEFAULT_NUM_TOKENS, NORMAL_PROJ_FILE, build_normal_proj,
            )

            unet_overrides = dict(ip_num_tokens=DEFAULT_NUM_TOKENS, ip_scale=ip_adapter_scale)
        unet = load_pretrained(UNet2DConditionModel, unet_path or base_path,
                               subfolder=None if unet_path else "unet", **unet_overrides)
        if normals_conditioning_mode == "ip_adapter":
            ip_dir = ip_adapter_path or os.path.join(
                os.path.dirname(os.path.normpath(brushnet_path)), "ip_adapter")
            normal_proj = build_normal_proj(
                unet.cross_attention_dim,
                path=os.path.join(ip_dir, os.path.basename(NORMAL_PROJ_FILE)))
        return cls(
            vae=load_pretrained(AutoencoderKL, base_path, subfolder="vae"),
            text_encoder=load_text_encoder(base_path),
            tokenizer=CLIPTokenizer.from_pretrained(base_path, subfolder="tokenizer"),
            unet=unet,
            brushnet=load_pretrained(BrushNetModel, brushnet_path),
            depth_conditioning_mode=depth_conditioning_mode,
            normals_conditioning_mode=normals_conditioning_mode,
            normal_proj=normal_proj,
            dtype=dtype,
            device=device,
        )

    def to(self, device) -> "StableDiffusionBrushNetPipeline":
        """Move every module to `device` (JAX `place_params`) -> self.  The
        prompt memo, which holds tensors, starts empty there, and
        data-parallel replicas are built anew at the next call."""
        self.device = resolve_device(device)
        for name in self._MODULES:
            module = getattr(self, name)
            if module is not None:
                setattr(self, name, module.to(self.device))
        self._prompt_cache.clear()
        self._dp_replicas = None
        return self

    # ------------------------------------------------------ approximate modes

    def enable_vae_tiling(self, num_tiles: int = 4, overlap: int = 8) -> None:
        """Tiled VAE decode (`parallel.sharded_vae.tiled_decode`): bounds the
        decoder's peak memory at high resolution; approximate."""
        self._vae_tiling = (num_tiles, overlap)

    def disable_vae_tiling(self) -> None:
        self._vae_tiling = None

    def enable_deep_cache(self, interval: int = 2) -> None:
        """DeepCache (arXiv:2312.03209): every `interval`-th step runs the
        full dual branch and caches the UNet's deep trunk and the BrushNet
        residuals; the steps between recompute only the shallow encoder and
        decoder around them.  Approximate; interval 1 is the exact path."""
        if interval < 1:
            raise ValueError("deep_cache interval must be >= 1")
        self._deep_cache = None if interval == 1 else int(interval)

    def disable_deep_cache(self) -> None:
        self._deep_cache = None

    def enable_encoder_reuse(self, interval: int = 2) -> None:
        """Encoder reuse ("Faster Diffusion", arXiv:2312.09608): every
        `interval`-th step runs the full dual branch and caches the UNet's
        encoder output and skip stack (BrushNet down residuals applied) and
        the BrushNet mid/up residuals; the steps between skip conv_in, the
        down blocks and BrushNet and run the mid block and the decoder.
        Approximate; interval 1 is the exact path."""
        if interval < 1:
            raise ValueError("encoder_reuse interval must be >= 1")
        self._encoder_reuse = None if interval == 1 else int(interval)

    def disable_encoder_reuse(self) -> None:
        self._encoder_reuse = None

    def enable_sharded_vae(self, mesh, exact: bool = True) -> None:
        """Decode the final latents across `mesh` (W-sharded decoder tail):
        exact=True takes the psum-GroupNorm + halo-exchange decode (the
        unsharded decode up to fp32 reassociation), exact=False the
        overlapping-strip blend.  See `parallel.sharded_vae`."""
        from reflecting_reality_tpu_torch.parallel.mesh import replicated

        if self._dp_mesh is not None:
            raise ValueError(
                "enable_sharded_vae and enable_data_parallel are mutually exclusive")
        self._sharded_vae = (tuple(mesh), exact, replicated(self.vae, mesh))

    def disable_sharded_vae(self) -> None:
        self._sharded_vae = None

    def enable_data_parallel(self, mesh) -> None:
        """Split each call's batch over `mesh`, one replica of the UNet,
        BrushNet and VAE per entry (see the module docstring).  Mutually
        exclusive with `enable_sharded_vae` (the decode is batch-split
        here; the W-sharded decoder is for one high-resolution image)."""
        if self._sharded_vae is not None:
            raise ValueError(
                "enable_data_parallel and enable_sharded_vae are mutually exclusive")
        self._dp_mesh = tuple(mesh)
        self._dp_replicas = None

    def disable_data_parallel(self) -> None:
        self._dp_mesh = None
        self._dp_replicas = None

    def _replicas(self):
        """One `_Replica` per data-parallel mesh entry (built once; again
        after `enable_int8`)."""
        from reflecting_reality_tpu_torch.parallel.mesh import replicated

        if self._dp_replicas is None:
            mods = [replicated(m, self._dp_mesh) for m in (self.unet, self.brushnet, self.vae)]
            self._dp_replicas = [_Replica(*r, d) for *r, d in zip(*mods, self._dp_mesh)]
        return self._dp_replicas

    def enable_int8(self, select=None) -> int:
        """W8A8 int8 (`ops/quant.py`, JAX :253-275): the UNet's and
        BrushNet's selected convs and linears become per-output-channel int8
        layers (weights quantized once, here), activations are quantized
        per tensor on the fly, and the products accumulate in int32 on the
        card's int8 tensor cores.  Timestep MLPs, the VAE, the text encoder
        and `normal_proj` stay exact.  An approximation mode; it composes
        with DeepCache, encoder reuse, `dispatch`, ip_adapter and batches.

        One-way: the float weights are dropped (build a new pipeline to go
        back to exact).  `select` overrides the selection policy
        (`ops.quant.default_select`), mainly for tiny test configs.  Raises
        ValueError when it selects nothing.  -> the number quantized."""
        from reflecting_reality_tpu_torch.ops.quant import default_select, quantize_modules

        sel = select or default_select
        n = quantize_modules(self.unet, sel) + quantize_modules(self.brushnet, sel)
        if n == 0:
            raise ValueError("no kernels selected for int8 quantization")
        self._dp_replicas = None    # data-parallel replicas copy the quantized modules
        return n

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
        28 residuals (exact).  Not an SDXL branch: its `text_time` term takes
        the pooled text embeds, which differ between the halves (JAX
        `brushnet_sdxl_pipeline.py:151-154`)."""
        return (do_cfg and not guess_mode and not self.brushnet.has_cross_attention
                and self.brushnet.add_embedding is None)

    def _residuals(self, brushnet, latents, latent_in, brushnet_embeds, cond_latents,
                   cond_scale, temb, do_cfg, guess_mode):
        """One BrushNet evaluation -> (down, mid, up) at the model batch."""
        d = self.dtype
        if self._brushnet_cfg_dedup(do_cfg, guess_mode):
            return _tile(brushnet(
                latents.to(d), None, brushnet_embeds[latents.shape[0]:], cond_latents,
                conditioning_scale=cond_scale, temb=temb))
        if guess_mode and do_cfg:
            down, mid, up = brushnet(
                latents.to(d), None, brushnet_embeds[brushnet_embeds.shape[0] // 2:],
                cond_latents, conditioning_scale=cond_scale, guess_mode=True, temb=temb)
            return ([torch.cat([torch.zeros_like(x), x]) for x in down],
                    torch.cat([torch.zeros_like(mid), mid]),
                    [torch.cat([torch.zeros_like(x), x]) for x in up])
        cond_b = torch.cat([cond_latents, cond_latents]) if do_cfg else cond_latents
        return brushnet(latent_in.to(d), None, brushnet_embeds, cond_b,
                             conditioning_scale=cond_scale, guess_mode=guess_mode, temb=temb)

    # ----------------------------------------------------------------- call

    def __call__(self, *args, **kwargs):
        """Generate (see `generate`), under autocast where the pipeline runs
        modules it did not cast, with full-fp32 convolutions at fp32
        (`core.device.fp32_convolutions`)."""
        with fp32_convolutions(self.dtype):
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
        dispatch: str = "scan",                 # "scan" | "per_step": the same loop here
        output_type: str = "np",
        deterministic_vae_encode: bool = False,
    ):
        """Generate; returns images per `output_type`: "np" (uint8 NHWC),
        "pil", "latent" (the decoded float image, NHWC numpy, before the
        uint8 conversion, as in JAX) or "device" (uint8 NHWC tensor left on
        the device)."""
        self._check_modes(dispatch, guess_mode)
        do_cfg = guidance_scale > 1.0
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        batch_size = len(prompts) * num_images_per_prompt

        # 1. text
        prompt_embeds = self.encode_prompt(prompt, negative_prompt, num_images_per_prompt,
                                           do_cfg).to(self.dtype)
        # 2.-3. the initial noise and the conditioning latents
        latents0, cond, _ = self._latents_and_conditioning(
            image, mask, depth, normals, height, width, batch_size, seed, generator, latents,
            deterministic_vae_encode)

        brushnet_embeds = prompt_embeds
        if self.normals_conditioning_mode == "ip_adapter":
            # the (1, 3) mean mirror normal -> one token appended to both CFG
            # halves of the UNet's embeds; BrushNet keeps the text tokens
            from reflecting_reality_tpu_torch.models.ip_adapter import normal_tokens

            normal = torch.as_tensor(np.asarray(normals, np.float32).reshape(-1, 1, 3),
                                     device=self.device)
            tok = normal_tokens(normal, self.normal_proj)
            if tok.shape[0] == 1 and batch_size > 1:
                tok = tok.repeat_interleave(batch_size, dim=0)
            if do_cfg:
                tok = torch.cat([tok, tok])
            prompt_embeds = torch.cat([prompt_embeds, tok.to(prompt_embeds.dtype)], dim=1)

        return self._sample(
            latents0, cond, prompt_embeds, brushnet_embeds, None, batch_size, output_type,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            brushnet_conditioning_scale=brushnet_conditioning_scale,
            control_guidance_start=control_guidance_start,
            control_guidance_end=control_guidance_end, guess_mode=guess_mode,
            scheduler=scheduler, solver_order=solver_order)

    def _check_modes(self, dispatch: str, guess_mode: bool) -> None:
        if dispatch not in ("scan", "per_step"):
            raise ValueError(dispatch)
        if self._deep_cache and self._encoder_reuse:
            raise ValueError("deep_cache and encoder_reuse are mutually exclusive")
        if (self._deep_cache or self._encoder_reuse) and guess_mode:
            raise ValueError("cached modes + guess_mode unsupported")

    def _latents_and_conditioning(self, image, mask, depth, normals, height, width,
                                  batch_size: int, seed, generator, latents,
                                  deterministic_vae_encode: bool):
        """The host image prep and the device work before the denoise loop
        -> (initial noise, conditioning latents, (H, W)), NCHW on the device:
        one packed upload (image | depth | normals | mask), the VAE encodes
        and the latent-resolution planes."""
        dev, dtype, sf = self.device, self.dtype, self.scaling_factor
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0 if seed is None else seed)

        # host image prep (NHWC float32 [-1, 1]); mask -> 1 = keep, 0 = hole
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
        if normals is None and self.normals_conditioning_mode is not None:
            raise ValueError("normals_conditioning_mode set but no normals given")
        if self.normals_conditioning_mode in ("concat", "latents"):
            normals_np = self.image_processor.preprocess(normals, h, w)
            if normals_np.shape[0] == 1 and uniq > 1:
                normals_np = np.repeat(normals_np, uniq, axis=0)
        parts = [p for p in (image_np, depth_np, normals_np, mask_np) if p is not None]

        # one packed upload (image | depth | normals | mask), NCHW on the device
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
        return latents0, cond.to(dtype), (h, w)

    def _sample(self, latents0, cond, prompt_embeds, brushnet_embeds, added, batch_size: int,
                output_type: str, num_inference_steps: int, guidance_scale: float,
                brushnet_conditioning_scale: float, control_guidance_start: float,
                control_guidance_end: float, guess_mode: bool, scheduler: str,
                solver_order: int):
        """The brushnet_keep window, the denoise loop and the decode (one
        run, or one a data-parallel part), then the output conversion.
        `added` holds SDXL's `text_embeds` and `time_ids` (None for SD-1.5),
        one row a model-batch row, as the prompt embeds."""
        keeps = [
            1.0 - float(i / num_inference_steps < control_guidance_start
                        or (i + 1) / num_inference_steps > control_guidance_end)
            for i in range(num_inference_steps)
        ]
        cond_scales = [float(np.float32(k * brushnet_conditioning_scale)) for k in keeps]
        loop = dict(num_inference_steps=num_inference_steps, cond_scales=cond_scales,
                    guidance_scale=guidance_scale, do_cfg=guidance_scale > 1.0,
                    guess_mode=guess_mode, scheduler=scheduler, solver_order=solver_order)
        if self._dp_mesh is None:
            image_out = self._denoise_decode(_Replica(self.unet, self.brushnet, self.vae,
                                                      self.device),
                                             latents0, cond, prompt_embeds, brushnet_embeds,
                                             added, **loop)
        else:
            image_out = self._data_parallel(latents0, cond, prompt_embeds, brushnet_embeds,
                                            added, batch_size, loop)
        if output_type == "latent":
            return _nhwc(image_out).cpu().numpy()
        image_u8 = _nhwc(to_uint8(image_out))
        if output_type == "device":
            return image_u8
        return self.image_processor.postprocess(image_u8.cpu().numpy(), output_type=output_type)

    def _data_parallel(self, latents0, cond, prompt_embeds, brushnet_embeds, added,
                       batch_size: int, loop: dict) -> torch.Tensor:
        """The batch split over the data-parallel mesh, each part's loop and
        decode on its replica in a host thread of its own -> the decoded
        float images, in order, on the pipeline's device."""
        from reflecting_reality_tpu_torch.parallel.mesh import shard_batch

        mesh = self._dp_mesh
        n = len(mesh)
        if batch_size % n:
            raise ValueError(
                f"data-parallel generation needs batch_size ({batch_size}) divisible by the "
                f"mesh size ({n}); use num_images_per_prompt or a prompt list to fill the mesh")

        def embeds(e):    # CFG layout [uncond..., cond...]: both halves split alike
            if not loop["do_cfg"]:
                return shard_batch(e, mesh)
            return [torch.cat(h) for h in zip(shard_batch(e[:batch_size], mesh),
                                              shard_batch(e[batch_size:], mesh))]

        # SDXL's text_embeds and time_ids have the prompt embeds' rows
        added_parts = ([None] * n if added is None else
                       [dict(zip(added, part)) for part in zip(*map(embeds, added.values()))])
        parts = list(zip(self._replicas(), shard_batch(latents0, mesh), shard_batch(cond, mesh),
                         embeds(prompt_embeds), embeds(brushnet_embeds), added_parts))
        results, errors = [None] * n, [None] * n

        def run(i):
            rep = parts[i][0]
            on_card = torch.cuda.device(rep.device) if rep.device.type == "cuda" \
                else contextlib.nullcontext()
            cast = torch.autocast(rep.device.type, dtype=self.dtype) if self.autocast \
                else contextlib.nullcontext()
            try:
                # grad mode, the current device and autocast are per thread
                with torch.inference_mode(), on_card, cast:
                    results[i] = self._denoise_decode(*parts[i], **loop)
            except BaseException as e:       # re-raised in the calling thread
                errors[i] = e

        if n == 1:
            run(0)
        else:
            threads = [threading.Thread(target=run, args=(i,), name=f"replica-{i}")
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        for e in errors:
            if e is not None:
                raise e
        return torch.cat([r.to(self.device) for r in results])

    def _decode(self, vae, z: torch.Tensor) -> torch.Tensor:
        """Scaled-back latents -> the float image: sharded > tiled > plain."""
        from reflecting_reality_tpu_torch.parallel import sharded_vae

        if self._sharded_vae is not None:
            mesh, exact, replicas = self._sharded_vae
            if exact:
                return sharded_vae.sharded_decode_exact(vae, z, mesh, replicas=replicas).float()
            return sharded_vae.sharded_decode(vae, z, mesh, scale=self.vae_scale_factor,
                                              replicas=replicas).float()
        if self._vae_tiling is not None:
            return sharded_vae.tiled_decode(vae, z, num_tiles=self._vae_tiling[0],
                                            overlap=self._vae_tiling[1],
                                            scale=self.vae_scale_factor).float()
        return vae.decode(z).float()

    def _denoise_decode(self, rep: _Replica, latents0, cond, prompt_embeds, brushnet_embeds,
                        added, num_inference_steps: int, cond_scales, guidance_scale: float,
                        do_cfg: bool, guess_mode: bool, scheduler: str, solver_order: int
                        ) -> torch.Tensor:
        """The denoise loop (UniPC or DDIM, CFG, the cached modes) and the
        decode on `rep`'s modules -> the decoded float image (B, C, H, W)."""
        dtype, sf = self.dtype, self.scaling_factor
        deep_cache, encoder_reuse = self._deep_cache, self._encoder_reuse
        if scheduler == "unipc":
            sampler = UniPCSampler(self.schedule, num_inference_steps, solver_order=solver_order)
            timesteps = sampler.timesteps
            state = sampler.init_state(latents0)
        elif scheduler == "ddim":
            timesteps = ddim_timesteps(self.schedule.num_train_timesteps, num_inference_steps)
        else:
            raise ValueError(scheduler)
        # (N, 1, C) time embeddings; SDXL's text_time term is one row a
        # sample and the same at every step, so it is added here once a call
        # -> (N, B, C)
        temb_u = precompute_time_embeddings(rep.unet, timesteps)[:, None]
        temb_b = precompute_time_embeddings(rep.brushnet, timesteps)[:, None]
        if added is not None:
            temb_u = temb_u + text_time_embedding(rep.unet, added, temb_u.dtype)
            temb_b = temb_b + text_time_embedding(rep.brushnet, added, temb_b.dtype)

        lat = latents0
        interval = deep_cache or encoder_reuse
        cache = None
        for i in range(num_inference_steps):
            latent_in = torch.cat([lat, lat]) if do_cfg else lat
            unet_kw = dict(temb=temb_u[i])
            if interval is None or i % interval == 0:
                # the full dual branch (refreshing the cache in a cached mode)
                down_res, mid_res, up_res = self._residuals(
                    rep.brushnet, lat, latent_in, brushnet_embeds, cond, cond_scales[i],
                    temb_b[i], do_cfg, guess_mode)
                out = rep.unet(latent_in.to(dtype), None, prompt_embeds,
                               down_block_add_samples=down_res, mid_block_add_sample=mid_res,
                               up_block_add_samples=up_res, return_deep=bool(deep_cache),
                               return_encoder=bool(encoder_reuse), **unet_kw)
                if deep_cache:
                    pred, deep = out
                    cache = (deep, down_res, mid_res, up_res)
                elif encoder_reuse:
                    pred, enc = out
                    cache = (enc, mid_res, up_res)
                else:
                    pred = out
            elif deep_cache:
                deep, down_res, mid_res, up_res = cache
                pred, _ = rep.unet(latent_in.to(dtype), None, prompt_embeds,
                                   down_block_add_samples=down_res, mid_block_add_sample=mid_res,
                                   up_block_add_samples=up_res, cached_deep=deep, **unet_kw)
            else:
                enc, mid_res, up_res = cache
                pred, _ = rep.unet(latent_in.to(dtype), None, prompt_embeds,
                                   mid_block_add_sample=mid_res, up_block_add_samples=up_res,
                                   cached_encoder=enc, return_encoder=True, **unet_kw)
            if do_cfg:
                uncond, text = pred.float().chunk(2)
                pred = uncond + float(np.float32(guidance_scale)) * (text - uncond)
            if scheduler == "unipc":
                lat, state = sampler.step(pred, i, lat, state)
            else:
                t_prev = int(timesteps[i + 1]) if i + 1 < num_inference_steps else -1
                lat = ddim_step(self.schedule, pred, int(timesteps[i]), t_prev, lat)
        return self._decode(rep.vae, (lat / sf).to(dtype))
