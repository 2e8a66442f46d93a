"""The SD-inpainting baseline, the 9(+)-channel UNet fine-tune MirrorFusion
is compared against (counterpart of
`reflecting_reality_tpu/baseline/sd_inpainting.py`; reference:
baseline/sd_inpainting/{train,test}_sdinpainting.py).

What differs from the BrushNet path, kept as in JAX:
- no conditioning branch: the UNet's input is concat(noisy latents[4],
  mask[1], masked-image latents[4], depth?, normals?), NCHW here; the MASK
  comes first inside the conditioning block (train_sdinpainting.py:1140);
- `inflate_conv_in` zero-extends conv_in's input channels, the pretrained
  first `preserve` of them copied;
- the whole UNet trains; the VAE and the text encoder are frozen.

The training step takes the port's `TrainState` with the UNet as its one
trainable module, and applies updates with `training.train_step.apply_update`
(global-norm clipping, AdamW and its schedule from `make_optimizer`).
`draws=` passes the step's random numbers in, as `make_train_step`'s does:
`vae_noise` ("latents", "cond", "depth", "normals": NCHW posterior noise),
`noise` and `timesteps`.  Inside a `torch.distributed` group the step is
data-parallel as `make_train_step`'s is: global-batch draws of which each
rank keeps its rows (`BatchShard`), gradients and loss averaged across the
ranks before the global norm, rank 0's UNet broadcast at `init_state`, and
the LR scaled by the world size under `scale_lr`.

`SDInpaintingPipeline` reuses the BrushNet pipeline's host machinery
(prompt encoding, image processor, VAE) and keeps the dataset's mask
convention (mirror = 1).  The JAX pipeline assembles the mask, the masked
latents and depth `concat` only, so a UNet trained in depth `latents` or any
normals mode fails there at conv_in's channel count; this one raises
ValueError for those modes when it is built.
"""

from __future__ import annotations

import contextlib
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from reflecting_reality_tpu_torch.core.device import fp32_convolutions, resolve_device
from reflecting_reality_tpu_torch.ops.embeddings import precompute_time_embeddings
from reflecting_reality_tpu_torch.parallel import multihost
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
    _nhwc,
    to_uint8,
)
from reflecting_reality_tpu_torch.pipelines.image_processor import interpolate_nearest
from reflecting_reality_tpu_torch.schedulers.common import (
    NoiseSchedule,
    add_noise,
    ddim_timesteps,
    get_velocity,
)
from reflecting_reality_tpu_torch.schedulers.ddim import ddim_step
from reflecting_reality_tpu_torch.schedulers.unipc import UniPCSampler
from reflecting_reality_tpu_torch.training.train_step import (
    BatchShard,
    TrainConfig,
    TrainState,
    _global_norm,
    _nchw,
    _sample,
    apply_update,
    diffusion_loss,
    gradients_and_loss,
    lr_schedule,
    make_optimizer,
    nearest_resize,
)


def baseline_in_channels(depth_mode: Optional[str], normals_mode: Optional[str]) -> int:
    """4 latents + 1 mask + 4 masked latents + the conditioning extras."""
    return (9 + {"concat": 1, "latents": 4, None: 0}[depth_mode]
            + {"concat": 3, "latents": 4, None: 0}[normals_mode])


def inflate_conv_in(weight: torch.Tensor, in_channels: int, preserve: int = 4) -> torch.Tensor:
    """conv_in's (cout, cin, 3, 3) weight widened to `in_channels` inputs:
    the first `preserve` copied, the rest zero."""
    out = weight.new_zeros((weight.shape[0], in_channels, *weight.shape[2:]))
    out[:, :preserve] = weight[:, :preserve]
    return out


def assemble_baseline_input(vae: nn.Module, batch: Mapping[str, Any], noisy_latents: torch.Tensor,
                            config: TrainConfig, generator: Optional[torch.Generator] = None,
                            vae_noise: Optional[Mapping[str, torch.Tensor]] = None,
                            shard: BatchShard = BatchShard()) -> torch.Tensor:
    """concat(noisy, mask, masked latents, depth?, normals?) at latent
    resolution, NCHW, from an NHWC batch.  Posterior draws from `vae_noise`
    where given, else from `generator` (the global batch's, `shard`'s rows
    kept).  Call it under `no_grad`."""
    device = next(vae.parameters()).device
    vae_noise = vae_noise or {}

    def enc(key: str, img: torch.Tensor) -> torch.Tensor:
        return (_sample(vae.encode(img), vae_noise.get(key), generator, shard)
                * config.scaling_factor)

    def resized(key: str) -> torch.Tensor:
        return nearest_resize(_nchw(batch[key], device), hl, wl).to(cond.dtype)

    cond = enc("cond", _nchw(batch["conditioning_pixel_values"], device))
    hl, wl = cond.shape[2:]
    cond = torch.cat([resized("masks"), cond], dim=1)            # mask FIRST
    if config.depth_conditioning_mode == "concat":
        cond = torch.cat([cond, resized("depths")], dim=1)
    elif config.depth_conditioning_mode == "latents":
        d = enc("depth", _nchw(batch["depths"], device).repeat(1, 3, 1, 1))
        cond = torch.cat([cond, d.to(cond.dtype)], dim=1)
    if config.normals_conditioning_mode == "concat":
        cond = torch.cat([cond, resized("normals")], dim=1)
    elif config.normals_conditioning_mode == "latents":
        cond = torch.cat([cond, enc("normals", _nchw(batch["normals"], device)).to(cond.dtype)],
                         dim=1)
    return torch.cat([noisy_latents.to(cond.dtype), cond], dim=1)


def make_baseline_train_step(unet: nn.Module, vae: nn.Module, text_encoder: nn.Module,
                             config: TrainConfig, dtype: torch.dtype = torch.float32,
                             device=None):
    """-> (train_step, init_state) for the whole-UNet fine-tune.

    `init_state()` moves the modules to `device` (the card unless "cpu"),
    freezes the VAE and text encoder and builds AdamW over every UNet
    parameter.  `train_step(state, batch, generator=None, draws=None) ->
    (state, {"loss", "grad_norm"})` (0-d tensors; the norm before
    clipping).  Under `dtype=torch.bfloat16` the forwards run under autocast
    and the parameters stay as they are stored."""
    if config.prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError(config.prediction_type)
    schedule = NoiseSchedule.create(
        num_train_timesteps=config.num_train_timesteps,
        beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
        prediction_type=config.prediction_type,
    )
    shard = BatchShard(*multihost.rank_and_world())
    schedule_fn = lr_schedule(config, shard.world)
    device = resolve_device(device)

    def init_state() -> TrainState:
        for m in (unet, vae, text_encoder):
            m.to(device)
        vae.requires_grad_(False)
        text_encoder.requires_grad_(False)
        unet.requires_grad_(True)
        params = list(unet.parameters())
        multihost.broadcast_from_main(params)
        optimizer, _ = make_optimizer(config, params, shard.world)
        return TrainState(step=0, trainable={"unet": unet},
                          frozen={"vae": vae, "text": text_encoder},
                          optimizer=optimizer, params=params)

    def autocast():
        if dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=dtype)

    def compute_loss(batch: Mapping[str, Any], generator, draws) -> torch.Tensor:
        vae_noise = draws.get("vae_noise") or {}
        with torch.no_grad(), autocast():
            latents = _sample(vae.encode(_nchw(batch["pixel_values"], device)),
                              vae_noise.get("latents"), generator, shard) * config.scaling_factor
            latents = latents.float()
            noise, timesteps = draws.get("noise"), draws.get("timesteps")
            noise = (shard.randn(latents.shape, generator, device) if noise is None
                     else shard.local(noise))
            timesteps = (shard.randint(config.num_train_timesteps, latents.shape[0], generator,
                                       device) if timesteps is None else shard.local(timesteps))
            noise, timesteps = noise.to(device).float(), timesteps.to(device).long()
            noisy = add_noise(schedule, latents, noise, timesteps)
            combined = assemble_baseline_input(vae, batch, noisy, config, generator, vae_noise,
                                               shard)
            ehs = text_encoder(torch.as_tensor(batch["input_ids"], device=device).long())
        with autocast():
            pred = unet(combined.to(dtype), timesteps, ehs.to(dtype))
        if config.prediction_type == "epsilon":
            target = noise
        else:
            target = get_velocity(schedule, latents, noise, timesteps)
        return diffusion_loss(pred, target, timesteps, schedule, config)

    def train_step(state: TrainState, batch: Mapping[str, Any],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, Any]] = None):
        with fp32_convolutions(dtype):
            loss = compute_loss(batch, generator, draws or {})
            loss.backward()
        grads, loss = gradients_and_loss(state.params, loss)
        grad_norm = _global_norm(grads)
        apply_update(state, grads, config, schedule_fn)
        for p in state.params:
            p.grad = None
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return train_step, init_state


class SDInpaintingPipeline:
    """Inference for the baseline: one 9(+)-channel UNet with the
    conditioning concatenated into its input, UniPC or DDIM with CFG, the
    VAE decode and the uint8 conversion on the device.  `device` defaults
    to the card."""

    def __init__(self, vae, text_encoder, tokenizer, unet,
                 schedule: Optional[NoiseSchedule] = None,
                 depth_conditioning_mode: Optional[str] = None,
                 normals_conditioning_mode: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None):
        if depth_conditioning_mode not in (None, "concat") or normals_conditioning_mode is not None:
            raise ValueError(
                "the SD-inpainting baseline pipeline assembles the mask, the masked-image "
                "latents and depth 'concat' only, as the JAX package's does; "
                f"depth_conditioning_mode={depth_conditioning_mode!r}, "
                f"normals_conditioning_mode={normals_conditioning_mode!r} are not supported")
        want = baseline_in_channels(depth_conditioning_mode, None)
        if unet.in_channels != want:
            raise ValueError(f"the UNet takes {unet.in_channels} input channels; the baseline "
                             f"with depth_conditioning_mode={depth_conditioning_mode!r} "
                             f"gives it {want}")
        # the BrushNet pipeline's host machinery; its branch is never run
        self._base = StableDiffusionBrushNetPipeline(
            vae=vae, text_encoder=text_encoder, tokenizer=tokenizer, unet=unet, brushnet=unet,
            schedule=schedule, depth_conditioning_mode=depth_conditioning_mode,
            dtype=dtype, device=device)
        self.unet = self._base.unet
        self.device, self.dtype = self._base.device, dtype

    @property
    def image_processor(self):
        return self._base.image_processor

    def __call__(self, *args, **kwargs):
        """Generate (see `generate`), with full-fp32 convolutions at fp32
        (`core.device.fp32_convolutions`)."""
        with fp32_convolutions(self.dtype):
            return self.generate(*args, **kwargs)

    @torch.inference_mode()
    def generate(self, prompt, image, mask, depth=None, normals=None, height=None, width=None,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5, seed: int = 0,
                 scheduler: str = "unipc", output_type: str = "np", latents=None,
                 vae_noise=None):
        """One image; `output_type` as the BrushNet pipeline's.  The
        generator seeded with `seed` draws the initial noise, then the VAE's
        sampling noise; `latents` and `vae_noise` ((1, H/8, W/8, 4) NHWC)
        replace those draws."""
        b, dev, dtype = self._base, self.device, self.dtype
        do_cfg = guidance_scale > 1.0
        generator = torch.Generator(dev).manual_seed(seed)
        embeds = b.encode_prompt(prompt, None, 1, do_cfg).to(dtype)
        image_np = b.image_processor.preprocess(image, height, width)
        mask_np = b.image_processor.preprocess(mask, height, width)
        h, w = image_np.shape[1:3]
        # the dataset's convention, mirror = 1 (no < 0 trick)
        mask_np = (mask_np.sum(-1, keepdims=True) > 0).astype(np.float32)
        hl, wl = h // 8, w // 8
        planes = [interpolate_nearest(mask_np, hl, wl)]
        if b.depth_conditioning_mode == "concat":
            planes.append(interpolate_nearest(
                b.image_processor.preprocess(depth, h, w)[..., :1], hl, wl))

        if latents is None:
            lat = torch.randn((1, 4, hl, wl), generator=generator, device=dev)
        else:
            lat = _nchw(np.asarray(latents), dev).float()
        dist = b.vae.encode(_nchw(image_np, dev).to(dtype))
        noise = None if vae_noise is None else _nchw(np.asarray(vae_noise), dev)
        masked = _sample(dist, noise, generator) * b.scaling_factor
        extra = _nchw(np.concatenate(planes, axis=-1), dev).to(masked.dtype)
        cond = torch.cat([extra[:, :1], masked, extra[:, 1:]], dim=1)   # mask FIRST
        cond_b = torch.cat([cond, cond]) if do_cfg else cond

        if scheduler == "unipc":
            sampler = UniPCSampler(b.schedule, num_inference_steps)
            timesteps = sampler.timesteps
            state = sampler.init_state(lat)
        elif scheduler == "ddim":
            timesteps = ddim_timesteps(b.schedule.num_train_timesteps, num_inference_steps)
        else:
            raise ValueError(scheduler)
        temb = precompute_time_embeddings(self.unet, timesteps)
        for i in range(num_inference_steps):
            latent_in = torch.cat([lat, lat]) if do_cfg else lat
            inp = torch.cat([latent_in, cond_b.to(latent_in.dtype)], dim=1)
            pred = self.unet(inp.to(dtype), None, embeds, temb=temb[i:i + 1])
            if do_cfg:
                u, c = pred.chunk(2)
                pred = u.float() + float(np.float32(guidance_scale)) * (c - u).float()
            if scheduler == "unipc":
                lat, state = sampler.step(pred.float(), i, lat, state)
            else:
                t_prev = int(timesteps[i + 1]) if i + 1 < num_inference_steps else -1
                lat = ddim_step(b.schedule, pred.float(), int(timesteps[i]), t_prev, lat)

        image_out = b.vae.decode((lat / b.scaling_factor).to(dtype)).float()
        if output_type == "latent":
            return _nhwc(image_out).cpu().numpy()
        image_u8 = _nhwc(to_uint8(image_out))
        if output_type == "device":
            return image_u8
        return b.image_processor.postprocess(image_u8.cpu().numpy(), output_type=output_type)
