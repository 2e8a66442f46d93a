"""FluxFillPipeline: FLUX.1 Fill [dev] inpainting (reference: diffusers
pipeline_flux_fill.py `FluxFillPipeline`, which runs
`FluxTransformer2DModel`, CLIP-L, the T5 v1.1 XXL encoder, the 16-channel
`AutoencoderKL` and `FlowMatchEulerDiscreteScheduler`).

Each call, at batch 1 per prompt (guidance is distilled into the model: no
CFG batch):

- text: the T5 encoder over the prompt padded to `max_sequence_length`
  (512) tokens -> the joint sequence's text states; CLIP-L's pooled output
  over 77 tokens -> the pooled projection (memoized per prompt);
- conditioning: the image to [-1, 1] (bicubic to a multiple of 16), the
  mask to {0, 1} (first channel, 1 = fill), the masked image
  image x (1 - mask) VAE-encoded (sampled, or its mean with
  `deterministic_vae_encode`) to (z - shift) x scale and packed 2x2 to 64
  channels, the mask folded 8x8 space-to-depth to 64 channels and packed to
  256: 320 conditioning channels beside the 64 of the latents -> 384;
- denoise: the sigmas of `schedulers/flow_match.py` (shifted by
  mu = 1.15 at 4096 image tokens), each step one transformer forward at
  timestep sigma with guidance `guidance_scale`, then the Euler step;
- decode: unpack, z / scale + shift, VAE decode, uint8 on the device.

Packing follows diffusers `_pack_latents`: (B, C, H, W) -> (B, H/2 x W/2,
4C), channel c x 4 + 2 dy + dx of token (row, col).  Image ids are
(0, row, col) on the packed grid, text ids zeros; the transformer's rotary
tables are computed once a size.

The latents stay in fp32 between steps and the model sees them in the
pipeline's dtype (diffusers rounds them to the model's dtype after each
step); the initial noise is drawn in fp32 from `generator` first, then the
VAE's sampling noise, and `latents=` (B, H/8, W/8, 16) NHWC overrides it.

Counters (`stats()`): calls, denoise steps, the joint tokens of the last
step, and the attention calls by route: the transformer's joint attentions
("flash" on the card; 57 a step for FLUX.1), and apart
from them the plain attentions of the text encoders (T5 and CLIP, one a
layer) and of the VAE's mid blocks (one an encode or decode; 16,384 tokens
at head dim 512 at 1024², above B1's 160).

Spans (`core/tracing.py`): `rr.pipeline.call` holding `rr.pipeline.text`
(with `rr.t5` around the T5 encode), `rr.pipeline.conditioning`,
`rr.pipeline.denoise` (one `rr.pipeline.step` a step, each holding
`rr.transformer` and `rr.pipeline.scheduler`; the transformer opens
`rr.flux.double` and `rr.flux.single`), `rr.pipeline.decode` and
`rr.pipeline.output`.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Optional, Sequence, Union

import numpy as np
import torch

from reflecting_reality_tpu_torch.core import tracing
from reflecting_reality_tpu_torch.core.device import fp32_convolutions, resolve_device
from reflecting_reality_tpu_torch.models.clip_text import _CLIPAttention
from reflecting_reality_tpu_torch.models.t5 import _SelfAttention
from reflecting_reality_tpu_torch.ops import attention
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import _nchw, _nhwc, to_uint8
from reflecting_reality_tpu_torch.pipelines.image_processor import ImageProcessor
from reflecting_reality_tpu_torch.schedulers.flow_match import euler_step, flow_match_sigmas


def pack_latents(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H/2 x W/2, 4C)."""
    b, c, h, w = x.shape
    return (x.view(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
            .reshape(b, (h // 2) * (w // 2), c * 4))


def unpack_latents(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H/2 x W/2, 4C) -> (B, C, H, W), the inverse of `pack_latents`."""
    b, _, c4 = x.shape
    return (x.view(b, h // 2, w // 2, c4 // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
            .reshape(b, c4 // 4, h, w))


def pack_mask(mask: torch.Tensor, scale: int = 8) -> torch.Tensor:
    """(B, H, W) pixel mask -> (B, H/16 x W/16, 4 scale²): each latent
    pixel's scale x scale block as channels (dy x scale + dx), packed."""
    b, h, w = mask.shape
    folded = (mask.view(b, h // scale, scale, w // scale, scale).permute(0, 2, 4, 1, 3)
              .reshape(b, scale * scale, h // scale, w // scale))
    return pack_latents(folded)


def image_ids(h: int, w: int, device) -> torch.Tensor:
    """(h x w, 3) ids (0, row, col) of the packed grid's tokens."""
    rows = torch.arange(h, device=device)[:, None].expand(h, w)
    cols = torch.arange(w, device=device)[None, :].expand(h, w)
    return torch.stack([torch.zeros_like(rows), rows, cols], dim=-1).reshape(h * w, 3).float()


def _folder_weights(root: str, names: Sequence[str]) -> dict:
    """A folder's safetensors: one file, or the shards a
    `<name>.index.json` lists."""
    from reflecting_reality_tpu_torch.core.io import load_safetensors

    for name in names:
        index = os.path.join(root, name + ".index.json")
        if os.path.exists(index):
            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            out = {}
            for shard in shards:
                out.update(load_safetensors(os.path.join(root, shard)))
            return out
        if os.path.exists(os.path.join(root, name)):
            return load_safetensors(os.path.join(root, name))
    raise FileNotFoundError(f"no safetensors weights under {root} ({', '.join(names)})")


def _load(cls, root: str, names: Sequence[str], dtype: torch.dtype, prepare=None):
    """`cls` from `root`'s config.json, built in `dtype` on the CPU and
    loaded strictly from its safetensors."""
    from reflecting_reality_tpu_torch.core.io import load_into

    with torch.device("meta"):
        module = cls.from_config(cls.load_config(root))
    module = module.to(dtype).to_empty(device="cpu")
    weights = _folder_weights(root, names)
    if prepare is not None:
        weights = prepare(weights)
    return load_into(module, weights, where=root).eval()


def _t5_weights(weights: dict) -> dict:
    """`shared` and `encoder.embed_tokens` are one tensor: a file may hold
    either name (or both)."""
    for a, b in (("shared.weight", "encoder.embed_tokens.weight"),
                 ("encoder.embed_tokens.weight", "shared.weight")):
        if a in weights and b not in weights:
            weights[b] = weights[a]
    return weights


def _clip_weights(weights: dict) -> dict:
    return {k: v for k, v in weights.items() if not k.endswith("position_ids")}


class FluxFillPipeline:
    """Inference over torch modules (transformer, vae, text_encoder CLIP-L,
    text_encoder_2 T5) and two tokenizers, moved to `device` and cast to
    `dtype`; `device` defaults to the card."""

    _MODULES = ("transformer", "vae", "text_encoder", "text_encoder_2")

    def __init__(self, transformer, vae, text_encoder, text_encoder_2, tokenizer, tokenizer_2,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None,
                 max_sequence_length: int = 512):
        self.device = resolve_device(device)
        self.dtype = dtype
        for name, module in zip(self._MODULES, (transformer, vae, text_encoder, text_encoder_2)):
            setattr(self, name, module.to(self.device, dtype).eval())
        self.tokenizer, self.tokenizer_2 = tokenizer, tokenizer_2
        self.max_sequence_length = max_sequence_length
        self.vae_scale_factor = 2 ** (len(vae.block_out_channels) - 1)
        self.scaling_factor = vae.scaling_factor
        self.shift_factor = vae.shift_factor or 0.0
        self.image_processor = ImageProcessor(vae_scale_factor=2 * self.vae_scale_factor)
        self._prompt_cache = {}
        self._rope_cache = {}
        self._counts = Counter()
        for key, modules, cls in (
                ("attention.text.plain", (self.text_encoder, self.text_encoder_2),
                 (_CLIPAttention, _SelfAttention)),
                ("attention.vae.plain", (self.vae,), attention.Attention)):
            for m in (m for module in modules for m in module.modules()):
                if isinstance(m, cls):
                    m.register_forward_pre_hook(self._counter(key))

    @classmethod
    def from_pretrained(cls, path: str, dtype: torch.dtype = torch.bfloat16,
                        device: Union[str, torch.device, None] = None, tokenizer=None,
                        tokenizer_2=None) -> "FluxFillPipeline":
        """Load a diffusers-layout FLUX.1 Fill folder: `transformer/`,
        `vae/` (config.json + diffusion_pytorch_model.safetensors or its
        shards), `text_encoder/` and `text_encoder_2/` (config.json +
        model.safetensors or its shards), `tokenizer/` (CLIP BPE).  The port
        has no SentencePiece reader: `tokenizer_2` defaults to
        `T5HashTokenizer`, so real prompts need T5's tokenizer passed in."""
        from reflecting_reality_tpu_torch.data.tokenizer import CLIPTokenizer, T5HashTokenizer
        from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
        from reflecting_reality_tpu_torch.models.flux_transformer import FluxTransformer2DModel
        from reflecting_reality_tpu_torch.models.t5 import T5EncoderModel
        from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

        device = resolve_device(device)  # fail before loading anything
        diffusers = ("diffusion_pytorch_model.safetensors",)
        hf = ("model.safetensors",)
        if tokenizer is None:
            tokenizer = CLIPTokenizer.from_pretrained(path, subfolder="tokenizer")
        return cls(
            transformer=_load(FluxTransformer2DModel, os.path.join(path, "transformer"),
                              diffusers, dtype),
            vae=_load(AutoencoderKL, os.path.join(path, "vae"), diffusers, dtype),
            text_encoder=_load(CLIPTextModel, os.path.join(path, "text_encoder"), hf, dtype,
                               _clip_weights),
            text_encoder_2=_load(T5EncoderModel, os.path.join(path, "text_encoder_2"), hf, dtype,
                                 _t5_weights),
            tokenizer=tokenizer, tokenizer_2=tokenizer_2 or T5HashTokenizer(),
            dtype=dtype, device=device)

    # -------------------------------------------------------------- counters

    def _counter(self, key: str):
        def count(module, args) -> None:
            self._counts[key] += 1
        return count

    def stats(self) -> dict:
        """Calls, denoise steps, the last step's joint tokens and the
        attention calls by route since the pipeline was built."""
        c = self._counts
        return {"calls": c["calls"], "steps": c["steps"], "joint_tokens": c["joint_tokens"],
                "attention": {"joint": {"flash": c["attention.joint.flash"],
                                        "plain": c["attention.joint.plain"]},
                              "text": {"plain": c["attention.text.plain"]},
                              "vae": {"plain": c["attention.vae.plain"]}}}

    # ------------------------------------------------------------------ text

    @torch.inference_mode()
    def encode_prompt(self, prompts: Sequence[str]):
        """-> (T5 states (B, L, 4096), pooled CLIP (B, 768)), in the
        pipeline's dtype; memoized per prompt list."""
        key = tuple(prompts)
        out = self._prompt_cache.get(key)
        if out is None:
            ids = torch.as_tensor(np.asarray(self.tokenizer(list(prompts))), dtype=torch.long,
                                  device=self.device)
            pooled = self.text_encoder.pooled_output(ids)
            ids2 = torch.as_tensor(np.asarray(self.tokenizer_2(list(prompts))),
                                   dtype=torch.long, device=self.device)
            ids2 = ids2[:, : self.max_sequence_length]
            with tracing.span("rr.t5"):
                states = self.text_encoder_2(ids2)
            out = (states, pooled)
            if len(self._prompt_cache) < 256:
                self._prompt_cache[key] = out
        return out

    # ---------------------------------------------------------- conditioning

    def _latents_and_conditioning(self, image, mask, height, width, batch_size: int,
                                  generator, latents, deterministic_vae_encode: bool):
        """-> (packed noise (B, N, 64) fp32, packed conditioning (B, N, 320)
        in the pipeline's dtype, (H, W))."""
        dev, dtype = self.device, self.dtype
        image_np = self.image_processor.preprocess(image, height, width)
        h, w = image_np.shape[1:3]
        mask_np = self.image_processor.preprocess(mask, h, w)[..., 0]
        # [-1, 1] back to [0, 1], then binarised at 0.5 (diffusers' mask processor)
        mask_np = (mask_np >= 0.0).astype(np.float32)
        reps = batch_size // image_np.shape[0]
        packed = _nchw(np.concatenate([image_np, mask_np[..., None]], axis=-1)).to(dev)
        image_dev, mask_dev = packed[:, :3], packed[:, 3]
        hl, wl = h // self.vae_scale_factor, w // self.vae_scale_factor
        if latents is None:
            noise = torch.randn((batch_size, self.vae.latent_channels, hl, wl),
                                generator=generator, device=dev, dtype=torch.float32)
        else:
            noise = _nchw(latents).to(dev, torch.float32)
        dist = self.vae.encode((image_dev * (1.0 - mask_dev[:, None])).to(dtype))
        z = dist.mode if deterministic_vae_encode else dist.sample(generator)
        z = pack_latents((z.float() - self.shift_factor) * self.scaling_factor)
        cond = torch.cat([z, pack_mask(mask_dev, self.vae_scale_factor)], dim=-1)
        if reps > 1:
            cond = cond.repeat_interleave(reps, dim=0)
        return pack_latents(noise), cond.to(dtype), (h, w)

    def _rope(self, hp: int, wp: int, text_len: int):
        key = (hp, wp, text_len)
        if key not in self._rope_cache:
            img = image_ids(hp, wp, self.device)
            txt = torch.zeros(text_len, 3, device=self.device)
            self._rope_cache[key] = (img, txt, self.transformer.rope(img, txt))
        return self._rope_cache[key]

    # ------------------------------------------------------------------ call

    def __call__(self, *args, **kwargs):
        """Generate (see `generate`), with full-fp32 convolutions at fp32."""
        with fp32_convolutions(self.dtype):
            return self.generate(*args, **kwargs)

    @torch.inference_mode()
    def generate(
        self,
        prompt: Union[str, Sequence[str]],
        image,                                  # the image to fill (NHWC, [0, 255] or [0, 1])
        mask,                                   # white = fill
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 30.0,
        num_images_per_prompt: int = 1,
        seed: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        latents=None,                           # (B, H/8, W/8, 16) NHWC initial noise
        output_type: str = "np",
        deterministic_vae_encode: bool = False,
    ):
        """Generate; returns images per `output_type`: "np" (uint8 NHWC),
        "pil", "latent" (the decoded float image, NHWC numpy) or "device"
        (uint8 NHWC tensor left on the device)."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        prompts = [p for p in prompts for _ in range(num_images_per_prompt)]
        batch_size = len(prompts)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0 if seed is None else seed)
        with tracing.span("rr.pipeline.call", batch_size=batch_size,
                          steps=num_inference_steps) as call:
            with tracing.span("rr.pipeline.text"):
                states, pooled = self.encode_prompt(prompts)
            with tracing.span("rr.pipeline.conditioning"):
                lat, cond, (h, w) = self._latents_and_conditioning(
                    image, mask, height, width, batch_size, generator, latents,
                    deterministic_vae_encode)
            call.set(height=h)
            hp, wp = h // (2 * self.vae_scale_factor), w // (2 * self.vae_scale_factor)
            img_ids, txt_ids, rope = self._rope(hp, wp, states.shape[1])
            sigmas = flow_match_sigmas(num_inference_steps, hp * wp)
            guidance = torch.full((batch_size,), float(guidance_scale), device=self.device)
            self._counts["calls"] += 1
            with tracing.span("rr.pipeline.denoise"):
                for i in range(num_inference_steps):
                    with tracing.span("rr.pipeline.step", i=i):
                        x = torch.cat([lat.to(self.dtype), cond], dim=-1)
                        t = torch.full((batch_size,), float(sigmas[i]), device=self.device)
                        routed = attention.routes.copy()
                        with tracing.span("rr.transformer", i=i):
                            v = self.transformer(x, states, pooled, t, img_ids, txt_ids,
                                                 guidance, rope=rope)
                        for route, n in (attention.routes - routed).items():
                            self._counts["attention.joint." + route] += n
                        with tracing.span("rr.pipeline.scheduler", i=i):
                            lat = euler_step(lat, v, sigmas[i], sigmas[i + 1])
                    self._counts["steps"] += 1
                    self._counts["joint_tokens"] = x.shape[1] + states.shape[1]
            with tracing.span("rr.pipeline.decode"):
                z = unpack_latents(lat, 2 * hp, 2 * wp) / self.scaling_factor + self.shift_factor
                image_out = self.vae.decode(z.to(self.dtype)).float()
            with tracing.span("rr.pipeline.output"):
                if output_type == "latent":
                    return _nhwc(image_out).cpu().numpy()
                image_u8 = _nhwc(to_uint8(image_out))
                if output_type == "device":
                    return image_u8
                return self.image_processor.postprocess(image_u8.cpu().numpy(),
                                                        output_type=output_type)
