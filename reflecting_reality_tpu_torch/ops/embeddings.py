"""Timestep embeddings (counterpart of `reflecting_reality_tpu/ops/embeddings.py`;
reference: src/diffusers/models/embeddings.py).

`get_timestep_embedding` is the SD-1.5 sinusoid (flip_sin_to_cos=True,
downscale_freq_shift=0) in fp32, `TimestepEmbedding` the 2-layer SiLU MLP
(linear_1/linear_2), and `precompute_time_embeddings` builds the per-step
table once, outside the denoise loop.  `text_time_embedding` is SDXL's
micro-conditioning term (`addition_embed_type="text_time"`, JAX
`models/unet2d.py:146-157`), added to the time embedding.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
) -> torch.Tensor:
    """Sinusoidal embeddings of a 1-D timestep tensor (max period 10000);
    fp32 regardless of input."""
    if timesteps.dim() != 1:
        raise ValueError("timesteps must be 1-D")
    half_dim = embedding_dim // 2
    exponent = -math.log(10000) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """time_embedding MLP: linear_1 -> silu -> linear_2."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


def time_embedding(model: nn.Module, timesteps: torch.Tensor) -> torch.Tensor:
    """Sinusoid + `model.time_embedding` MLP for a UNet or BrushNet, in the
    model's parameter dtype."""
    dtype = model.time_embedding.linear_1.weight.dtype
    t_emb = get_timestep_embedding(
        timesteps, model.block_out_channels[0],
        flip_sin_to_cos=model.flip_sin_to_cos, downscale_freq_shift=model.freq_shift,
    ).to(dtype)
    return model.time_embedding(t_emb)


@torch.no_grad()
def precompute_time_embeddings(model: nn.Module, timesteps) -> torch.Tensor:
    """The (N, 4·bocs[0]) table of time embeddings for all sampler steps at
    once; the denoise loop passes row i back as the model's `temb`."""
    device = model.time_embedding.linear_1.weight.device
    return time_embedding(model, torch.as_tensor(timesteps, device=device))


def text_time_embedding(model: nn.Module, added_cond_kwargs: dict,
                        dtype: torch.dtype) -> torch.Tensor:
    """SDXL's `text_time` term for a UNet or BrushNet: the sinusoids of the
    (B, 6) `time_ids` (width `addition_time_embed_dim` each) concatenated in
    fp32 after the pooled `text_embeds`, cast to `dtype`, through the
    model's `add_embedding` MLP -> (B, 4·bocs[0]), one row a sample."""
    text_embeds = added_cond_kwargs["text_embeds"]
    time_ids = torch.as_tensor(added_cond_kwargs["time_ids"], device=text_embeds.device)
    t_ids = get_timestep_embedding(
        time_ids.reshape(-1), model.addition_time_embed_dim,
        flip_sin_to_cos=model.flip_sin_to_cos, downscale_freq_shift=model.freq_shift,
    ).reshape(text_embeds.shape[0], -1)
    aug = torch.cat([text_embeds.float(), t_ids], dim=-1)
    return model.add_embedding(aug.to(dtype))


def add_embedding_for(model: nn.Module, temb_ch: int) -> Optional[TimestepEmbedding]:
    """The `text_time` MLP of a UNet or BrushNet config, or None without one
    (the only `addition_embed_type` the JAX package reads)."""
    if model.addition_embed_type is None:
        return None
    if model.addition_embed_type != "text_time":
        raise ValueError(f"addition_embed_type={model.addition_embed_type!r}: only "
                         "'text_time' is supported")
    if model.projection_class_embeddings_input_dim is None:
        raise ValueError("addition_embed_type='text_time' needs "
                         "projection_class_embeddings_input_dim")
    return TimestepEmbedding(model.projection_class_embeddings_input_dim, temb_ch)


def added_time_embedding(model: nn.Module, emb: torch.Tensor, temb: Optional[torch.Tensor],
                         added_cond_kwargs: Optional[dict], dtype: torch.dtype) -> torch.Tensor:
    """`emb` plus the `text_time` term of `added_cond_kwargs`.  A `text_time`
    model needs them unless the caller passed `temb` with the term already
    added (the pipeline's per-call table)."""
    if added_cond_kwargs is not None and model.add_embedding is not None:
        return emb + text_time_embedding(model, added_cond_kwargs, dtype)
    if model.add_embedding is not None and temb is None:
        raise ValueError("addition_embed_type='text_time' needs added_cond_kwargs "
                         "(text_embeds, time_ids)")
    return emb

