"""Timestep embeddings (counterpart of `reflecting_reality_tpu/ops/embeddings.py`;
reference: src/diffusers/models/embeddings.py).

`get_timestep_embedding` is the SD-1.5 sinusoid (flip_sin_to_cos=True,
downscale_freq_shift=0) in fp32, `TimestepEmbedding` the 2-layer SiLU MLP
(linear_1/linear_2), and `precompute_time_embeddings` builds the per-step
table once, outside the denoise loop.
"""

from __future__ import annotations

import math

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
