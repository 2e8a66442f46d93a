"""Transformer2DModel / BasicTransformerBlock / GEGLU feed-forward
(counterpart of `reflecting_reality_tpu/ops/transformer.py`; reference:
src/diffusers/models/transformers/transformer_2d.py:44, attention.py:97).

SD-1.5 uses use_linear_projection=False: GroupNorm -> 1x1 conv proj_in ->
flatten to tokens -> [self-attn, cross-attn, GEGLU-FF] x N -> 1x1 conv
proj_out -> residual add.  LayerNorm eps is 1e-5; gelu is exact.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from reflecting_reality_tpu_torch.ops.attention import Attention
from reflecting_reality_tpu_torch.ops.norms import GroupNorm


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """ff.net.0 = GEGLU(dim -> 4*dim), ff.net.2 = Linear(4*dim -> dim)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_attention_heads: int, attention_head_dim: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_attention_heads, attention_head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_attention_heads, attention_head_dim,
                               cross_attention_dim=cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), encoder_hidden_states=encoder_hidden_states) + x
        return self.ff(self.norm3(x)) + x


class Transformer2DModel(nn.Module):
    def __init__(self, in_channels: int, num_attention_heads: int, attention_head_dim: int,
                 num_layers: int = 1, cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 32, use_linear_projection: bool = False):
        super().__init__()
        inner = num_attention_heads * attention_head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(in_channels, inner)
            self.proj_out = nn.Linear(inner, in_channels)
        else:
            self.proj_in = nn.Conv2d(in_channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, in_channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, num_attention_heads, attention_head_dim,
                                  cross_attention_dim=cross_attention_dim)
            for _ in range(num_layers)
        ])

    def forward(self, x: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear_projection:
            x = self.proj_in(x.reshape(b, c, h * w).transpose(1, 2))
        else:
            x = self.proj_in(x)
            x = x.reshape(b, x.shape[1], h * w).transpose(1, 2)
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden_states=encoder_hidden_states)
        if self.use_linear_projection:
            x = self.proj_out(x).transpose(1, 2).reshape(b, c, h, w)
        else:
            x = self.proj_out(x.transpose(1, 2).reshape(b, -1, h, w))
        return x + residual
