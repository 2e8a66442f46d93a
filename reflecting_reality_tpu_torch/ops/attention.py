"""Attention for the SD-1.5 UNet and VAE (counterpart of
`reflecting_reality_tpu/ops/attention.py`).

`dot_product_attention(q, k, v)` takes (B, T, H, D), the JAX layout.  It
routes by the tensors' device and shape, never by a process global:

- CUDA tensors whose shape the JAX dispatch rule sends to flash
  (`ops/attention.py:63-64`: Tq >= 2048, Tq == Tk, Tq % 8 == 0) and whose
  head dim the kernels take (D % 8 == 0 and D <= `_MAX_D` = 160, SD-1.5's
  largest; JAX's rule allows any D <= 256) go to the flash kernels
  (`ops/kernels/flash_attention.py`): through the `FlashAttention` autograd
  Function (B1 forward, B3 + B4 backward) when a gradient is needed,
  straight to B1 when not.  That token threshold was measured on the TPU;
  re-deriving it for the H100 is later work.
- Everything else, head dims 161-256 (or not a multiple of 8) on the card
  included, takes the plain path, the JAX einsum path (:69-72): fp32
  logits and softmax, probabilities cast to q.dtype before P V; torch
  autograd differentiates it.

`Attention` keeps separate to_q/to_k/to_v parameters (diffusers names) and
concatenates them for one fused qkv (self) or kv (cross) product (:196-214);
the kernel reads the q/k/v column slices of that product in place.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from reflecting_reality_tpu_torch.ops.kernels.flash_attention import (
    _MAX_D,
    attention_plain,
    flash_attention,
)
from reflecting_reality_tpu_torch.ops.norms import GroupNorm


def routes_to_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's flash dispatch rule (ops/attention.py:63-64), with
    the head dims the kernels take (D % 8 == 0, D <= `_MAX_D`) in place of
    JAX's D <= 256."""
    t, d = q.shape[1], q.shape[-1]
    return t >= 2048 and t == k.shape[1] and t % 8 == 0 and d <= _MAX_D and d % 8 == 0


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention over (batch, tokens, heads, head_dim)."""
    if q.is_cuda and routes_to_flash(q, k):
        return flash_attention(q, k, v)
    return attention_plain(q, k, v)


class Attention(nn.Module):
    """Self/cross attention (reference Attention module semantics)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None, qkv_bias: bool = False,
                 residual_connection: bool = False, norm_num_groups: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.residual_connection = residual_connection
        self.group_norm = (GroupNorm(norm_num_groups, query_dim, eps=1e-6)
                           if norm_num_groups is not None else None)
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(ctx_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(ctx_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Identity()])

    def _fused(self, x: torch.Tensor, projs) -> torch.Tensor:
        w = torch.cat([p.weight for p in projs], dim=0)
        b = torch.cat([p.bias for p in projs]) if projs[0].bias is not None else None
        return F.linear(x, w, b)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hidden_states: (B, T, C) tokens, or (B, C, H, W) when spatial (VAE)."""
        residual = hidden_states
        spatial = hidden_states.dim() == 4
        if spatial:
            b, c, h, w = hidden_states.shape
            if self.group_norm is not None:
                hidden_states = self.group_norm(hidden_states)
            hidden_states = hidden_states.reshape(b, c, h * w).transpose(1, 2)

        inner = self.heads * self.dim_head
        if encoder_hidden_states is None:
            q, k, v = self._fused(hidden_states, (self.to_q, self.to_k, self.to_v)).split(inner, -1)
        else:
            q = self.to_q(hidden_states)
            k, v = self._fused(encoder_hidden_states, (self.to_k, self.to_v)).split(inner, -1)

        bq, tq = q.shape[:2]
        tk = k.shape[1]
        out = dot_product_attention(
            q.view(bq, tq, self.heads, self.dim_head),
            k.view(bq, tk, self.heads, self.dim_head),
            v.view(bq, tk, self.heads, self.dim_head),
        )
        out = self.to_out[0](out.reshape(bq, tq, inner))

        if spatial:
            out = out.transpose(1, 2).reshape(b, c, h, w)
        if self.residual_connection:
            out = out + residual
        return out
