"""Attention for the SD-1.5 UNet and VAE (counterpart of
`reflecting_reality_tpu/ops/attention.py`).

`dot_product_attention(q, k, v, backend=None)` takes (B, T, H, D), the JAX
layout, and JAX's backend names.  `"xla"` takes the plain path below
whatever the device and shape.  `None` or `"flash"` routes by the tensors'
device and shape, by one rule:

- CUDA tensors whose head dim the kernels take (D % 8 == 0 and D <=
  `_MAX_D` = 160) go to the flash kernels (`ops/kernels/flash_attention.py`),
  whatever their query and key lengths (Tk >= 1, Tq == Tk or not: self- and
  cross-attention alike): through the `FlashAttention` autograd Function
  (B1 forward, B3 + B4 backward) when a gradient is needed, straight to B1
  when not.  bf16 and fp32 both: the fp32 instances run 3xTF32 products,
  which keep fp32 accuracy.
- Everything else takes the plain path, the JAX einsum path (:69-72): fp32
  logits and softmax, probabilities cast to q.dtype before P V; torch
  autograd differentiates it.  That is CPU tensors, and head dims no kernel
  takes (161-256 or not a multiple of 8; the VAE's single 512-wide head).

The JAX package's TPU rule (`ops/attention.py:63-64`: Tq >= 2048, Tq == Tk)
is not this one: on the H100 B1 beats the plain path at every shape the
UNets give it (`chip_smoke.py`'s kernel table, H100 80GB HBM3): at SDXL's
(2, 1024, 20, 64) self-attention 0.039 against 0.617 ms, where the plain
path writes and rereads 168 MB of fp32 logits and runs Q K^T as an fp32
GEMM on the CUDA cores; over 77 text tokens 0.007-0.067 ms against
0.13-0.44.  The kernels take any lengths: keys past Tk in the last tile
are masked, query rows past Tq are dropped.

The backend is chosen per module, never by a process global (the JAX
package's `set_attention_backend(name)` sets one; a server's threads and
data-parallel replicas share this process): every `Attention` carries an
`attention_backend` attribute, "flash" by default, and passes it on both
its calls, and `set_attention_backend(module, name)` sets it on every
`Attention` of a module tree.

`Attention` keeps separate to_q/to_k/to_v parameters (diffusers names) and
concatenates them for one fused qkv (self) or kv (cross) product (:196-214);
the kernel reads the q/k/v column slices of that product in place.  In the
int8 mode (`ops/quant.py`) a group whose projections are all `Int8Linear`
fuses too: the codes and the per-channel scales are concatenated and run as
one int8 product with one activation scale (JAX `fuse`, :185-194); a group
that mixes float and int8 projections runs them one by one.  With
`ip_num_tokens` (IP-Adapter, JAX :124-131, :223-230) the last
`ip_num_tokens` context tokens attend through bias-free `to_k_ip` /
`to_v_ip` and are added with `ip_scale`; that attention has Tq != Tk and
takes the route of any other.

`routes` counts the calls of `dot_product_attention` by the route each took
("flash" or "plain"), where it is taken; a caller reads its own calls as
the difference across them.
"""

from __future__ import annotations

from collections import Counter
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
from reflecting_reality_tpu_torch.ops.quant import Int8Linear, dense_int8


#: calls of `dot_product_attention` by the route taken
routes: Counter = Counter()


def routes_to_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the flash kernels take attention of q (B, Tq, H, D) over k
    (B, Tk, H, D): any lengths, a head dim they have an instance for."""
    d = q.shape[-1]
    return k.shape[1] >= 1 and d <= _MAX_D and d % 8 == 0


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          backend: Optional[str] = None) -> torch.Tensor:
    """Scaled dot-product attention over (batch, tokens, heads, head_dim)."""
    if backend != "xla" and q.is_cuda and routes_to_flash(q, k):
        routes["flash"] += 1
        return flash_attention(q, k, v)
    routes["plain"] += 1
    return attention_plain(q, k, v)


def set_attention_backend(module: nn.Module, name: str) -> None:
    """Set the backend ("xla" or "flash") of every `Attention` in `module`."""
    assert name in ("xla", "flash")
    for m in module.modules():
        if isinstance(m, Attention):
            m.attention_backend = name


class Attention(nn.Module):
    """Self/cross attention (reference Attention module semantics)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None, qkv_bias: bool = False,
                 residual_connection: bool = False, norm_num_groups: Optional[int] = None,
                 ip_num_tokens: Optional[int] = None, ip_scale: float = 1.0):
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
        self.ip_num_tokens, self.ip_scale = ip_num_tokens, ip_scale
        self.attention_backend = "flash"
        if ip_num_tokens:
            self.to_k_ip = nn.Linear(ctx_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(ctx_dim, inner, bias=False)

    def _fused(self, x: torch.Tensor, projs) -> torch.Tensor:
        """One product for projections that share an input, their outputs
        side by side; projections that mix float and int8 run unfused."""
        int8 = [isinstance(p, Int8Linear) for p in projs]
        if any(int8) and not all(int8):
            return torch.cat([p(x) for p in projs], dim=-1)
        b = torch.cat([p.bias for p in projs]) if projs[0].bias is not None else None
        if all(int8):
            return dense_int8(x, torch.cat([p.weight_q for p in projs]),
                              torch.cat([p.weight_scale for p in projs]), b, projs[0].dtype)
        return F.linear(x, torch.cat([p.weight for p in projs], dim=0), b)

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
        ip_context = None
        if self.ip_num_tokens and encoder_hidden_states is not None:
            end = encoder_hidden_states.shape[1] - self.ip_num_tokens
            encoder_hidden_states, ip_context = (encoder_hidden_states[:, :end],
                                                 encoder_hidden_states[:, end:])
        if encoder_hidden_states is None:
            q, k, v = self._fused(hidden_states, (self.to_q, self.to_k, self.to_v)).split(inner, -1)
        else:
            q = self.to_q(hidden_states)
            k, v = self._fused(encoder_hidden_states, (self.to_k, self.to_v)).split(inner, -1)

        bq, tq = q.shape[:2]
        tk = k.shape[1]
        q = q.view(bq, tq, self.heads, self.dim_head)
        out = dot_product_attention(
            q,
            k.view(bq, tk, self.heads, self.dim_head),
            v.view(bq, tk, self.heads, self.dim_head),
            self.attention_backend,
        )
        if ip_context is not None:
            ti = ip_context.shape[1]
            out = out + self.ip_scale * dot_product_attention(
                q, self.to_k_ip(ip_context).view(bq, ti, self.heads, self.dim_head),
                self.to_v_ip(ip_context).view(bq, ti, self.heads, self.dim_head),
                self.attention_backend)
        out = self.to_out[0](out.reshape(bq, tq, inner))

        if spatial:
            out = out.transpose(1, 2).reshape(b, c, h, w)
        if self.residual_connection:
            out = out + residual
        return out
