"""FLUX.1's MMDiT (reference: src/diffusers/models/transformers/
transformer_flux.py `FluxTransformer2DModel`, `FluxTransformerBlock`,
`FluxSingleTransformerBlock`, `FluxAttnProcessor2_0`; normalization.py
`AdaLayerNormZero`, `AdaLayerNormZeroSingle`, `AdaLayerNormContinuous`;
embeddings.py `CombinedTimestepGuidanceTextProjEmbeddings`, `FluxPosEmbed`).
Parameter names are diffusers', so a published `transformer/` folder loads
unchanged.

One forward over packed latents (B, N, in_channels) and T5 states
(B, L, joint_attention_dim):

- `x_embedder` and `context_embedder` lift both to the hidden width;
  `time_text_embed` sums the MLPs of the timestep's and the guidance's
  256-channel sinusoids (flip_sin_to_cos, both scaled by 1000) and the
  projected pooled CLIP vector into `temb`.
- `num_layers` double-stream blocks: text and image keep their own weights
  (`norm1`/`norm1_context` AdaLayerNormZero: shift, scale, gate for the
  attention, then the same for the MLP; `ff`/`ff_context` tanh-GELU MLPs)
  and attend jointly over [text, image].
- `num_single_layers` single-stream blocks over [text, image]: one
  AdaLayerNormZeroSingle (shift, scale, gate), attention and a tanh-GELU
  MLP side by side from the same normed input, `proj_out` over their
  concatenation (hidden + 4 x hidden channels -> hidden), gated.
- `norm_out` (AdaLayerNormContinuous: scale, then shift) and `proj_out` on
  the image tokens -> (B, N, out_channels) velocities.

Every LayerNorm has no affine and eps 1e-6.  In each attention q and k
pass a per-head RMSNorm (eps 1e-6) and then the rotary embedding
(`ops/rotary.py`, theta 10000, `axes_dims_rope` channels for the axes of
the ids: text ids zeros, image ids (0, row, col)).  The joint attention
goes through `ops.attention.dot_product_attention` (looked up at each call),
so on the card it takes B1 wherever the routing rule sends it: at 1024²,
(1, 4608, 24, 128).

Departure from diffusers: the sinusoids' arguments (timestep and guidance
times 1000) are formed in fp32 whatever the model's dtype.  diffusers forms
them in the model's dtype, and in bf16 that rounds the guidance of 30 to
29,952 and each timestep to 8 bits, a change a float32 computation of the
same model does not see.

Spans (`core/tracing.py`): `rr.flux.double` and `rr.flux.single` around
the two stacks, one each a forward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reflecting_reality_tpu_torch.core import tracing
from reflecting_reality_tpu_torch.core.config import ConfigMixin
from reflecting_reality_tpu_torch.ops import attention
from reflecting_reality_tpu_torch.ops.embeddings import TimestepEmbedding, get_timestep_embedding
from reflecting_reality_tpu_torch.ops.norms import RMSNorm
from reflecting_reality_tpu_torch.ops.rotary import apply_rope, rope_tables

EPS = 1e-6


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels without affine (eps 1e-6)."""
    return F.layer_norm(x, (x.shape[-1],), eps=EPS)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


class _AdaLN(nn.Module):
    """SiLU -> linear(dim, n * dim) -> n chunks (`norm*.linear` in diffusers)."""

    def __init__(self, dim: int, n: int):
        super().__init__()
        self.n = n
        self.linear = nn.Linear(dim, n * dim)

    def forward(self, temb: torch.Tensor):
        return self.linear(F.silu(temb)).chunk(self.n, dim=1)


class _FeedForward(nn.Module):
    """`ff.net.0.proj` -> tanh-GELU -> `ff.net.2` (diffusers FeedForward,
    activation "gelu-approximate", inner 4 x dim)."""

    def __init__(self, dim: int):
        super().__init__()
        gelu = nn.Module()
        gelu.proj = nn.Linear(dim, 4 * dim)
        self.net = nn.ModuleList([gelu, nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class FluxAttention(nn.Module):
    """Joint attention: to_q/to_k/to_v (bias) with `norm_q`/`norm_k`
    per head; with `context` (double-stream) also add_q_proj/add_k_proj/
    add_v_proj with `norm_added_q`/`norm_added_k`, `to_out.0` and
    `to_add_out`; without (single-stream, "pre_only") no output projection."""

    def __init__(self, dim: int, heads: int, head_dim: int, context: bool):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q, self.to_k, self.to_v = (nn.Linear(dim, inner) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(head_dim, EPS), RMSNorm(head_dim, EPS)
        if context:
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (nn.Linear(dim, inner)
                                                                 for _ in range(3))
            self.norm_added_q, self.norm_added_k = RMSNorm(head_dim, EPS), RMSNorm(head_dim, EPS)
            self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Identity()])
            self.to_add_out = nn.Linear(inner, dim)

    def _heads(self, x):
        return x.unflatten(-1, (self.heads, self.head_dim))

    def forward(self, x: torch.Tensor, rope, ctx: Optional[torch.Tensor] = None):
        """x (B, N, dim) [and ctx (B, L, dim)] -> the attention's output over
        [ctx, x] (single-stream: (B, N, inner)), or (x's, ctx's) projected."""
        q = self.norm_q(self._heads(self.to_q(x)))
        k = self.norm_k(self._heads(self.to_k(x)))
        v = self._heads(self.to_v(x))
        if ctx is not None:
            q = torch.cat([self.norm_added_q(self._heads(self.add_q_proj(ctx))), q], dim=1)
            k = torch.cat([self.norm_added_k(self._heads(self.add_k_proj(ctx))), k], dim=1)
            v = torch.cat([self._heads(self.add_v_proj(ctx)), v], dim=1)
        cos, sin = rope
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = attention.dot_product_attention(q, k, v).flatten(2)
        if ctx is None:
            return out
        n_ctx = ctx.shape[1]
        return self.to_out[0](out[:, n_ctx:]), self.to_add_out(out[:, :n_ctx])


class FluxTransformerBlock(nn.Module):
    """The double-stream block."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.norm1, self.norm1_context = _AdaLN(dim, 6), _AdaLN(dim, 6)
        self.attn = FluxAttention(dim, heads, head_dim, True)
        self.ff, self.ff_context = _FeedForward(dim), _FeedForward(dim)

    def forward(self, x, ctx, temb, rope):
        shift, scale, gate, shift_m, scale_m, gate_m = self.norm1(temb)
        c_shift, c_scale, c_gate, c_shift_m, c_scale_m, c_gate_m = self.norm1_context(temb)
        attn, ctx_attn = self.attn(modulate(x, shift, scale), rope,
                                   modulate(ctx, c_shift, c_scale))
        x = x + gate[:, None] * attn
        x = x + gate_m[:, None] * self.ff(modulate(x, shift_m, scale_m))
        ctx = ctx + c_gate[:, None] * ctx_attn
        ctx = ctx + c_gate_m[:, None] * self.ff_context(modulate(ctx, c_shift_m, c_scale_m))
        return ctx, x


class FluxSingleTransformerBlock(nn.Module):
    """The single-stream block over [text, image]."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.norm = _AdaLN(dim, 3)
        self.proj_mlp = nn.Linear(dim, 4 * dim)
        self.attn = FluxAttention(dim, heads, head_dim, False)
        self.proj_out = nn.Linear(dim + 4 * dim, dim)

    def forward(self, x, temb, rope):
        shift, scale, gate = self.norm(temb)
        h = modulate(x, shift, scale)
        mlp = F.gelu(self.proj_mlp(h), approximate="tanh")
        return x + gate[:, None] * self.proj_out(torch.cat([self.attn(h, rope), mlp], dim=2))


class _TimeTextEmbed(nn.Module):
    """`time_text_embed`: timestep_embedder, guidance_embedder (if
    guidance-distilled) and text_embedder (the pooled projection)."""

    def __init__(self, dim: int, pooled_dim: int, guidance: bool):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, dim)
        self.guidance_embedder = TimestepEmbedding(256, dim) if guidance else None
        self.text_embedder = TimestepEmbedding(pooled_dim, dim)

    def forward(self, timestep, guidance, pooled):
        dtype = pooled.dtype
        emb = self.timestep_embedder(get_timestep_embedding(timestep.float() * 1000, 256)
                                     .to(dtype))
        if self.guidance_embedder is not None:
            emb = emb + self.guidance_embedder(get_timestep_embedding(guidance.float() * 1000, 256)
                                               .to(dtype))
        return emb + self.text_embedder(pooled)


class _NormOut(nn.Module):
    """AdaLayerNormContinuous: SiLU -> linear(dim, 2 dim) -> (scale, shift)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, temb):
        scale, shift = self.linear(F.silu(temb).to(x.dtype)).chunk(2, dim=1)
        return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


class FluxTransformer2DModel(nn.Module, ConfigMixin):
    def __init__(self, patch_size: int = 1, in_channels: int = 64,
                 out_channels: Optional[int] = None, num_layers: int = 19,
                 num_single_layers: int = 38, attention_head_dim: int = 128,
                 num_attention_heads: int = 24, joint_attention_dim: int = 4096,
                 pooled_projection_dim: int = 768, guidance_embeds: bool = False,
                 axes_dims_rope: Sequence[int] = (16, 56, 56)):
        super().__init__()
        if patch_size != 1:
            raise ValueError("FLUX packs 2x2 latent patches before the model: patch_size 1")
        if sum(axes_dims_rope) != attention_head_dim:
            raise ValueError(f"axes_dims_rope {axes_dims_rope} must sum to the head dim")
        self.patch_size, self.in_channels = patch_size, in_channels
        self.out_channels = out_channels or in_channels
        self.num_layers, self.num_single_layers = num_layers, num_single_layers
        self.attention_head_dim, self.num_attention_heads = attention_head_dim, num_attention_heads
        self.joint_attention_dim = joint_attention_dim
        self.pooled_projection_dim = pooled_projection_dim
        self.guidance_embeds = guidance_embeds
        self.axes_dims_rope = tuple(axes_dims_rope)
        dim = num_attention_heads * attention_head_dim
        args = (dim, num_attention_heads, attention_head_dim)
        self.time_text_embed = _TimeTextEmbed(dim, pooled_projection_dim, guidance_embeds)
        self.context_embedder = nn.Linear(joint_attention_dim, dim)
        self.x_embedder = nn.Linear(in_channels, dim)
        self.transformer_blocks = nn.ModuleList([FluxTransformerBlock(*args)
                                                 for _ in range(num_layers)])
        self.single_transformer_blocks = nn.ModuleList([FluxSingleTransformerBlock(*args)
                                                        for _ in range(num_single_layers)])
        self.norm_out = _NormOut(dim)
        self.proj_out = nn.Linear(dim, patch_size * patch_size * self.out_channels)

    def rope(self, img_ids: torch.Tensor, txt_ids: torch.Tensor):
        """The (cos, sin) tables of the joint sequence [text, image]."""
        return rope_tables(torch.cat([txt_ids, img_ids], dim=0), self.axes_dims_rope)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor, timestep: torch.Tensor,
                img_ids: torch.Tensor, txt_ids: torch.Tensor,
                guidance: Optional[torch.Tensor] = None, rope=None) -> torch.Tensor:
        """Packed latents (B, N, in) -> velocities (B, N, out).  `timestep`
        and `guidance` are (B,) in diffusers' units (sigma; the guidance
        scale); `rope` may pass the tables of `self.rope(img_ids, txt_ids)`
        computed once a call."""
        x = self.x_embedder(hidden_states)
        temb = self.time_text_embed(timestep, guidance, pooled_projections)
        ctx = self.context_embedder(encoder_hidden_states)
        rope = rope if rope is not None else self.rope(img_ids, txt_ids)
        with tracing.span("rr.flux.double"):
            for block in self.transformer_blocks:
                ctx, x = block(x, ctx, temb, rope)
        n_ctx = ctx.shape[1]
        x = torch.cat([ctx, x], dim=1)
        with tracing.span("rr.flux.single"):
            for block in self.single_transformer_blocks:
                x = block(x, temb, rope)
        return self.proj_out(self.norm_out(x[:, n_ctx:], temb))
