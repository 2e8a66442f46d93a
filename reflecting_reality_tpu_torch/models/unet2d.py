"""UNet2DConditionModel in NCHW (counterpart of
`reflecting_reality_tpu/models/unet2d.py`; reference:
src/diffusers/models/unets/unet_2d_condition.py:69) with the BrushNet
additive-injection extensions (:1054-1056, :1217, :1288, :1303).

`down_block_add_samples` / `mid_block_add_sample` / `up_block_add_samples`
take the BrushNet residual stacks (12 / 1 / 15 tensors for the SD-1.5 shape)
and add them after conv_in, after every down resnet(+attn) and downsampler
(included in the skip states), after the mid block, and after every up
resnet(+attn) and upsampler.  `temb` takes a precomputed time embedding
(`ops.embeddings.precompute_time_embeddings`).

`ip_num_tokens` / `ip_scale` (IP-Adapter, JAX :49-52) give every
cross-attention its decoupled `to_k_ip` / `to_v_ip` over the last
`ip_num_tokens` context tokens.  The forward's DeepCache and encoder-reuse
arguments (JAX :100-117) are described in `forward`.  SDXL's text_time
embedding is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from reflecting_reality_tpu_torch.core.config import ConfigMixin
from reflecting_reality_tpu_torch.models.unet_blocks import DOWN_BLOCKS, MID_BLOCKS, UP_BLOCKS
from reflecting_reality_tpu_torch.ops.embeddings import TimestepEmbedding, time_embedding
from reflecting_reality_tpu_torch.ops.norms import GroupNorm


def _per_block(v, n: int) -> Tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class UNet2DConditionModel(nn.Module, ConfigMixin):
    def __init__(
        self,
        sample_size: int = 64,
        in_channels: int = 4,
        out_channels: int = 4,
        down_block_types: Tuple[str, ...] = (
            "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
        ),
        mid_block_type: str = "UNetMidBlock2DCrossAttn",
        up_block_types: Tuple[str, ...] = (
            "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        ),
        block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1,
        downsample_padding: int = 1,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-5,
        cross_attention_dim: int = 768,
        attention_head_dim: Union[int, Tuple[int, ...]] = 8,  # SD-1.5 quirk: head COUNT
        use_linear_projection: bool = False,
        flip_sin_to_cos: bool = True,
        freq_shift: int = 0,
        ip_num_tokens: Optional[int] = None,
        ip_scale: float = 1.0,
    ):
        super().__init__()
        self.sample_size = sample_size
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.down_block_types = tuple(down_block_types)
        self.mid_block_type = mid_block_type
        self.up_block_types = tuple(up_block_types)
        self.block_out_channels = bocs = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.transformer_layers_per_block = transformer_layers_per_block
        self.downsample_padding = downsample_padding
        self.norm_num_groups = norm_num_groups
        self.norm_eps = norm_eps
        self.cross_attention_dim = cross_attention_dim
        self.attention_head_dim = attention_head_dim
        self.use_linear_projection = use_linear_projection
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.ip_num_tokens = ip_num_tokens
        self.ip_scale = ip_scale

        n = len(bocs)
        heads = _per_block(attention_head_dim, n)
        tlayers = _per_block(transformer_layers_per_block, n)
        temb_ch = bocs[0] * 4
        cross = dict(cross_attention_dim=cross_attention_dim,
                     use_linear_projection=use_linear_projection,
                     ip_num_tokens=ip_num_tokens, ip_scale=ip_scale)

        self.conv_in = nn.Conv2d(in_channels, bocs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(bocs[0], temb_ch)

        self.down_blocks = nn.ModuleList()
        for i, bt in enumerate(self.down_block_types):
            cls = DOWN_BLOCKS[bt]
            kw = dict(in_channels=bocs[i - 1] if i > 0 else bocs[0], out_channels=bocs[i],
                      temb_channels=temb_ch, num_layers=layers_per_block,
                      add_downsample=i < n - 1, resnet_eps=norm_eps,
                      resnet_groups=norm_num_groups, downsample_padding=downsample_padding)
            if cls.has_cross_attention:
                kw.update(transformer_layers_per_block=tlayers[i], num_attention_heads=heads[i],
                          **cross)
            self.down_blocks.append(cls(**kw))

        mid_cls = MID_BLOCKS[mid_block_type]
        mid_kw = dict(in_channels=bocs[-1], temb_channels=temb_ch, resnet_eps=norm_eps,
                      resnet_groups=norm_num_groups)
        if mid_cls.has_cross_attention:
            mid_kw.update(transformer_layers_per_block=tlayers[-1],
                          num_attention_heads=heads[-1], **cross)
        self.mid_block = mid_cls(**mid_kw)

        self.up_blocks = nn.ModuleList()
        rb, rh, rt = list(reversed(bocs)), list(reversed(heads)), list(reversed(tlayers))
        out_ch = rb[0]
        for i, bt in enumerate(self.up_block_types):
            prev, out_ch = out_ch, rb[i]
            cls = UP_BLOCKS[bt]
            kw = dict(in_channels=rb[min(i + 1, n - 1)], prev_output_channel=prev,
                      out_channels=out_ch, temb_channels=temb_ch,
                      num_layers=layers_per_block + 1, add_upsample=i < n - 1,
                      resnet_eps=norm_eps, resnet_groups=norm_num_groups)
            if cls.has_cross_attention:
                kw.update(transformer_layers_per_block=rt[i], num_attention_heads=rh[i], **cross)
            self.up_blocks.append(cls(**kw))

        self.conv_norm_out = GroupNorm(norm_num_groups, bocs[0], norm_eps)
        self.conv_out = nn.Conv2d(bocs[0], out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,                 # (B, in_channels, H, W)
        timesteps: torch.Tensor,              # (B,) or scalar
        encoder_hidden_states: torch.Tensor,  # (B, T, cross_attention_dim)
        down_block_add_samples: Optional[Sequence[torch.Tensor]] = None,
        mid_block_add_sample: Optional[torch.Tensor] = None,
        up_block_add_samples: Optional[Sequence[torch.Tensor]] = None,
        temb: Optional[torch.Tensor] = None,  # precomputed (B or 1, 4*bocs[0])
        cached_deep: Optional[torch.Tensor] = None,
        return_deep: bool = False,
        cached_encoder: Optional[Tuple] = None,
        return_encoder: bool = False,
    ):
        """DeepCache (arXiv:2312.03209): `return_deep=True` also returns the
        hidden state entering the LAST up block; passing it back as
        `cached_deep` skips down blocks 1..N, the mid block and up blocks
        0..N-2 and recomputes only the shallow encoder/decoder around it ->
        (sample, cached_deep).

        Encoder reuse ("Faster Diffusion", arXiv:2312.09608):
        `return_encoder=True` also returns `(sample entering the mid block,
        skip stack)`, with any BrushNet down residuals already added;
        passing it back as `cached_encoder` skips conv_in and every down
        block and recomputes the mid block and the decoder.

        The same step's cache gives the full forward's output exactly."""
        if cached_deep is not None and cached_encoder is not None:
            raise ValueError("cached_deep and cached_encoder are exclusive")
        b = sample.shape[0]
        if temb is not None:
            emb = temb.to(sample.dtype).expand(b, temb.shape[-1])
        else:
            t = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(b)
            emb = time_embedding(self, t)

        up_adds = list(up_block_add_samples) if up_block_add_samples is not None else None
        kw = dict(encoder_hidden_states=encoder_hidden_states)
        shallow = cached_deep is not None
        n = len(self.block_out_channels)
        num_layers = self.layers_per_block + 1

        if cached_encoder is not None:
            sample, res_samples = cached_encoder
            res_samples = tuple(res_samples)
        else:
            sample = self.conv_in(sample)
            down_adds = (list(down_block_add_samples) if down_block_add_samples is not None
                         else None)
            res_samples = (sample,)
            if down_adds is not None:
                sample = sample + down_adds.pop(0)
            for i, block in enumerate(self.down_blocks):
                if shallow and i > 0:
                    break
                n_take = self.layers_per_block + (0 if i == n - 1 else 1)
                adds = [down_adds.pop(0) for _ in range(n_take)] if down_adds is not None else None
                sample, states = block(sample, emb, add_samples=adds, **kw)
                res_samples += states
        encoder_cache = (sample, res_samples)

        if shallow:
            # the last up block over the cached deep trunk, then the output
            adds = up_adds[-num_layers:] if up_adds is not None else None
            sample, _ = self.up_blocks[-1](cached_deep, res_samples[:num_layers], emb,
                                           add_samples=adds, **kw)
            return self.conv_out(self.conv_norm_out(sample, apply_silu=True)), cached_deep

        sample = self.mid_block(sample, emb, **kw)
        if mid_block_add_sample is not None:
            sample = sample + mid_block_add_sample

        res_samples = list(res_samples)
        deep = None
        for i, block in enumerate(self.up_blocks):
            if i == n - 1:
                deep = sample               # the DeepCache point
            skips = tuple(res_samples[-num_layers:])
            res_samples = res_samples[:-num_layers]
            upsample_size = tuple(res_samples[-1].shape[2:]) if res_samples else None
            n_take = num_layers + (0 if i == n - 1 else 1)
            adds = [up_adds.pop(0) for _ in range(n_take)] if up_adds is not None else None
            sample, _ = block(sample, skips, emb, add_samples=adds,
                              upsample_size=upsample_size, **kw)

        sample = self.conv_out(self.conv_norm_out(sample, apply_silu=True))
        if return_deep:
            return sample, deep
        if return_encoder:
            return sample, encoder_cache
        return sample
