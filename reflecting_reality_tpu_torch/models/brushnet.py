"""BrushNetModel — the MirrorFusion conditioning branch, NCHW (counterpart of
`reflecting_reality_tpu/models/brushnet.py`; reference:
src/diffusers/models/brushnet.py:61).

A conv-only twin of the SD-1.5 UNet whose input is
concat(noisy latents [4ch], conditioning latents) through
`conv_in_condition`.  It emits 28 zero-initialized 1x1-conv residuals for
the SD-1.5 shape: 12 "down" (conv_in output + every down resnet/downsampler
state), 1 "mid", 15 "up" (every up resnet/upsampler state, captured before
injection).  `conditioning_scale` multiplies all residuals; `guess_mode`
applies the logspace(-1, 0) ramp; `global_pool_conditions` mean-pools them.

The `init_params_from_unet` training-time surgery is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from reflecting_reality_tpu_torch.core.config import ConfigMixin
from reflecting_reality_tpu_torch.models.unet_blocks import DOWN_BLOCKS, MID_BLOCKS, UP_BLOCKS
from reflecting_reality_tpu_torch.ops.embeddings import TimestepEmbedding, time_embedding


def _zero_conv(channels: int) -> nn.Conv2d:
    conv = nn.Conv2d(channels, channels, 1)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class BrushNetModel(nn.Module, ConfigMixin):
    def __init__(
        self,
        in_channels: int = 4,
        conditioning_channels: int = 5,
        down_block_types: Tuple[str, ...] = ("DownBlock2D",) * 4,
        mid_block_type: str = "MidBlock2D",
        up_block_types: Tuple[str, ...] = ("UpBlock2D",) * 4,
        block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        transformer_layers_per_block: int = 1,
        downsample_padding: int = 1,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-5,
        cross_attention_dim: int = 768,
        attention_head_dim: Union[int, Tuple[int, ...]] = 8,
        use_linear_projection: bool = False,
        flip_sin_to_cos: bool = True,
        freq_shift: int = 0,
        global_pool_conditions: bool = False,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.conditioning_channels = conditioning_channels
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
        self.global_pool_conditions = global_pool_conditions

        n = len(bocs)
        heads = (tuple(attention_head_dim) if isinstance(attention_head_dim, (tuple, list))
                 else (attention_head_dim,) * n)
        temb_ch = bocs[0] * 4
        cross = dict(transformer_layers_per_block=transformer_layers_per_block,
                     cross_attention_dim=cross_attention_dim,
                     use_linear_projection=use_linear_projection)

        self.conv_in_condition = nn.Conv2d(in_channels + conditioning_channels, bocs[0], 3,
                                           padding=1)
        self.time_embedding = TimestepEmbedding(bocs[0], temb_ch)

        self.down_blocks = nn.ModuleList()
        down_channels = [bocs[0]]
        for i, bt in enumerate(self.down_block_types):
            cls = DOWN_BLOCKS[bt]
            kw = dict(in_channels=bocs[i - 1] if i > 0 else bocs[0], out_channels=bocs[i],
                      temb_channels=temb_ch, num_layers=layers_per_block,
                      add_downsample=i < n - 1, resnet_eps=norm_eps,
                      resnet_groups=norm_num_groups, downsample_padding=downsample_padding)
            if cls.has_cross_attention:
                kw.update(num_attention_heads=heads[i], **cross)
            self.down_blocks.append(cls(**kw))
            down_channels += [bocs[i]] * (layers_per_block + (1 if i < n - 1 else 0))
        self.brushnet_down_blocks = nn.ModuleList([_zero_conv(c) for c in down_channels])

        mid_cls = MID_BLOCKS[mid_block_type]
        mid_kw = dict(in_channels=bocs[-1], temb_channels=temb_ch, resnet_eps=norm_eps,
                      resnet_groups=norm_num_groups)
        if mid_cls.has_cross_attention:
            mid_kw.update(num_attention_heads=heads[-1], **cross)
        self.mid_block = mid_cls(**mid_kw)
        self.brushnet_mid_block = _zero_conv(bocs[-1])

        self.up_blocks = nn.ModuleList()
        up_channels = []
        rb, rh = list(reversed(bocs)), list(reversed(heads))
        out_ch = rb[0]
        for i, bt in enumerate(self.up_block_types):
            prev, out_ch = out_ch, rb[i]
            cls = UP_BLOCKS[bt]
            kw = dict(in_channels=rb[min(i + 1, n - 1)], prev_output_channel=prev,
                      out_channels=out_ch, temb_channels=temb_ch,
                      num_layers=layers_per_block + 1, add_upsample=i < n - 1,
                      resnet_eps=norm_eps, resnet_groups=norm_num_groups)
            if cls.has_cross_attention:
                kw.update(num_attention_heads=rh[i], **cross)
            self.up_blocks.append(cls(**kw))
            up_channels += [out_ch] * (layers_per_block + 1 + (1 if i < n - 1 else 0))
        self.brushnet_up_blocks = nn.ModuleList([_zero_conv(c) for c in up_channels])

    @property
    def has_cross_attention(self) -> bool:
        return (any(b.has_cross_attention for b in self.down_blocks)
                or self.mid_block.has_cross_attention
                or any(b.has_cross_attention for b in self.up_blocks))

    def forward(
        self,
        sample: torch.Tensor,                 # (B, in_channels, H, W) noisy latents
        timesteps: torch.Tensor,              # (B,) or scalar
        encoder_hidden_states: torch.Tensor,
        brushnet_cond: torch.Tensor,          # (B, conditioning_channels, H, W)
        conditioning_scale: float = 1.0,
        guess_mode: bool = False,
        temb: Optional[torch.Tensor] = None,  # precomputed time embedding
    ) -> Tuple[List[torch.Tensor], torch.Tensor, List[torch.Tensor]]:
        b = sample.shape[0]
        if temb is not None:
            emb = temb.to(sample.dtype).expand(b, temb.shape[-1])
        else:
            t = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(b)
            emb = time_embedding(self, t)

        x = self.conv_in_condition(torch.cat([sample, brushnet_cond], dim=1))
        down_states = (x,)
        for block in self.down_blocks:
            x, states = block(x, emb, encoder_hidden_states=encoder_hidden_states)
            down_states += states
        down_res = [conv(s) for conv, s in zip(self.brushnet_down_blocks, down_states)]

        x = self.mid_block(x, emb, encoder_hidden_states=encoder_hidden_states)
        mid_res = self.brushnet_mid_block(x)

        skips = list(down_states)
        num_layers = self.layers_per_block + 1
        up_states = ()
        for block in self.up_blocks:
            res = tuple(skips[-num_layers:])
            skips = skips[:-num_layers]
            upsample_size = tuple(skips[-1].shape[2:]) if skips else None
            x, captured = block(x, res, emb, encoder_hidden_states=encoder_hidden_states,
                                capture_res=True, upsample_size=upsample_size)
            up_states += captured
        up_res = [conv(s) for conv, s in zip(self.brushnet_up_blocks, up_states)]

        if guess_mode and not self.global_pool_conditions:
            n = len(down_res) + 1 + len(up_res)
            scales = (torch.logspace(-1, 0, n) * conditioning_scale).tolist()
            down_res = [s * scales[i] for i, s in enumerate(down_res)]
            mid_res = mid_res * scales[len(down_res)]
            up_res = [s * scales[len(down_res) + 1 + i] for i, s in enumerate(up_res)]
        else:
            down_res = [s * conditioning_scale for s in down_res]
            mid_res = mid_res * conditioning_scale
            up_res = [s * conditioning_scale for s in up_res]

        if self.global_pool_conditions:
            def pool(s):
                return s.mean(dim=(2, 3), keepdim=True)

            down_res = [pool(s) for s in down_res]
            mid_res = pool(mid_res)
            up_res = [pool(s) for s in up_res]
        return down_res, mid_res, up_res
