"""UNet block zoo in NCHW (counterpart of
`reflecting_reality_tpu/models/unet_blocks.py`; reference:
src/diffusers/models/unets/unet_2d_blocks.py), with the BrushNet extensions:

- Down blocks accept `add_samples` (one per resnet + one per downsampler),
  added AFTER each sub-layer and INCLUDED in the returned skip states.
- Up blocks accept `add_samples` and/or `capture_res`; captured states are
  taken BEFORE the additive injection.
- `MidBlock2D` is the conv-only mid block BrushNet uses.
- The cross-attention blocks pass `ip_num_tokens` / `ip_scale` (IP-Adapter)
  to their transformers (JAX :83-84, :191-192, :256-257).

Injection lists are consumed in the exact pop order of the JAX `_pop`.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from reflecting_reality_tpu_torch.ops.resnet import Downsample2D, ResnetBlock2D, Upsample2D
from reflecting_reality_tpu_torch.ops.transformer import Transformer2DModel


def _pop(samples: Optional[List[torch.Tensor]]):
    return samples.pop(0) if samples else None


def _add(x: torch.Tensor, samples: Optional[List[torch.Tensor]]) -> torch.Tensor:
    a = _pop(samples)
    return x if a is None else x + a


class _DownBase(nn.Module):
    has_cross_attention = False

    def __init__(self, in_channels, out_channels, temb_channels, num_layers=2,
                 add_downsample=True, resnet_eps=1e-5, resnet_groups=32,
                 downsample_padding=1):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels,
                          groups=resnet_groups, eps=resnet_eps, temb_channels=temb_channels)
            for i in range(num_layers)
        ])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, padding=downsample_padding)])
                             if add_downsample else None)

    def forward(self, x, temb, encoder_hidden_states=None, add_samples=None):
        output_states = ()
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.has_cross_attention:
                x = self.attentions[i](x, encoder_hidden_states=encoder_hidden_states)
            x = _add(x, add_samples)
            output_states += (x,)
        if self.downsamplers is not None:
            x = _add(self.downsamplers[0](x), add_samples)
            output_states += (x,)
        return x, output_states


class DownBlock2D(_DownBase):
    def __init__(self, in_channels, out_channels, temb_channels, num_layers=2,
                 add_downsample=True, resnet_eps=1e-5, resnet_groups=32,
                 downsample_padding=1, **_cross):
        super().__init__(in_channels, out_channels, temb_channels, num_layers,
                         add_downsample, resnet_eps, resnet_groups, downsample_padding)


class CrossAttnDownBlock2D(_DownBase):
    has_cross_attention = True

    def __init__(self, in_channels, out_channels, temb_channels, num_layers=2,
                 add_downsample=True, resnet_eps=1e-5, resnet_groups=32,
                 downsample_padding=1, transformer_layers_per_block=1,
                 num_attention_heads=8, cross_attention_dim=768,
                 use_linear_projection=False, ip_num_tokens=None, ip_scale=1.0):
        super().__init__(in_channels, out_channels, temb_channels, num_layers,
                         add_downsample, resnet_eps, resnet_groups, downsample_padding)
        self.attentions = nn.ModuleList([
            Transformer2DModel(out_channels, num_attention_heads,
                               out_channels // num_attention_heads,
                               num_layers=transformer_layers_per_block,
                               cross_attention_dim=cross_attention_dim,
                               norm_num_groups=resnet_groups,
                               use_linear_projection=use_linear_projection,
                               ip_num_tokens=ip_num_tokens, ip_scale=ip_scale)
            for _ in range(num_layers)
        ])


class _UpBase(nn.Module):
    has_cross_attention = False

    def __init__(self, in_channels, prev_output_channel, out_channels, temb_channels,
                 num_layers=3, add_upsample=True, resnet_eps=1e-5, resnet_groups=32):
        super().__init__()
        self.resnets = nn.ModuleList()
        for i in range(num_layers):
            res_skip = in_channels if i == num_layers - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            self.resnets.append(ResnetBlock2D(res_in + res_skip, out_channels,
                                              groups=resnet_groups, eps=resnet_eps,
                                              temb_channels=temb_channels))
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, x, res_hidden_states_tuple, temb, encoder_hidden_states=None,
                add_samples=None, capture_res: bool = False, upsample_size=None):
        captured = ()
        res_list = list(res_hidden_states_tuple)
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_list.pop()], dim=1), temb)
            if self.has_cross_attention:
                x = self.attentions[i](x, encoder_hidden_states=encoder_hidden_states)
            if capture_res:
                captured += (x,)
            x = _add(x, add_samples)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, output_size=upsample_size)
            if capture_res:
                captured += (x,)
            x = _add(x, add_samples)
        return x, captured


class UpBlock2D(_UpBase):
    def __init__(self, in_channels, prev_output_channel, out_channels, temb_channels,
                 num_layers=3, add_upsample=True, resnet_eps=1e-5, resnet_groups=32,
                 **_cross):
        super().__init__(in_channels, prev_output_channel, out_channels, temb_channels,
                         num_layers, add_upsample, resnet_eps, resnet_groups)


class CrossAttnUpBlock2D(_UpBase):
    has_cross_attention = True

    def __init__(self, in_channels, prev_output_channel, out_channels, temb_channels,
                 num_layers=3, add_upsample=True, resnet_eps=1e-5, resnet_groups=32,
                 transformer_layers_per_block=1, num_attention_heads=8,
                 cross_attention_dim=768, use_linear_projection=False, ip_num_tokens=None,
                 ip_scale=1.0):
        super().__init__(in_channels, prev_output_channel, out_channels, temb_channels,
                         num_layers, add_upsample, resnet_eps, resnet_groups)
        self.attentions = nn.ModuleList([
            Transformer2DModel(out_channels, num_attention_heads,
                               out_channels // num_attention_heads,
                               num_layers=transformer_layers_per_block,
                               cross_attention_dim=cross_attention_dim,
                               norm_num_groups=resnet_groups,
                               use_linear_projection=use_linear_projection,
                               ip_num_tokens=ip_num_tokens, ip_scale=ip_scale)
            for _ in range(num_layers)
        ])


class UNetMidBlock2DCrossAttn(nn.Module):
    has_cross_attention = True

    def __init__(self, in_channels, temb_channels, num_layers=1, resnet_eps=1e-5,
                 resnet_groups=32, transformer_layers_per_block=1, num_attention_heads=8,
                 cross_attention_dim=768, use_linear_projection=False, ip_num_tokens=None,
                 ip_scale=1.0):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels, in_channels, groups=resnet_groups, eps=resnet_eps,
                          temb_channels=temb_channels)
            for _ in range(num_layers + 1)
        ])
        self.attentions = nn.ModuleList([
            Transformer2DModel(in_channels, num_attention_heads,
                               in_channels // num_attention_heads,
                               num_layers=transformer_layers_per_block,
                               cross_attention_dim=cross_attention_dim,
                               norm_num_groups=resnet_groups,
                               use_linear_projection=use_linear_projection,
                               ip_num_tokens=ip_num_tokens, ip_scale=ip_scale)
            for _ in range(num_layers)
        ])

    def forward(self, x, temb, encoder_hidden_states=None):
        x = self.resnets[0](x, temb)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = attn(x, encoder_hidden_states=encoder_hidden_states)
            x = resnet(x, temb)
        return x


class MidBlock2D(nn.Module):
    """Conv-only mid block used by BrushNet (reference: unet_2d_blocks.py:1026)."""

    has_cross_attention = False

    def __init__(self, in_channels, temb_channels, num_layers=1, resnet_eps=1e-5,
                 resnet_groups=32, **_cross):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels, in_channels, groups=resnet_groups, eps=resnet_eps,
                          temb_channels=temb_channels)
            for _ in range(num_layers + 1)
        ])

    def forward(self, x, temb, encoder_hidden_states=None):
        for resnet in self.resnets:
            x = resnet(x, temb)
        return x


DOWN_BLOCKS = {"DownBlock2D": DownBlock2D, "CrossAttnDownBlock2D": CrossAttnDownBlock2D}
UP_BLOCKS = {"UpBlock2D": UpBlock2D, "CrossAttnUpBlock2D": CrossAttnUpBlock2D}
MID_BLOCKS = {"UNetMidBlock2DCrossAttn": UNetMidBlock2DCrossAttn, "MidBlock2D": MidBlock2D}
