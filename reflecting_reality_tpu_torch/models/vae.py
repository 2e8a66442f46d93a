"""AutoencoderKL in NCHW (counterpart of `reflecting_reality_tpu/models/vae.py`;
reference: src/diffusers/models/autoencoders/autoencoder_kl.py:35,
vae.py:46,185,769).

- Encoder: conv_in -> DownEncoderBlock2D x4 (no temb; stride-2 downsample with
  asymmetric (0,1) padding between blocks) -> mid block (resnet, single-head
  attention with group_norm + residual, resnet) -> GroupNorm+SiLU -> conv_out
  (2*latent channels); quant_conv 1x1.
- DiagonalGaussian over channel-split moments, logvar clamped to [-30, 20];
  `sample(generator)` = mean + std * noise.
- Decoder: post_quant_conv -> conv_in -> mid -> UpDecoderBlock2D x4 (nearest
  x2 upsample) -> GroupNorm+SiLU -> conv_out.
- The x0.18215 latent scaling (`scaling_factor`) is applied by callers.
- FLUX.1's VAE (diffusers' `use_quant_conv` / `use_post_quant_conv` false,
  16 latent channels) has neither 1x1 conv; `shift_factor` is its latent
  shift, which callers apply as (z - shift) x scale.  The defaults keep the
  SD VAE: both convs, no shift.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from reflecting_reality_tpu_torch.core.config import ConfigMixin
from reflecting_reality_tpu_torch.ops.attention import Attention
from reflecting_reality_tpu_torch.ops.norms import GroupNorm
from reflecting_reality_tpu_torch.ops.resnet import Downsample2D, ResnetBlock2D, Upsample2D


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                            dtype=self.mean.dtype)
        return self.mean + self.std * noise

    @property
    def mode(self) -> torch.Tensor:
        return self.mean

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=1)
        return cls(mean, logvar.clamp(-30.0, 20.0))


def _resnet(cin, cout, groups):
    return ResnetBlock2D(cin, cout, groups=groups, eps=1e-6, temb_channels=None)


class _DownEncoderBlock(nn.Module):
    def __init__(self, cin, cout, num_layers, add_downsample, groups):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(cin if i == 0 else cout, cout, groups)
                                      for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(cout, padding=0)])
                             if add_downsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class _UpDecoderBlock(nn.Module):
    def __init__(self, cin, cout, num_layers, add_upsample, groups):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(cin if i == 0 else cout, cout, groups)
                                      for i in range(num_layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(cout)]) if add_upsample else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, channels, groups):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(channels, channels, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([Attention(
            channels, heads=1, dim_head=channels, norm_num_groups=groups,
            residual_connection=True, qkv_bias=True)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, in_channels=3, block_out_channels=(128, 256, 512, 512),
                 layers_per_block=2, latent_channels=4, norm_num_groups=32):
        super().__init__()
        bocs = block_out_channels
        self.conv_in = nn.Conv2d(in_channels, bocs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _DownEncoderBlock(bocs[i - 1] if i > 0 else bocs[0], c, layers_per_block,
                              i < len(bocs) - 1, norm_num_groups)
            for i, c in enumerate(bocs)
        ])
        self.mid_block = _MidBlock(bocs[-1], norm_num_groups)
        self.conv_norm_out = GroupNorm(norm_num_groups, bocs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(bocs[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x, apply_silu=True))


class Decoder(nn.Module):
    def __init__(self, out_channels=3, block_out_channels=(128, 256, 512, 512),
                 layers_per_block=2, latent_channels=4, norm_num_groups=32):
        super().__init__()
        rb = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, rb[0], 3, padding=1)
        self.mid_block = _MidBlock(rb[0], norm_num_groups)
        self.up_blocks = nn.ModuleList()
        out_ch = rb[0]
        for i in range(len(rb)):
            prev, out_ch = out_ch, rb[i]
            self.up_blocks.append(_UpDecoderBlock(prev, out_ch, layers_per_block + 1,
                                                  i < len(rb) - 1, norm_num_groups))
        self.conv_norm_out = GroupNorm(norm_num_groups, rb[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rb[-1], out_channels, 3, padding=1)

    def head(self, z):
        """conv_in -> mid block (the global attention lives here)."""
        return self.mid_block(self.conv_in(z))

    def tail(self, x):
        """The conv-only up blocks -> GroupNorm+SiLU -> conv_out (a finite
        receptive field, so `parallel.sharded_vae.tiled_decode` tiles it)."""
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x, apply_silu=True))

    def forward(self, z):
        return self.tail(self.head(z))


class AutoencoderKL(nn.Module, ConfigMixin):
    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 norm_num_groups: int = 32, scaling_factor: float = 0.18215,
                 sample_size: int = 512, use_quant_conv: bool = True,
                 use_post_quant_conv: bool = True, shift_factor: Optional[float] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.latent_channels = latent_channels
        self.norm_num_groups = norm_num_groups
        self.scaling_factor = scaling_factor
        self.sample_size = sample_size
        self.use_quant_conv, self.use_post_quant_conv = use_quant_conv, use_post_quant_conv
        self.shift_factor = shift_factor
        self.encoder = Encoder(in_channels, self.block_out_channels, layers_per_block,
                               latent_channels, norm_num_groups)
        self.decoder = Decoder(out_channels, self.block_out_channels, layers_per_block,
                               latent_channels, norm_num_groups)
        self.quant_conv = (nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
                           if use_quant_conv else None)
        self.post_quant_conv = (nn.Conv2d(latent_channels, latent_channels, 1)
                                if use_post_quant_conv else None)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        moments = self.encoder(x)
        if self.quant_conv is not None:
            moments = self.quant_conv(moments)
        return DiagonalGaussian.from_moments(moments)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)
