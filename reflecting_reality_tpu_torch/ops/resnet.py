"""ResnetBlock2D and up/down sampling in NCHW (counterpart of
`reflecting_reality_tpu/ops/resnet.py`; reference: src/diffusers/models/
resnet.py, upsampling.py, downsampling.py).

  h = conv1(silu(norm1(x)))
  h = h + time_emb_proj(silu(temb))[:, :, None, None]
  h = conv2(silu(norm2(h)))
  out = shortcut(x) + h
with a 1x1 conv_shortcut iff in/out channels differ (SD-1.5 uses
output_scale_factor=1, so there is no rescale).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reflecting_reality_tpu_torch.ops.norms import GroupNorm


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-6, temb_channels: Optional[int] = 1280):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm(groups, out_channels, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x, apply_silu=True))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, apply_silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """3x3 stride-2 conv.  The UNet uses padding=1; the VAE encoder padding=0
    with a manual (0,1)x(0,1) pad (reference downsampling.py)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None, padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(channels, out_channels or channels, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 (or to an explicit output size) followed by a 3x3 conv."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels or channels, 3, padding=1)

    def forward(self, x: torch.Tensor, output_size: Optional[Sequence[int]] = None) -> torch.Tensor:
        h, w = x.shape[2:]
        if output_size is None or tuple(output_size) == (2 * h, 2 * w):
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        else:
            oh, ow = output_size
            # torch nearest: src_idx = floor(dst_idx * in / out)
            ridx = torch.arange(oh, device=x.device) * h // oh
            cidx = torch.arange(ow, device=x.device) * w // ow
            x = x[:, :, ridx][:, :, :, cidx]
        return self.conv(x)
