"""GroupNorm with an optional fused SiLU epilogue (counterpart of
`reflecting_reality_tpu/ops/norms.py`).

Routing is by the tensor's device, never by a process global: CPU tensors
take the plain PyTorch version (fp32 statistics, two-pass variance, output in
x.dtype — the JAX numerics), which torch autograd differentiates; CUDA
tensors take the CUDA kernel (`ops/kernels/csrc/groupnorm.cu` through
`ops/kernels/groupnorm.py`, kernel B2),
through its autograd Function (plain closed-form backward) when a gradient
is needed.  On the card every GroupNorm of the UNet, BrushNet, VAE and
Transformer2D goes through that kernel.

`RMSNorm` (FLUX.1's per-head q/k norm and T5's layer norm) is plain PyTorch
on every device: memory-bound work over the last axis.
"""

from __future__ import annotations

import torch
from torch import nn

from reflecting_reality_tpu_torch.ops.kernels.groupnorm import group_norm_silu


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float, apply_silu: bool = False) -> torch.Tensor:
    """(B, C, H, W) group normalization; statistics in fp32, result in x.dtype.

    The kernel takes contiguous NCHW.  On the card, 1x1 convolutions (zero
    convs, conv_shortcut, proj_in/proj_out) return channels_last tensors,
    which elementwise adds carry on; those are copied to NCHW here."""
    return group_norm_silu(x.contiguous(), weight, bias, num_groups, eps, apply_silu)


class GroupNorm(nn.Module):
    """torch-named GroupNorm (weight, bias) with the fused-SiLU option."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, apply_silu: bool = False) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, apply_silu)


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis with a learned scale
    (diffusers `RMSNorm`, transformers `T5LayerNorm`: the two compute alike):
    the mean square in fp32, the input scaled by its reciprocal root, cast
    to the scale's dtype where that is a half type, times the scale."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + self.eps)
        if self.weight.dtype in (torch.float16, torch.bfloat16):
            y = y.to(self.weight.dtype)
        return y * self.weight
