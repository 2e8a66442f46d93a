"""GroupNorm with an optional fused SiLU epilogue (counterpart of
`reflecting_reality_tpu/ops/norms.py`).

Routing is by the tensor's device, never by a process global: CPU tensors
take the plain PyTorch version (fp32 statistics, two-pass variance, output in
x.dtype — the JAX numerics), CUDA tensors take the Triton kernel
(`ops/kernels/groupnorm.py`, kernel B2).  On the card every GroupNorm of the
UNet, BrushNet, VAE and Transformer2D goes through that kernel.
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
