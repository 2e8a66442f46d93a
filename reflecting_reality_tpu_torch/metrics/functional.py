"""Image metrics as torch functions, the port's counterpart of
`reflecting_reality_tpu/metrics/functional.py`, with the same protocol
(torchmetrics 1.4 functional defaults, the reference's pin):

- psnr: 10·log10(data_range² / mse); data_range=None is the TARGET's
  max - min.
- ssim: Gaussian kernel 11, σ 1.5, k1 0.01, k2 0.03; data_range=None is
  max(range(pred), range(target)); a VALID depthwise convolution (what
  torchmetrics' reflect-pad, convolve and crop amounts to), the per-pixel
  map averaged.
- iou: boolean intersection over union.

Inputs are NHWC or HWC arrays or tensors of any float/int range; the work
runs on `device` (default: the tensor's own device, the CPU for numpy).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Device = Union[str, torch.device, None]


def _nchw(x, device: Device) -> torch.Tensor:
    x = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), device=device)
    x = x.float()
    if x.dim() == 3:
        x = x[None]
    return x.permute(0, 3, 1, 2)


def psnr(pred, target, data_range: Optional[float] = None, device: Device = None
         ) -> torch.Tensor:
    pred, target = _nchw(pred, device), _nchw(target, device)
    if data_range is None:
        data_range = target.max() - target.min()
    mse = ((pred - target) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred, target, data_range: Optional[float] = None, kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03, device: Device = None
         ) -> torch.Tensor:
    pred, target = _nchw(pred, device), _nchw(target, device)
    if data_range is None:
        data_range = torch.maximum(pred.max() - pred.min(), target.max() - target.min())
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    c = pred.shape[1]
    kern = _gaussian_kernel(kernel_size, sigma, pred.device)[None, None].expand(c, 1, -1, -1)

    def filt(x):
        return F.conv2d(x, kern, groups=c)

    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_p = filt(pred * pred) - mu_pp
    sigma_t = filt(target * target) - mu_tt
    sigma_pt = filt(pred * target) - mu_pt
    num = (2 * mu_pt + c1) * (2 * sigma_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2)
    return (num / den).mean()


def iou(gen_mask, gt_mask) -> float:
    gen = np.asarray(gen_mask).astype(bool)
    gt = np.asarray(gt_mask).astype(bool)
    union = np.logical_or(gen, gt).sum()
    if union == 0:
        return float("nan")
    return float(np.logical_and(gen, gt).sum() / union)


def psnr_ssim(pred, target, device: Device = None) -> Tuple[float, float]:
    """(psnr, ssim) as floats."""
    return float(psnr(pred, target, device=device)), float(ssim(pred, target, device=device))
