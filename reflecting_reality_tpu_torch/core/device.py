"""Device resolution for the port's entry points, and the fp32 paths'
convolution precision.

Entry points run on the card unless the caller asks for the CPU.  Asking for
CUDA where there is no card raises: there is no silent CPU fallback.

PyTorch lets cuDNN run fp32 convolutions in one TF32 pass by default
(`torch.backends.cudnn.allow_tf32`), which puts the card's fp32 pipeline
step 2.7x and a training gradient 1.03x outside the port's fp32 tolerance
against the CPU (1e-3 of the largest value; ROADMAP.md C4).  The fp32 paths
(the pipeline, the training step and the baseline's step at fp32) run under
`fp32_convolutions`, which turns it off for their duration and restores it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """`None` means the default, the card.  Raises if CUDA is asked for and
    unavailable."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def fp32_convolutions(dtype: torch.dtype = torch.float32) -> Iterator[None]:
    """cuDNN convolutions (forward and backward) in full fp32 for the
    duration when `dtype` is fp32, the flag restored after; any other dtype
    leaves it alone."""
    if dtype != torch.float32:
        yield
        return
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved
