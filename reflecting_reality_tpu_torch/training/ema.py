"""Exponential moving average of parameters (counterpart of
`reflecting_reality_tpu/training/ema.py`; reference: src/diffusers/
training_utils.py:169 EMAModel).

The decay warms up as min(decay, (1 + step) / (10 + step)), the diffusers
default ramp, where `step` is the train step's count before this step.  The
JAX version returns a new tree; this one updates the shadow tensors in
place, which keeps one copy of them on the card.  Each update accumulates in
fp32 and stores in the shadow's dtype, so a bf16 shadow (`ema_dtype="bf16"`)
halves the copy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], step: int,
               decay: float = 0.9999) -> None:
    """ema[name] <- ema[name]·d + params[name]·(1 − d), in place, with
    d = min(decay, (1 + step) / (10 + step)) evaluated in fp32 as jnp does."""
    d = float(min(np.float32(decay), np.float32(1.0 + step) / np.float32(10.0 + step)))
    for name, e in ema.items():
        e.copy_(e.float() * d + params[name].float() * (1.0 - d))
