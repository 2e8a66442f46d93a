"""Shared noise-schedule math (counterpart of
`reflecting_reality_tpu/schedulers/common.py`; reference:
src/diffusers/schedulers/scheduling_ddpm.py:129 and scheduling_utils.py).

Schedule tensors are fp32 CPU tensors; samplers read them as scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class NoiseSchedule(NamedTuple):
    """Epsilon-prediction schedule (the SD-1.5 convention; the JAX package's
    v/sample predictions and other beta schedules serve training and wait
    for that slice)."""

    betas: torch.Tensor            # (T,)
    alphas_cumprod: torch.Tensor   # (T,)
    num_train_timesteps: int

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
    ) -> "NoiseSchedule":
        if beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
        elif beta_schedule == "scaled_linear":
            # The SD-1.5 latent-diffusion schedule.
            betas = (
                np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float32)
                ** 2
            )
        else:
            raise NotImplementedError(beta_schedule)
        alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        return cls(
            betas=torch.from_numpy(betas),
            alphas_cumprod=torch.from_numpy(alphas_cumprod),
            num_train_timesteps=num_train_timesteps,
        )


def linspace_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """Descending int timesteps, diffusers' "linspace" spacing
    (reference: scheduling_unipc_multistep.py:229-260)."""
    return (
        np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
        .round()[::-1][:-1]
        .astype(np.int64)
    )


def ddim_timesteps(
    num_train_timesteps: int, num_inference_steps: int, steps_offset: int = 1
) -> np.ndarray:
    """DDIM 'leading' spacing (reference: scheduling_ddim.py set_timesteps)."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    return ts + steps_offset
