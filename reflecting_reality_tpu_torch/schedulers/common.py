"""Shared noise-schedule math (counterpart of
`reflecting_reality_tpu/schedulers/common.py`; reference:
src/diffusers/schedulers/scheduling_ddpm.py:129 and scheduling_utils.py).

Schedule tensors are fp32 CPU tensors; samplers read them as scalars, and
the training-time functions (`add_noise`, `get_velocity`, `compute_snr`)
gather them at the timesteps' device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class NoiseSchedule(NamedTuple):
    betas: torch.Tensor            # (T,)
    alphas_cumprod: torch.Tensor   # (T,)
    num_train_timesteps: int
    prediction_type: str = "epsilon"

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        prediction_type: str = "epsilon",
        trained_betas=None,
    ) -> "NoiseSchedule":
        if trained_betas is not None:
            betas = np.asarray(trained_betas, dtype=np.float32)
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
        elif beta_schedule == "scaled_linear":
            # The SD-1.5 latent-diffusion schedule.
            betas = (
                np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float32)
                ** 2
            )
        elif beta_schedule == "squaredcos_cap_v2":
            ts = np.arange(num_train_timesteps, dtype=np.float64)

            def f(t):
                return np.cos((t / num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2

            betas = np.clip(1.0 - f(ts + 1) / f(ts), 0, 0.999).astype(np.float32)
        else:
            raise NotImplementedError(beta_schedule)
        alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        return cls(
            betas=torch.from_numpy(betas),
            alphas_cumprod=torch.from_numpy(alphas_cumprod),
            num_train_timesteps=num_train_timesteps,
            prediction_type=prediction_type,
        )

    def alphas_cumprod_at(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.alphas_cumprod.to(timesteps.device)[timesteps.long()]


def _coefs(schedule: NoiseSchedule, timesteps: torch.Tensor, ndim: int):
    """sqrt(acp_t) and sqrt(1 - acp_t) in fp32, shaped (B, 1, ...) over `ndim` dims."""
    acp = schedule.alphas_cumprod_at(timesteps)
    shape = acp.shape + (1,) * (ndim - acp.dim())
    return acp.sqrt().reshape(shape), (1.0 - acp).sqrt().reshape(shape)


def add_noise(schedule: NoiseSchedule, original: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(acp_t) x_0 + sqrt(1-acp_t) eps in fp32 (reference: scheduling_ddpm.py:501)."""
    sa, sb = _coefs(schedule, timesteps, original.dim())
    return sa * original.float() + sb * noise.float()


def get_velocity(schedule: NoiseSchedule, sample: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
    """v = sqrt(acp) eps - sqrt(1-acp) x_0 (the v-prediction target), fp32."""
    sa, sb = _coefs(schedule, timesteps, sample.dim())
    return sa * noise.float() - sb * sample.float()


def compute_snr(schedule: NoiseSchedule, timesteps: torch.Tensor) -> torch.Tensor:
    """SNR(t) = acp/(1-acp) (reference: src/diffusers/training_utils.py:50)."""
    acp = schedule.alphas_cumprod_at(timesteps)
    return acp / (1.0 - acp)


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
