"""DDIM step (counterpart of `reflecting_reality_tpu/schedulers/ddim.py`;
reference: src/diffusers/schedulers/scheduling_ddim.py:131,344).

Stateless, deterministic (eta = 0), epsilon prediction; with
set_alpha_to_one=False (the SD convention) a negative prev_timestep uses
alphas_cumprod[0].
"""

from __future__ import annotations

import torch

from reflecting_reality_tpu_torch.schedulers.common import NoiseSchedule


def ddim_step(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    timestep: int,
    prev_timestep: int,
    sample: torch.Tensor,
) -> torch.Tensor:
    acp = schedule.alphas_cumprod
    alpha_prod_t = acp[int(timestep)]
    alpha_prod_prev = acp[int(prev_timestep)] if prev_timestep >= 0 else acp[0]

    eps = model_output.float()
    pred_x0 = (sample.float() - torch.sqrt(1.0 - alpha_prod_t) * eps) / torch.sqrt(alpha_prod_t)
    prev_sample = torch.sqrt(alpha_prod_prev) * pred_x0 + torch.sqrt(1.0 - alpha_prod_prev) * eps
    return prev_sample.to(sample.dtype)
