"""Functional DDPM ancestral step (counterpart of
`reflecting_reality_tpu/schedulers/ddpm.py`; reference:
scheduling_ddpm.py:129, step at :399).

Training adds noise with `common.add_noise` and sampling uses UniPC or DDIM;
this step is here for completeness.  Variance type 'fixed_small' only, the
DDPM default.  The noise is passed in, or drawn from an explicit
`torch.Generator`.
"""

from __future__ import annotations

from typing import Optional

import torch

from reflecting_reality_tpu_torch.schedulers.common import NoiseSchedule


def ddpm_step(
    schedule: NoiseSchedule,
    model_output: torch.Tensor,
    timestep: int,
    prev_timestep: int,
    sample: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    clip_sample: bool = True,
    clip_sample_range: float = 1.0,
) -> torch.Tensor:
    """x_t -> x_{prev} for ε, v or sample predictions (`schedule.prediction_type`),
    in fp32, returned in `sample`'s dtype."""
    acp = schedule.alphas_cumprod
    t, t_prev = int(timestep), int(prev_timestep)
    alpha_prod_t = acp[t]
    alpha_prod_prev = acp[t_prev] if t_prev >= 0 else torch.tensor(1.0)
    beta_prod_t = 1.0 - alpha_prod_t
    beta_prod_prev = 1.0 - alpha_prod_prev
    current_alpha = alpha_prod_t / alpha_prod_prev
    current_beta = 1.0 - current_alpha

    x = sample.float()
    eps = model_output.float()
    if schedule.prediction_type == "epsilon":
        pred_x0 = (x - beta_prod_t.sqrt() * eps) / alpha_prod_t.sqrt()
    elif schedule.prediction_type == "v_prediction":
        pred_x0 = alpha_prod_t.sqrt() * x - beta_prod_t.sqrt() * eps
    elif schedule.prediction_type == "sample":
        pred_x0 = eps
    else:
        raise ValueError(schedule.prediction_type)
    if clip_sample:
        pred_x0 = pred_x0.clamp(-clip_sample_range, clip_sample_range)

    pred_x0_coeff = alpha_prod_prev.sqrt() * current_beta / beta_prod_t
    current_coeff = current_alpha.sqrt() * beta_prod_prev / beta_prod_t
    mean = pred_x0_coeff * pred_x0 + current_coeff * x
    if t <= 0:
        return mean.to(sample.dtype)
    if noise is None:
        noise = torch.randn(sample.shape, generator=generator, device=sample.device)
    variance = torch.clamp(beta_prod_prev / beta_prod_t * current_beta, min=1e-20)
    return (mean + variance.sqrt() * noise.to(sample.device).float()).to(sample.dtype)
