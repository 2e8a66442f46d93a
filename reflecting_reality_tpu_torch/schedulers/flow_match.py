"""Flow-matching Euler sampling as FLUX.1 runs it (reference: diffusers
scheduling_flow_match_euler_discrete.py `FlowMatchEulerDiscreteScheduler`
with `use_dynamic_shifting`, and `calculate_shift` in pipeline_flux_fill.py).

The pipeline's sigmas are linspace(1, 1/n, n).  The shift mu grows
linearly with the number of image tokens, from `base_shift` at
`base_image_seq_len` to `max_shift` at `max_image_seq_len` (FLUX: 0.5 at
256, 1.15 at 4096, so 1.15 at 1024²), and each sigma becomes
e^mu / (e^mu + 1/sigma - 1); a final sigma of 0 closes the list.  The
model is asked at timestep sigma (diffusers passes sigma x 1000 / 1000),
and a step is x <- x + (sigma_next - sigma) v.  Sigmas are formed in
float64 and kept in float32; the step runs in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def calculate_shift(image_seq_len: int, base_image_seq_len: int = 256,
                    max_image_seq_len: int = 4096, base_shift: float = 0.5,
                    max_shift: float = 1.15) -> float:
    m = (max_shift - base_shift) / (max_image_seq_len - base_image_seq_len)
    return image_seq_len * m + base_shift - m * base_image_seq_len


def flow_match_sigmas(num_inference_steps: int, image_seq_len: int, **shift) -> np.ndarray:
    """(n + 1,) float32: the n shifted sigmas, then 0."""
    mu = calculate_shift(image_seq_len, **shift)
    sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
    shifted = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    return np.append(shifted, 0.0).astype(np.float32)


def euler_step(sample: torch.Tensor, velocity: torch.Tensor, sigma: float,
               sigma_next: float) -> torch.Tensor:
    """x + (sigma_next - sigma) v in float32."""
    return sample.float() + (float(sigma_next) - float(sigma)) * velocity.float()
