"""UniPC multistep sampler (counterpart of
`reflecting_reality_tpu/schedulers/unipc.py`; reference:
src/diffusers/schedulers/scheduling_unipc_multistep.py:74,754).

The history is an explicit carry, `UniPCState`, laid out as the JAX one
(:37): `model_outputs` (3, *sample_shape) with [-1] the most recent x0
prediction, and `last_sample`.  The step index is a Python int, so the
per-step predictor/corrector order is a plain branch:

    pred order  p_i = min(solver_order, N - i, i + 1)     [lower_order_final]
    corr order  c_i = min(solver_order, N - i + 1, i)

and the rhos of that order use the same closed forms (Cramer) as JAX.  The
scalar coefficients are computed as fp32 0-d CPU tensors, the JAX rounding.

MirrorFusion inference's configuration is fixed: predict_x0, bh2,
lower_order_final, corrector enabled, epsilon prediction, "linspace"
timesteps; `solver_order` (default 2) is the one option.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from reflecting_reality_tpu_torch.schedulers.common import NoiseSchedule, linspace_timesteps


class UniPCState(NamedTuple):
    model_outputs: torch.Tensor  # (3, *sample_shape) fp32; [-1] most recent
    last_sample: torch.Tensor    # sample before the latest predictor step


def _safe(x: torch.Tensor) -> torch.Tensor:
    """Replace an exact zero with 1 so divisions stay finite."""
    return torch.where(x == 0, torch.ones_like(x), x)


def _det3(r1, r2, r3, s1, s2, s3, t1, t2, t3):
    """det of [[r1,r2,r3],[s1,s2,s3],[t1,t2,t3]] (scalars)."""
    return (
        r1 * (s2 * t3 - s3 * t2)
        - r2 * (s1 * t3 - s3 * t1)
        + r3 * (s1 * t2 - s2 * t1)
    )


class UniPCSampler:
    """Sigma/lambda tables for a fixed step count; `step` maps
    (model_output, i, sample, state) -> (prev_sample, new_state)."""

    def __init__(self, schedule: NoiseSchedule, num_inference_steps: int,
                 solver_order: int = 2):
        if solver_order not in (1, 2, 3):
            raise ValueError("solver_order must be 1, 2 or 3 (the reference scheduler's "
                             "supported range, scheduling_unipc_multistep.py:74)")
        self.schedule = schedule
        self.num_steps = int(num_inference_steps)
        self.solver_order = solver_order

        ts = linspace_timesteps(schedule.num_train_timesteps, self.num_steps)
        acp = schedule.alphas_cumprod.numpy()
        sig_all = ((1.0 - acp) / acp) ** 0.5
        sigmas = np.interp(ts, np.arange(len(sig_all)), sig_all)
        sigma_last = ((1.0 - acp[0]) / acp[0]) ** 0.5
        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        alphas = 1.0 / np.sqrt(1.0 + sigmas**2)
        sigmas_t = sigmas * alphas
        self.timesteps = ts.astype(np.int64)                              # (N,)
        self._alpha = torch.from_numpy(alphas.astype(np.float32))         # (N+1,)
        self._sigma = torch.from_numpy(sigmas_t.astype(np.float32))       # (N+1,)
        self._lambda = torch.from_numpy(
            (np.log(alphas) - np.log(sigmas_t)).astype(np.float32))

    def init_state(self, sample: torch.Tensor) -> UniPCState:
        z = torch.zeros(sample.shape, dtype=torch.float32, device=sample.device)
        return UniPCState(model_outputs=torch.stack([z, z, z]), last_sample=z)

    @staticmethod
    def _bh_coeffs(hh: torch.Tensor):
        """b_k/B_h per the reference recurrence (uni_p/uni_c :678-694), bh2."""
        h_phi_1 = torch.expm1(hh)
        B_h = h_phi_1
        k1 = h_phi_1 / hh - 1.0
        k2 = k1 / hh - 0.5
        k3 = k2 / hh - 1.0 / 6.0
        return k1 / B_h, 2.0 * k2 / B_h, 6.0 * k3 / B_h, h_phi_1, B_h

    def _convert_to_x0(self, model_output, sample, i):
        """Epsilon prediction -> x0."""
        return (sample.float() - self._sigma[i] * model_output.float()) / self._alpha[i]

    def _effective_orders(self, i: int) -> Tuple[int, int]:
        n, so = self.num_steps, self.solver_order
        return min(so, n - i, i + 1), min(so, n - i + 1, i)

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             state: UniPCState) -> Tuple[torch.Tensor, UniPCState]:
        lam, alp, sig = self._lambda, self._alpha, self._sigma
        i = int(i)
        im1, im2, im3 = max(i - 1, 0), max(i - 2, 0), max(i - 3, 0)

        x0 = self._convert_to_x0(model_output, sample, i)
        m0, m1, m2 = state.model_outputs[2], state.model_outputs[1], state.model_outputs[0]
        p_pred, p_corr = self._effective_orders(i)

        # corrector (uni_c) on the incoming sample, for i >= 1
        if i >= 1:
            h_c = lam[i] - lam[im1]
            b0_c, b1_c, b2_c, h_phi_1_c, B_h_c = self._bh_coeffs(-h_c)
            r1_c = (lam[im2] - lam[im1]) / _safe(h_c)
            r2_c = (lam[im3] - lam[im1]) / _safe(h_c)
            D1_t = x0 - m0
            if p_corr >= 3:
                q1, q2 = r1_c * r1_c, r2_c * r2_c
                det3 = _safe(_det3(1.0, 1.0, 1.0, r1_c, r2_c, 1.0, q1, q2, 1.0))
                rho0 = _det3(b0_c, 1.0, 1.0, b1_c, r2_c, 1.0, b2_c, q2, 1.0) / det3
                rho1 = _det3(1.0, b0_c, 1.0, r1_c, b1_c, 1.0, q1, b2_c, 1.0) / det3
                rhot = _det3(1.0, 1.0, b0_c, r1_c, r2_c, b1_c, q1, q2, b2_c) / det3
                mix = (rho0 * ((m1 - m0) / _safe(r1_c)) + rho1 * ((m2 - m0) / _safe(r2_c))
                       + rhot * D1_t)
            elif p_corr == 2:
                det2 = _safe(1.0 - r1_c)
                rho0 = (b0_c - b1_c) / det2
                rhot = (b1_c - r1_c * b0_c) / det2
                mix = rho0 * ((m1 - m0) / _safe(r1_c)) + rhot * D1_t
            else:
                mix = 0.5 * D1_t
            base = sig[i] / sig[im1] * state.last_sample - alp[i] * h_phi_1_c * m0
            sample_f = base - alp[i] * B_h_c * mix
        else:
            sample_f = sample.float()

        new_outputs = torch.stack([m1, m0, x0])

        # predictor (uni_p): step i -> i + 1
        h_p = lam[i + 1] - lam[i]
        b0_p, b1_p, _, h_phi_1_p, B_h_p = self._bh_coeffs(-h_p)
        prev_sample = sig[i + 1] / sig[i] * sample_f - alp[i + 1] * h_phi_1_p * x0
        if p_pred >= 2:
            r1_p = (lam[im1] - lam[i]) / _safe(h_p)
            D1p_0 = (m0 - x0) / _safe(r1_p)
            if p_pred >= 3:
                r2_p = (lam[im2] - lam[i]) / _safe(h_p)
                det_p3 = _safe(r2_p - r1_p)
                rho0_p = (b0_p * r2_p - b1_p) / det_p3
                rho1_p = (b1_p - b0_p * r1_p) / det_p3
                mix_p = rho0_p * D1p_0 + rho1_p * ((m1 - x0) / _safe(r2_p))
            else:
                mix_p = 0.5 * D1p_0
            prev_sample = prev_sample - alp[i + 1] * B_h_p * mix_p

        return prev_sample.to(sample.dtype), UniPCState(new_outputs, sample_f)
