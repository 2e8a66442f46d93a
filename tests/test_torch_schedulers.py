"""PyTorch port vs the JAX package: UniPC (orders 1-3) and DDIM trajectories
driven by the same model outputs, and the DDPM ancestral step with JAX's
noise passed in (one step, fp32 coefficients on both sides: 1e-6).

The "model" is a fixed function of the sample and the step: eps_i =
0.9·x + n_i with n_i numpy noise, evaluated in each framework on its own
trajectory.  Tolerances, over 10-20 fp32 steps: both sides compute the same
scalar coefficients in fp32 and differ in the rounding order of a handful
of elementwise ops per step, which the multistep history carries forward.
Orders 1-2 and DDIM are held at rtol/atol 2e-5.  Order 3's 3x3 Cramer solve
is ill-conditioned in fp32: each implementation lands 3-7e-5 from a float64
run of the same 20-step trajectory, so order 3 is held at 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.schedulers.common import NoiseSchedule as JSchedule
from reflecting_reality_tpu.schedulers.common import ddim_timesteps as j_ddim_ts
from reflecting_reality_tpu.schedulers.ddim import ddim_step as j_ddim_step
from reflecting_reality_tpu.schedulers.ddpm import ddpm_step as j_ddpm_step
from reflecting_reality_tpu.schedulers.unipc import UniPCSampler as JUniPC
from reflecting_reality_tpu_torch.schedulers.common import NoiseSchedule, ddim_timesteps
from reflecting_reality_tpu_torch.schedulers.ddim import ddim_step
from reflecting_reality_tpu_torch.schedulers.ddpm import ddpm_step
from reflecting_reality_tpu_torch.schedulers.unipc import UniPCSampler
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_ORDER3 = dict(rtol=2e-4, atol=2e-4)
SD = dict(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
          beta_schedule="scaled_linear")


def _noise(steps):
    rng = np.random.RandomState(0)
    return rng.standard_normal((steps, 1, 4, 8, 8)).astype(np.float32)


@pytest.mark.parametrize("steps", [10, 20])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_unipc_trajectory(order, steps):
    js = JUniPC(JSchedule.create(**SD), steps, solver_order=order)
    ts = UniPCSampler(NoiseSchedule.create(**SD), steps, solver_order=order)
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    noise = _noise(steps)
    x0 = np.random.RandomState(1).standard_normal((1, 4, 8, 8)).astype(np.float32)
    jx, jst = jnp.asarray(x0), js.init_state(jnp.asarray(x0))
    tx, tst = torch.from_numpy(x0), ts.init_state(torch.from_numpy(x0))
    tol = TOL_ORDER3 if order == 3 else TOL
    for i in range(steps):
        jx, jst = js.step(0.9 * jx + noise[i], i, jx, jst)
        tx, tst = ts.step(0.9 * tx + torch.from_numpy(noise[i]), i, tx, tst)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **tol)
    np.testing.assert_allclose(tst.model_outputs.numpy(), np.asarray(jst.model_outputs), **tol)
    np.testing.assert_allclose(tst.last_sample.numpy(), np.asarray(jst.last_sample), **tol)


def test_ddim_trajectory():
    steps = 10
    jsched, tsched = JSchedule.create(**SD), NoiseSchedule.create(**SD)
    jts = j_ddim_ts(1000, steps)
    tts = ddim_timesteps(1000, steps)
    np.testing.assert_array_equal(jts, tts)
    noise = _noise(steps)
    x0 = np.random.RandomState(1).standard_normal((1, 4, 8, 8)).astype(np.float32)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    for i in range(steps):
        t, tp = int(tts[i]), int(tts[i + 1]) if i + 1 < steps else -1
        jx = j_ddim_step(jsched, 0.9 * jx + noise[i], jnp.int32(t), jnp.int32(tp), jx)
        tx = ddim_step(tsched, 0.9 * tx + torch.from_numpy(noise[i]), t, tp, tx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
@pytest.mark.parametrize("t,t_prev,clip", [(999, 979, True), (500, 480, False), (20, 0, True),
                                          (0, -1, True)])
def test_ddpm_step_matches_jax(prediction_type, t, t_prev, clip):
    jsched = JSchedule.create(**SD, prediction_type=prediction_type)
    tsched = NoiseSchedule.create(**SD, prediction_type=prediction_type)
    r = np.random.RandomState(t)
    x = r.standard_normal((2, 4, 8, 8)).astype(np.float32)
    out = r.standard_normal((2, 4, 8, 8)).astype(np.float32)
    rng = jax.random.PRNGKey(t)
    want = j_ddpm_step(jsched, jnp.asarray(out), jnp.int32(t), jnp.int32(t_prev),
                       jnp.asarray(x), rng, clip_sample=clip)
    noise = np.array(jax.random.normal(rng, x.shape, jnp.float32))
    got = ddpm_step(tsched, torch.from_numpy(out), t, t_prev, torch.from_numpy(x),
                    noise=torch.from_numpy(noise), clip_sample=clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if t > 0:       # drawn from a generator when no noise is given: a different draw
        g = torch.Generator().manual_seed(0)
        other = ddpm_step(tsched, torch.from_numpy(out), t, t_prev, torch.from_numpy(x),
                          generator=g, clip_sample=clip)
        assert other.shape == got.shape and not torch.equal(other, got)
