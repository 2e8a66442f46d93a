"""PyTorch port vs the JAX package, model by model, on the CPU in fp32, at
the tiny configs of tests/test_pipeline.py with jittered weights (so the
zero convs and the 28 injections carry signal).

Tolerance: rtol/atol 1e-4 on outputs of order one.  Both sides are fp32;
the difference is summation order through a few dozen conv and matmul
layers (a few ulps each).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.models.brushnet import BrushNetModel as JBrushNet
from reflecting_reality_tpu.models.clip_text import CLIPTextModel as JCLIP
from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel as JUNet
from reflecting_reality_tpu.models.vae import AutoencoderKL as JVAE
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from tests.test_torch_helpers import (
    TINY, TINY_TEXT, TINY_VAE, init_jax, nchw_to_nhwc, nhwc_to_nchw, randn, to_torch,
)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def brushnet_pair():
    jm = JBrushNet(conditioning_channels=6, **TINY)
    args = (jnp.zeros((1, 8, 8, 4)), jnp.array([1]), jnp.zeros((1, 77, 32)),
            jnp.zeros((1, 8, 8, 6)))
    p = init_jax(jm, *args, seed=1)
    return jm, p, to_torch(BrushNetModel(conditioning_channels=6, **TINY), p)


def _inputs(b=2):
    x = randn(10, b, 8, 8, 4)
    t = np.array([999, 500][:b], np.int32)
    ehs = randn(11, b, 77, 32)
    return x, t, ehs


@pytest.mark.parametrize("guess_mode", [False, True])
def test_brushnet_residuals(brushnet_pair, guess_mode):
    jm, p, tm = brushnet_pair
    x, t, ehs = _inputs()
    cond = randn(12, 2, 8, 8, 6)
    jd, jmid, ju = jm.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs),
                            jnp.asarray(cond), conditioning_scale=0.8, guess_mode=guess_mode)
    with torch.no_grad():
        td, tmid, tu = tm(nhwc_to_nchw(x), torch.from_numpy(t), torch.from_numpy(ehs),
                          nhwc_to_nchw(cond), conditioning_scale=0.8, guess_mode=guess_mode)
    assert len(td) == len(jd) == 12 and len(tu) == len(ju) == 15
    for a, b in zip(list(td) + [tmid] + list(tu), list(jd) + [jmid] + list(ju)):
        assert np.abs(np.asarray(b)).max() > 0
        np.testing.assert_allclose(nchw_to_nhwc(a), np.asarray(b), **TOL)


def test_unet_with_28_add_samples(brushnet_pair):
    """The UNet consumes the BrushNet's 12/1/15 residuals in the JAX pop
    order; the time embedding comes in precomputed, as on the pipeline path."""
    jbn, bp, _ = brushnet_pair
    ju = JUNet(sample_size=8, **TINY)
    x, t, ehs = _inputs()
    p = init_jax(ju, jnp.zeros((1, 8, 8, 4)), jnp.array([1]), jnp.zeros((1, 77, 32)), seed=2)
    tu = to_torch(UNet2DConditionModel(sample_size=8, **TINY), p)
    down, mid, up = jbn.apply(bp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs),
                              jnp.asarray(randn(12, 2, 8, 8, 6)))
    ref = ju.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs),
                   down_block_add_samples=down, mid_block_add_sample=mid,
                   up_block_add_samples=up)
    from reflecting_reality_tpu_torch.ops.embeddings import precompute_time_embeddings

    temb = precompute_time_embeddings(tu, t)
    with torch.no_grad():
        got = tu(nhwc_to_nchw(x), None, torch.from_numpy(ehs),
                 down_block_add_samples=[nhwc_to_nchw(d) for d in down],
                 mid_block_add_sample=nhwc_to_nchw(mid),
                 up_block_add_samples=[nhwc_to_nchw(u) for u in up], temb=temb)
        plain = tu(nhwc_to_nchw(x), torch.from_numpy(t), torch.from_numpy(ehs))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(ref), **TOL)
    ref_plain = ju.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs))
    np.testing.assert_allclose(nchw_to_nhwc(plain), np.asarray(ref_plain), **TOL)


def test_vae_encode_mode_and_decode():
    jm = JVAE(**TINY_VAE)
    from jax import random

    p = init_jax(jm, jnp.zeros((1, 64, 64, 3)), random.PRNGKey(9), seed=3)
    tm = to_torch(AutoencoderKL(**TINY_VAE), p)
    img = np.tanh(randn(13, 1, 64, 64, 3))
    z = randn(14, 1, 8, 8, 4)
    ref_mode = jm.apply(p, jnp.asarray(img), method=jm.encode).mode
    ref_dec = jm.apply(p, jnp.asarray(z), method=jm.decode)
    with torch.no_grad():
        got_mode = tm.encode(nhwc_to_nchw(img)).mode
        got_dec = tm.decode(nhwc_to_nchw(z))
    np.testing.assert_allclose(nchw_to_nhwc(got_mode), np.asarray(ref_mode), **TOL)
    np.testing.assert_allclose(nchw_to_nhwc(got_dec), np.asarray(ref_dec), **TOL)


def test_clip_text():
    jm = JCLIP(**TINY_TEXT)
    p = init_jax(jm, jnp.zeros((1, 77), jnp.int32), seed=4)
    tm = to_torch(CLIPTextModel(**TINY_TEXT), p)
    ids = np.random.RandomState(5).randint(0, 1000, (2, 77)).astype(np.int32)
    ref = jm.apply(p, jnp.asarray(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_brushnet_global_pool_conditions():
    """global_pool_conditions mean-pools every residual over space and
    bypasses the guess-mode ramp (reference brushnet.py:895-916)."""
    cfg = dict(TINY, conditioning_channels=6, global_pool_conditions=True)
    jm = JBrushNet(**cfg)
    args = (jnp.zeros((1, 8, 8, 4)), jnp.array([1]), jnp.zeros((1, 77, 32)),
            jnp.zeros((1, 8, 8, 6)))
    p = init_jax(jm, *args, seed=6)
    tm = to_torch(BrushNetModel(**cfg), p)
    x, t, ehs = _inputs(b=1)
    cond = randn(12, 1, 8, 8, 6)
    jd, jmid, ju = jm.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs),
                            jnp.asarray(cond), conditioning_scale=0.5, guess_mode=True)
    with torch.no_grad():
        td, tmid, tu = tm(nhwc_to_nchw(x), torch.from_numpy(t), torch.from_numpy(ehs),
                          nhwc_to_nchw(cond), conditioning_scale=0.5, guess_mode=True)
    for a, b in zip(list(td) + [tmid] + list(tu), list(jd) + [jmid] + list(ju)):
        assert a.shape[2:] == (1, 1)
        np.testing.assert_allclose(nchw_to_nhwc(a), np.asarray(b), **TOL)
