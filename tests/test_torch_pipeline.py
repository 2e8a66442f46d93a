"""The whole tiny pipeline, PyTorch port vs the JAX package, on the CPU in fp32.

Same converted weights (jittered, so BrushNet's zero convs inject), the same
initial latents (`latents=`) and the VAE encode pinned to its mode
(`deterministic_vae_encode=True`), since torch and jax RNG streams differ.
3 UniPC steps, CFG 7.5, depth concat, 64x64.

Tolerance: the decoded float image (`output_type="latent"`) within 1e-3 max
abs: fp32 on both sides, the differences are summation order through ~100
layers per step, amplified by CFG 7.5.  The uint8 images may then differ by
at most 1 where a value sits on a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from reflecting_reality_tpu.models.brushnet import BrushNetModel as JBrushNet
from reflecting_reality_tpu.models.clip_text import CLIPTextModel as JCLIP
from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel as JUNet
from reflecting_reality_tpu.models.vae import AutoencoderKL as JVAE
from reflecting_reality_tpu.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline as JPipeline,
)
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from tests.test_torch_helpers import TINY, TINY_TEXT, TINY_VAE, init_jax, randn, to_torch

H = W = 64
STEPS = 3


@pytest.fixture(scope="module")
def pipes():
    z8 = jnp.zeros((1, 8, 8, 4))
    t, ehs = jnp.array([1]), jnp.zeros((1, 77, 32))
    ju, jb = JUNet(sample_size=8, **TINY), JBrushNet(conditioning_channels=6, **TINY)
    jv, jt = JVAE(**TINY_VAE), JCLIP(**TINY_TEXT)
    up = init_jax(ju, z8, t, ehs, seed=0)
    bp = init_jax(jb, z8, t, ehs, jnp.zeros((1, 8, 8, 6)), seed=1)
    vp = init_jax(jv, jnp.zeros((1, H, W, 3)), jax.random.PRNGKey(9), seed=2)
    tp = init_jax(jt, jnp.zeros((1, 77), jnp.int32), seed=3)
    jpipe = JPipeline(vae=(jv, vp), text_encoder=(jt, tp),
                      tokenizer=JHashTokenizer(vocab_size=1000),
                      unet=(ju, up), brushnet=(jb, bp), depth_conditioning_mode="concat")
    tpipe = StableDiffusionBrushNetPipeline(
        vae=to_torch(AutoencoderKL(**TINY_VAE), vp),
        text_encoder=to_torch(CLIPTextModel(**TINY_TEXT), tp),
        tokenizer=HashTokenizer(vocab_size=1000),
        unet=to_torch(UNet2DConditionModel(sample_size=8, **TINY), up),
        brushnet=to_torch(BrushNetModel(conditioning_channels=6, **TINY), bp),
        depth_conditioning_mode="concat", device="cpu",
    )
    return jpipe, tpipe


def _call_kwargs():
    rng = np.random.RandomState(0)
    image = rng.rand(H, W, 3).astype(np.float32)
    mask = np.zeros((H, W, 3), np.float32)
    mask[16:48, 16:48] = 1.0
    return dict(prompt="a photo of a mirror", image=image, mask=mask,
                depth=rng.rand(H, W, 1).astype(np.float32), num_inference_steps=STEPS,
                guidance_scale=7.5, latents=randn(7, 1, 8, 8, 4),
                deterministic_vae_encode=True, scheduler="unipc")


def test_pipeline_matches_jax(pipes):
    jpipe, tpipe = pipes
    kw = _call_kwargs()
    ref = np.asarray(jpipe(**dict(kw, latents=jnp.asarray(kw["latents"])), output_type="latent"))
    got = tpipe(**kw, output_type="latent")
    assert got.shape == ref.shape == (1, H, W, 3)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-3, np.abs(got - ref).max()

    ref8 = jpipe(**dict(kw, latents=jnp.asarray(kw["latents"])), output_type="np")
    got8 = tpipe(**kw, output_type="np")
    assert got8.dtype == np.uint8 and got8.shape == (1, H, W, 3)
    assert np.abs(got8.astype(int) - ref8.astype(int)).max() <= 1


@pytest.mark.parametrize("variant", [
    dict(guess_mode=True),                              # branch on the cond half only
    dict(guidance_scale=1.0, scheduler="ddim"),         # no CFG, DDIM loop
    dict(control_guidance_start=0.34, brushnet_conditioning_scale=0.7),
])
def test_pipeline_variants_match_jax(pipes, variant):
    jpipe, tpipe = pipes
    kw = dict(_call_kwargs(), **variant)
    ref = np.asarray(jpipe(**dict(kw, latents=jnp.asarray(kw["latents"])), output_type="latent"))
    got = tpipe(**kw, output_type="latent")
    assert np.abs(got - ref).max() <= 1e-3, np.abs(got - ref).max()


def test_device_output_matches_np(pipes):
    _, tpipe = pipes
    kw = _call_kwargs()
    dev = tpipe(**kw, output_type="device")
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    np.testing.assert_array_equal(dev.numpy(), tpipe(**kw, output_type="np"))


def test_entry_point_defaults_to_the_card(pipes):
    """Without device= the pipeline asks for CUDA; on a machine without a
    card that raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    _, tpipe = pipes
    with pytest.raises(RuntimeError, match="cuda"):
        StableDiffusionBrushNetPipeline(
            vae=tpipe.vae, text_encoder=tpipe.text_encoder, tokenizer=tpipe.tokenizer,
            unet=tpipe.unet, brushnet=tpipe.brushnet, depth_conditioning_mode="concat")
    with pytest.raises(RuntimeError, match="cuda"):
        StableDiffusionBrushNetPipeline.from_pretrained("/nonexistent", "/nonexistent")
