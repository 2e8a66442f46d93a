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
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

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


@pytest.fixture(scope="module")
def mode_brushnets():
    """One tiny BrushNet per conditioning width the modes below need, JAX
    and port with the same jittered weights: 5 + 4 (depth latents) = 5 + 4
    (normals latents) = 5 + 1 + 3 (depth concat + normals concat) = 9, and
    5 + 3 (normals concat alone) = 8."""
    z8 = jnp.zeros((1, 8, 8, 4))
    t, ehs = jnp.array([1]), jnp.zeros((1, 77, 32))
    out = {}
    for ch in (8, 9):
        jb = JBrushNet(conditioning_channels=ch, **TINY)
        bp = init_jax(jb, z8, t, ehs, jnp.zeros((1, 8, 8, ch)), seed=10 + ch)
        out[ch] = (jb, bp)
    return out


MODES = {  # (depth mode, normals mode) -> conditioning channels
    ("latents", None): 9, (None, "concat"): 8, (None, "latents"): 9, ("concat", "concat"): 9,
}


def _mode_pipes(pipes, mode_brushnets, depth_mode, normals_mode):
    jpipe, tpipe = pipes
    jb, bp = mode_brushnets[MODES[(depth_mode, normals_mode)]]
    j = JPipeline(vae=(jpipe.vae_module, jpipe.vae_params),
                  text_encoder=(jpipe.text_module, jpipe.text_params),
                  tokenizer=jpipe.tokenizer, unet=(jpipe.unet_module, jpipe.unet_params),
                  brushnet=(jb, bp), depth_conditioning_mode=depth_mode,
                  normals_conditioning_mode=normals_mode)
    t = StableDiffusionBrushNetPipeline(
        vae=tpipe.vae, text_encoder=tpipe.text_encoder, tokenizer=tpipe.tokenizer,
        unet=tpipe.unet,
        brushnet=to_torch(BrushNetModel(conditioning_channels=jb.conditioning_channels,
                                        **TINY), bp),
        depth_conditioning_mode=depth_mode, normals_conditioning_mode=normals_mode, device="cpu")
    return j, t


@pytest.mark.parametrize("depth_mode,normals_mode", list(MODES))
def test_conditioning_modes_match_jax(pipes, mode_brushnets, depth_mode, normals_mode):
    """Depth `latents` (a 3-channel repeat through the VAE encoder), normals
    `concat` (a 3-channel nearest downsample) and `latents` (a VAE encode),
    and depth + normals `concat` together, against the JAX pipeline."""
    jpipe, tpipe = _mode_pipes(pipes, mode_brushnets, depth_mode, normals_mode)
    rng = np.random.RandomState(3)
    kw = dict(_call_kwargs(), normals=rng.rand(H, W, 3).astype(np.float32))
    if depth_mode is None:
        kw.pop("depth")
    ref = np.asarray(jpipe(**dict(kw, latents=jnp.asarray(kw["latents"])), output_type="latent"))
    got = tpipe(**kw, output_type="latent")
    assert got.shape == ref.shape == (1, H, W, 3) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-3, np.abs(got - ref).max()
    # the uint8 conversion of both (test_pipeline_matches_jax holds the
    # pipelines' own uint8 paths)
    got8, ref8 = (np.round(np.clip(x / 2 + 0.5, 0, 1) * 255).astype(int) for x in (got, ref))
    assert np.abs(got8 - ref8).max() <= 1


def test_seeds_share_the_conditioning_planes_as_in_jax(pipes, mode_brushnets):
    """num_images_per_prompt=2 in depth `latents` (the `reps` path): the one
    image and depth plane are encoded once and broadcast to both seeds."""
    jpipe, tpipe = _mode_pipes(pipes, mode_brushnets, "latents", None)
    kw = dict(_call_kwargs(), num_images_per_prompt=2, latents=randn(8, 2, 8, 8, 4))
    ref = np.asarray(jpipe(**dict(kw, latents=jnp.asarray(kw["latents"])), output_type="latent"))
    got = tpipe(**kw, output_type="latent")
    assert got.shape == ref.shape == (2, H, W, 3)
    assert np.abs(got - ref).max() <= 1e-3, np.abs(got - ref).max()


def test_ip_adapter_mode_names_its_item(pipes):
    """The normals ip_adapter mode (queue A item 14, ported; held against
    JAX in tests/test_torch_ip_adapter.py): refused without its
    NormalProjModel, as in JAX; with one, an ip UNet (to_k_ip/to_v_ip copied
    from to_k/to_v) and the (1, 3) mean normal it generates."""
    from reflecting_reality_tpu_torch.core.io import load_into
    from reflecting_reality_tpu_torch.models import ip_adapter

    _, tpipe = pipes
    with pytest.raises(ValueError, match="normal_proj"):
        StableDiffusionBrushNetPipeline(
            vae=tpipe.vae, text_encoder=tpipe.text_encoder, tokenizer=tpipe.tokenizer,
            unet=tpipe.unet, brushnet=tpipe.brushnet, normals_conditioning_mode="ip_adapter",
            device="cpu")
    unet = UNet2DConditionModel(sample_size=8, ip_num_tokens=ip_adapter.DEFAULT_NUM_TOKENS,
                                **TINY)
    load_into(unet, tpipe.unet.state_dict(), allow_missing=ip_adapter.IP_NAMES)
    pipe = StableDiffusionBrushNetPipeline(
        vae=tpipe.vae, text_encoder=tpipe.text_encoder, tokenizer=tpipe.tokenizer,
        unet=ip_adapter.init_ip_params_from_unet(unet), brushnet=tpipe.brushnet,
        depth_conditioning_mode="concat", normals_conditioning_mode="ip_adapter",
        normal_proj=ip_adapter.NormalProjModel(32), device="cpu")
    out = pipe(**dict(_call_kwargs(), normals=np.array([[0.0, 0.0, 1.0]], np.float32)),
               output_type="latent")
    assert out.shape == (1, H, W, 3) and np.isfinite(out).all()


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
