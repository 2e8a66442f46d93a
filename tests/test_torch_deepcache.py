"""The port's approximate denoise modes against the JAX package, on the CPU
in fp32: the UNet's DeepCache (`cached_deep` / `return_deep`) and encoder
reuse (`cached_encoder` / `return_encoder`), the pipeline's
`enable_deep_cache` / `enable_encoder_reuse`, its `dispatch` switch, and
`parallel.sharded_vae.tiled_decode`.

Tolerances:
- a cache used at the step that made it gives the full forward's output
  exactly (the same ops on the same inputs);
- a stale cache changes the output;
- the pipeline: the decoded float image within 1e-3, uint8 within 1 level
  (as tests/test_torch_pipeline.py);
- `dispatch="per_step"`: bit-identical to the default (one loop here);
- tiled decode: 1e-4 of the image's largest value against JAX's.
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
from reflecting_reality_tpu.parallel.sharded_vae import tiled_decode as j_tiled_decode
from reflecting_reality_tpu.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline as JPipeline,
)
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.parallel.sharded_vae import tiled_decode
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from tests.test_torch_helpers import (
    TINY, TINY_TEXT, TINY_VAE, nchw_to_nhwc, nhwc_to_nchw, port_and_jax, randn,
)
from tests.test_torch_pipeline import _call_kwargs
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

STEPS = 4            # interval 3: full, cached, cached, full


@pytest.fixture(scope="module")
def unets():
    unet, params = port_and_jax(UNet2DConditionModel, 0, sample_size=8, **TINY)
    return JUNet(sample_size=8, **TINY), params, unet


@pytest.fixture(scope="module")
def pipes(unets):
    """The tiny pipelines of tests/test_torch_pipeline.py's configs, JAX and
    port on the same weights."""
    ju, up, unet = unets
    vae, vp = port_and_jax(AutoencoderKL, 2, **TINY_VAE)
    text, tp = port_and_jax(CLIPTextModel, 3, **TINY_TEXT)
    brushnet, bp = port_and_jax(BrushNetModel, 1, conditioning_channels=6, **TINY)
    j = JPipeline(vae=(JVAE(**TINY_VAE), vp), text_encoder=(JCLIP(**TINY_TEXT), tp),
                  tokenizer=JHashTokenizer(vocab_size=1000), unet=(ju, up),
                  brushnet=(JBrushNet(conditioning_channels=6, **TINY), bp),
                  depth_conditioning_mode="concat")
    t = StableDiffusionBrushNetPipeline(
        vae=vae, text_encoder=text, tokenizer=HashTokenizer(vocab_size=1000), unet=unet,
        brushnet=brushnet, depth_conditioning_mode="concat", device="cpu")
    return j, t


def _inputs(seed=0):
    x, ehs, t = randn(seed, 2, 8, 8, 4), randn(seed + 1, 2, 77, 32), np.array([10, 500])
    return x, ehs, t


def _residuals(seed):
    """A BrushNet-shaped residual stack for the tiny UNet (12 down, 1 mid,
    15 up), NCHW, from a seed."""
    r = np.random.RandomState(seed)
    chans = [8] * 4 + [16] * 8
    sizes = [8, 8, 8, 4, 4, 4, 2, 2, 2, 1, 1, 1]
    down = [0.05 * r.standard_normal((2, c, s, s)).astype(np.float32)
            for c, s in zip(chans, sizes)]
    mid = 0.05 * r.standard_normal((2, 16, 1, 1)).astype(np.float32)
    up_spec = [(16, 1)] * 3 + [(16, 2)] + [(16, 2)] * 3 + [(16, 4)] + [(16, 4)] * 3 + \
        [(16, 8)] + [(8, 8)] * 3
    up = [0.05 * r.standard_normal((2, c, s, s)).astype(np.float32) for c, s in up_spec]
    return down, mid, up


def _kw(res):
    if res is None:
        return {}
    down, mid, up = res
    conv = torch.from_numpy
    return dict(down_block_add_samples=[conv(d) for d in down],
                mid_block_add_sample=conv(mid), up_block_add_samples=[conv(u) for u in up])


@pytest.mark.parametrize("injected", [False, True])
def test_same_step_cache_equals_the_full_forward(unets, injected):
    """DeepCache's trunk and encoder reuse's encoder stack, used at the step
    that made them, give the full forward's output exactly, with and
    without BrushNet residuals injected (the full forward is held against
    JAX's in tests/test_torch_models.py)."""
    _, _, unet = unets
    x, ehs, t = _inputs()
    args = (nhwc_to_nchw(x), torch.from_numpy(t), torch.from_numpy(ehs))
    kw = _kw(_residuals(3) if injected else None)
    with torch.no_grad():
        full = unet(*args, **kw)
        full_d, deep = unet(*args, return_deep=True, **kw)
        shallow, deep2 = unet(*args, cached_deep=deep, **kw)
        full_e, enc = unet(*args, return_encoder=True, **kw)
        er_kw = {k: v for k, v in kw.items() if k != "down_block_add_samples"}
        reused, enc2 = unet(*args, cached_encoder=enc, return_encoder=True, **er_kw)
    for out in (full_d, shallow, full_e, reused):
        assert torch.equal(out, full)
    assert deep2 is deep and enc2[0] is enc[0]
    with pytest.raises(ValueError, match="exclusive"):
        unet(*args, cached_deep=deep, cached_encoder=enc)


@pytest.mark.parametrize("mode", ["deep", "encoder"])
def test_stale_cache_differs(unets, mode):
    """A cache from other latents changes the output (the cached pipelines
    below hold the stale-cache path against JAX's)."""
    _, _, unet = unets
    x, ehs, t = _inputs()
    args = (torch.from_numpy(t), torch.from_numpy(ehs))
    kw = _kw(_residuals(4))
    with torch.no_grad():
        new = unet(nhwc_to_nchw(1.5 * x), *args, **kw)
        if mode == "deep":
            _, cache = unet(nhwc_to_nchw(x), *args, return_deep=True, **kw)
            stale, _ = unet(nhwc_to_nchw(1.5 * x), *args, cached_deep=cache, **kw)
        else:
            _, cache = unet(nhwc_to_nchw(x), *args, return_encoder=True, **kw)
            kw.pop("down_block_add_samples")
            stale, _ = unet(nhwc_to_nchw(1.5 * x), *args, cached_encoder=cache,
                            return_encoder=True, **kw)
    assert (new - stale).abs().max().item() > 1e-4


def test_cached_modes_refuse_what_jax_refuses(pipes):
    _, tpipe = pipes
    kw = dict(_call_kwargs(), num_inference_steps=2)
    with pytest.raises(ValueError, match="interval"):
        tpipe.enable_deep_cache(0)
    tpipe.enable_deep_cache(2)
    tpipe.enable_encoder_reuse(2)
    try:
        with pytest.raises(ValueError, match="mutually exclusive"):
            tpipe(**kw)
        tpipe.disable_encoder_reuse()
        with pytest.raises(ValueError, match="guess_mode"):
            tpipe(**kw, guess_mode=True)
        with pytest.raises(ValueError, match="loop"):
            tpipe(**kw, dispatch="loop")
    finally:
        tpipe.disable_deep_cache()
        tpipe.disable_encoder_reuse()
    tpipe.enable_deep_cache(1)               # interval 1 is the exact path
    assert tpipe._deep_cache is None


@pytest.mark.parametrize("mode", ["deep_cache", "encoder_reuse"])
def test_cached_pipeline_matches_jax(pipes, mode):
    """Interval 3 over 4 steps (full, cached, cached, full) against JAX's
    pipeline on the same latents; the approximate image differs from the
    exact one, `dispatch="per_step"` gives the same bits, and disabling the
    mode gives the exact path back."""
    jpipe, tpipe = pipes
    kw = dict(_call_kwargs(), num_inference_steps=STEPS)
    jkw = dict(kw, latents=jnp.asarray(kw["latents"]))
    exact = tpipe(**kw, output_type="latent")
    getattr(jpipe, f"enable_{mode}")(3)
    getattr(tpipe, f"enable_{mode}")(3)
    try:
        ref = np.asarray(jpipe(**jkw, output_type="latent"))
        got = tpipe(**kw, output_type="latent")
        per_step = tpipe(**kw, output_type="latent", dispatch="per_step")
    finally:
        getattr(jpipe, f"disable_{mode}")()
        getattr(tpipe, f"disable_{mode}")()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-3, np.abs(got - ref).max()
    got8, ref8 = (np.round(np.clip(x / 2 + 0.5, 0, 1) * 255).astype(int) for x in (got, ref))
    assert np.abs(got8 - ref8).max() <= 1
    np.testing.assert_array_equal(per_step, got)
    assert np.abs(got - exact).max() > 1e-3
    np.testing.assert_array_equal(tpipe(**kw, output_type="latent"), exact)


def test_dispatch_per_step_equals_the_default(pipes):
    _, tpipe = pipes
    kw = _call_kwargs()
    np.testing.assert_array_equal(tpipe(**kw, dispatch="per_step"), tpipe(**kw))


@pytest.mark.parametrize("num_tiles,overlap", [(4, 2), (2, 3)])
def test_tiled_decode_matches_jax(num_tiles, overlap):
    """The tiled decode against JAX's on the same weights and latents; it
    stays near the plain decode (per-tile GroupNorm statistics)."""
    jv = JVAE(**TINY_VAE)
    vae, params = port_and_jax(AutoencoderKL, 2, **TINY_VAE)
    z = 0.5 * randn(5, 1, 8, 16, 4)
    want = np.asarray(jax.jit(lambda p, x: j_tiled_decode(jv, p, x, num_tiles, overlap, 8))(
        params, jnp.asarray(z)))
    with torch.no_grad():
        got = tiled_decode(vae, nhwc_to_nchw(z), num_tiles=num_tiles, overlap=overlap)
        plain = vae.decode(nhwc_to_nchw(z))
    assert got.shape == plain.shape == (1, 3, 64, 128)
    np.testing.assert_allclose(nchw_to_nhwc(got), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert (got - plain).abs().max().item() < 0.5 * plain.abs().max().item()
    with pytest.raises(ValueError, match="tiles"):
        tiled_decode(vae, nhwc_to_nchw(z[:, :, :6]), num_tiles=4, overlap=2)
