"""The port's SDXL path against the JAX package, on the CPU in fp32, at the
tiny SDXL config of tests/test_sdxl_pipeline.py (3 blocks, per-block
transformer depths (1, 1, 2), two text encoders of widths 8 and 16, the
text_time addition embedding): the `text_time` UNet and BrushNet forwards,
the encoders' hidden states, `encode_prompt_xl`, and
`StableDiffusionXLBrushNetPipeline` with `latents=` and the deterministic
encode in UniPC and DDIM with two images a prompt, DeepCache, encoder
reuse, int8 and `enable_data_parallel`; the BrushNet CFG dedup shown wrong
under text_time.  The UNet's, BrushNet's and second encoder's weights are
drawn with numpy into JAX's parameter trees (their shapes from
`jax.eval_shape`: no JAX init) and carried to the port by
`core.io.state_dict_from_jax_params` with a strict load, so the text_time
`add_embedding` and `text_projection` leaves cross over by name; the VAE
and the first encoder go the other way (`port_and_jax`).  Each JAX
pipeline call is compiled once and its result shared.

Tolerances:
- the forwards and the text encoders: 1e-4 of the output's largest value
  (fp32; the two sum in other orders);
- the pipeline: the decoded float image within 1e-4 of its largest value
  (2 or 3 steps through the sampler, the VAE decode; fp32 differences of
  1e-6 grow a little through each), and the uint8 image within 1 level (a
  value on a rounding boundary);
- int8: the decoded image within 1e-3 of its largest value (as
  tests/test_torch_quant.py, the activation codes are rounded from floats
  that differ in the last bits on the two sides, so a code can flip), the
  uint8 image within 1 level;
- data parallel: the port's two replicas against JAX's undivided call at
  the pipeline's tolerances.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from reflecting_reality_tpu.models.brushnet import BrushNetModel as JBrushNet
from reflecting_reality_tpu.models.clip_text import CLIPTextModel as JCLIP
from reflecting_reality_tpu.models.clip_text import CLIPTextModelWithProjection as JCLIPProj
from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel as JUNet
from reflecting_reality_tpu.models.vae import AutoencoderKL as JVAE
from reflecting_reality_tpu.ops import quant as jquant
from reflecting_reality_tpu.pipelines.brushnet_sdxl_pipeline import (
    StableDiffusionXLBrushNetPipeline as JPipeline,
)
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import (
    CLIPTextModel, CLIPTextModelWithProjection,
)
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.ops import quant
from reflecting_reality_tpu_torch.ops.embeddings import (
    precompute_time_embeddings, text_time_embedding,
)
from reflecting_reality_tpu_torch.parallel.mesh import make_mesh
from reflecting_reality_tpu_torch.pipelines import StableDiffusionXLBrushNetPipeline
from tests.test_torch_helpers import (
    TINY_VAE, nchw_to_nhwc, nhwc_to_nchw, port_and_jax, randn, to_torch,
)

H = W = 64
POOLED = 16
TIME_DIM = 4
# tests/test_sdxl_pipeline.py:27-45
SDXL_TINY = dict(
    sample_size=8,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(8, 16, 16),
    transformer_layers_per_block=(1, 1, 2),
    attention_head_dim=2,
    cross_attention_dim=24,
    norm_num_groups=4,
    layers_per_block=2,
    addition_embed_type="text_time",
    addition_time_embed_dim=TIME_DIM,
    projection_class_embeddings_input_dim=POOLED + 6 * TIME_DIM,
)
TEXT1 = dict(vocab_size=1000, hidden_size=8, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=16)
TEXT2 = dict(vocab_size=1000, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=32, projection_dim=POOLED, eos_token_id=999)
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _seeded_jax_params(module, seed, *args, **kwargs):
    """A JAX parameter tree of numpy arrays drawn from a seed, in the
    shapes `module.init` would give (norm scales near one)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        x = 0.1 * rng.standard_normal(leaf.shape)
        return (x + (path[-1].key == "scale")).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def models():
    """{name: (port module, JAX module, JAX params)} on the same weights."""
    x, t, ehs = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 24))
    added = _added(0, b=1)
    ju = JUNet(**SDXL_TINY)
    up = _seeded_jax_params(ju, 0, x, t, ehs, added_cond_kwargs=added)
    unet = to_torch(UNet2DConditionModel(**SDXL_TINY), up)
    bcfg = BrushNetModel.config_from_unet(unet, conditioning_channels=6)
    jb = JBrushNet(**bcfg)
    bp = _seeded_jax_params(jb, 1, x, t, ehs, jnp.zeros((1, 8, 8, 6)), added_cond_kwargs=added)
    j2 = JCLIPProj(**TEXT2)
    t2p = _seeded_jax_params(j2, 4, jnp.zeros((1, 77), jnp.int32))
    vae, vp = port_and_jax(AutoencoderKL, 2, **TINY_VAE)
    text1, t1p = port_and_jax(CLIPTextModel, 3, **TEXT1)
    return {"unet": (unet, ju, up),
            "brushnet": (to_torch(BrushNetModel(**bcfg), bp), jb, bp),
            "vae": (vae, JVAE(**TINY_VAE), vp),
            "text_encoder": (text1, JCLIP(**TEXT1), t1p),
            "text_encoder_2": (to_torch(CLIPTextModelWithProjection(**TEXT2), t2p), j2, t2p)}


def _jax_pipe(models):
    return JPipeline(**{k: (j, p) for k, (_, j, p) in models.items()},
                     tokenizer=JHashTokenizer(vocab_size=1000),
                     tokenizer_2=JHashTokenizer(vocab_size=1000),
                     depth_conditioning_mode="concat")


def _port_pipe(models):
    return StableDiffusionXLBrushNetPipeline(
        **{k: copy.deepcopy(t) for k, (t, _, _) in models.items()},
        tokenizer=HashTokenizer(vocab_size=1000), tokenizer_2=HashTokenizer(vocab_size=1000),
        depth_conditioning_mode="concat", device="cpu")


@pytest.fixture(scope="module")
def pipes(models):
    return _jax_pipe(models), _port_pipe(models)


@pytest.fixture(scope="module")
def jax_images(pipes):
    """JAX's decoded image for each call, computed once."""
    j, _ = pipes
    cache = {}

    def get(name, **kw):
        if name not in cache:
            if name == "deep_cache":
                j.enable_deep_cache(2)
            elif name == "encoder_reuse":
                j.enable_encoder_reuse(2)
            try:
                cache[name] = np.asarray(j(**_jax_kw(kw), output_type="latent"))
            finally:
                j.disable_deep_cache()
                j.disable_encoder_reuse()
        return cache[name]
    return get


def _call_kwargs(steps=2, images=2, scheduler="unipc"):
    rng = np.random.RandomState(0)
    image = rng.rand(H, W, 3).astype(np.float32)
    mask = np.zeros((H, W, 3), np.float32)
    mask[16:48, 16:48] = 1.0
    return dict(prompt="a mirror on the wall", image=image, mask=mask,
                depth=rng.rand(H, W, 1).astype(np.float32), num_inference_steps=steps,
                guidance_scale=5.0, num_images_per_prompt=images,
                latents=randn(7, images, 8, 8, 4), deterministic_vae_encode=True,
                scheduler=scheduler)


def _jax_kw(kw):
    return dict(kw, latents=jnp.asarray(kw["latents"]))


def _uint8(x):
    return np.round(np.clip(x / 2 + 0.5, 0, 1) * 255).astype(int)


def _assert_image_close(got, ref, rtol=RTOL):
    assert got.shape == ref.shape and np.isfinite(got).all()
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rtol * scale, (err, scale)
    assert np.abs(_uint8(got) - _uint8(ref)).max() <= 1


def _added(seed, b=2):
    r = np.random.RandomState(seed)
    return {"text_embeds": r.standard_normal((b, POOLED)).astype(np.float32),
            "time_ids": np.array([[64, 64, 0, 0, 64, 64], [96, 80, 8, 4, 64, 64]][:b],
                                 np.float32)}


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rtol * scale, (err, scale)


def _torch_added(added):
    return {k: torch.from_numpy(v) for k, v in added.items()}


# ------------------------------------------------------------------ models

def test_text_time_forwards_match_jax(models):
    """The UNet and the BrushNet with the text_time term (two samples with
    different pooled embeds and size ids), against JAX."""
    unet, ju, up = models["unet"]
    brushnet, jb, bp = models["brushnet"]
    x, ehs, t = randn(0, 2, 8, 8, 4), randn(1, 2, 77, 24), np.array([10, 500])
    cond, added = randn(2, 2, 8, 8, 6), _added(3)
    # jitted: 6 s less than op by op here
    ref = jax.jit(lambda *a: ju.apply(*a, added_cond_kwargs=added))(up, x, t, ehs)
    with torch.no_grad():
        got = unet(nhwc_to_nchw(x), torch.from_numpy(t), torch.from_numpy(ehs),
                   added_cond_kwargs=_torch_added(added))
        down, mid, upr = brushnet(nhwc_to_nchw(x), torch.from_numpy(t), torch.from_numpy(ehs),
                                  nhwc_to_nchw(cond), added_cond_kwargs=_torch_added(added))
    _close(nchw_to_nhwc(got), ref)
    jdown, jmid, jup = jax.jit(lambda *a: jb.apply(*a, added_cond_kwargs=added))(
        bp, x, t, ehs, cond)
    assert len(down) == len(jdown) and len(upr) == len(jup)
    for g, r in zip(down + [mid] + upr, list(jdown) + [jmid] + list(jup)):
        _close(nchw_to_nhwc(g), r)
    with pytest.raises(ValueError, match="added_cond_kwargs"):
        with torch.no_grad():
            unet(nhwc_to_nchw(x), torch.from_numpy(t), torch.from_numpy(ehs))


def test_hoisted_text_time_term_equals_the_forward(models):
    """The pipeline's per-call table (time embedding row + text_time term,
    one row a sample) gives the forward's output on added_cond_kwargs (to
    1e-5 of the largest value: the time MLP runs at another batch)."""
    unet = models["unet"][0]
    x, ehs, added = randn(0, 2, 8, 8, 4), randn(1, 2, 77, 24), _torch_added(_added(3))
    with torch.no_grad():
        want = unet(nhwc_to_nchw(x), torch.tensor([500, 500]), torch.from_numpy(ehs),
                    added_cond_kwargs=added)
        temb = precompute_time_embeddings(unet, [500]) + text_time_embedding(
            unet, added, torch.float32)
        got = unet(nhwc_to_nchw(x), None, torch.from_numpy(ehs), temb=temb)
    assert temb.shape == (2, 32)
    _close(got.numpy(), want.numpy(), rtol=1e-5)


def test_text_encoders_hidden_states_match_jax(models):
    ids = np.asarray(HashTokenizer(vocab_size=1000)(["a mirror on the wall", ""]))
    text1, j1, p1 = models["text_encoder"]
    text2, j2, p2 = models["text_encoder_2"]
    with torch.no_grad():
        last1, h1 = text1(torch.from_numpy(ids).long(), output_hidden_states=True)
        last2, pooled2, h2 = text2(torch.from_numpy(ids).long(), output_hidden_states=True)
        plain = text1(torch.from_numpy(ids).long())
    rlast1, rh1 = j1.apply(p1, ids, output_hidden_states=True)
    rlast2, rpooled2, rh2 = j2.apply(p2, ids, output_hidden_states=True)
    assert len(h1) == len(rh1) == 3 and len(h2) == len(rh2) == 3
    torch.testing.assert_close(plain, last1, rtol=0, atol=0)
    for g, r in zip([last1, last2, pooled2, *h1, *h2], [rlast1, rlast2, rpooled2, *rh1, *rh2]):
        _close(g.numpy(), r)


def test_dedup_of_the_branch_is_wrong_under_text_time(models, pipes):
    """Under CFG the SDXL branch's halves differ (zero pooled negatives
    against the prompt's), so a half-batch run tiled to both halves gives
    other residuals than the full batch: the pipeline keeps the full batch."""
    brushnet = models["brushnet"][0]
    _, tpipe = pipes
    x, ehs, cond = randn(0, 1, 8, 8, 4), randn(1, 1, 77, 24), randn(2, 1, 8, 8, 6)
    pooled = np.concatenate([np.zeros((1, POOLED), np.float32), randn(3, 1, POOLED)])
    added = {"text_embeds": torch.from_numpy(pooled),
             "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2)}
    half = {k: v[1:] for k, v in added.items()}
    args = (torch.tensor([500]), torch.from_numpy(np.concatenate([ehs, ehs])))
    with torch.no_grad():
        full = brushnet(torch.cat([nhwc_to_nchw(x)] * 2), *args,
                        torch.cat([nhwc_to_nchw(cond)] * 2), added_cond_kwargs=added)
        dedup = brushnet(nhwc_to_nchw(x), args[0], args[1][1:], nhwc_to_nchw(cond),
                         added_cond_kwargs=half)
    _close(full[1][1:].numpy(), dedup[1].numpy(), rtol=1e-5)               # the cond half
    assert (full[1][:1] - dedup[1]).abs().max() > 1e-3                     # the uncond half
    assert not tpipe._brushnet_cfg_dedup(do_cfg=True, guess_mode=False)


# -------------------------------------------------------------------- text

def test_encode_prompt_xl_matches_jax(pipes):
    j, t = pipes
    emb, pooled = t.encode_prompt_xl("a mirror on the wall")
    assert emb.shape == (2, 77, 24) and pooled.shape == (2, POOLED)
    assert torch.count_nonzero(emb[0]) == 0 and torch.count_nonzero(pooled[0]) == 0
    jemb, jpooled = j.encode_prompt_xl("a mirror on the wall")
    _close(emb.numpy(), jemb)
    _close(pooled.numpy(), jpooled)

    emb, pooled = t.encode_prompt_xl(["a mirror", "a wall"], negative_prompt="blurry")
    jemb, jpooled = j.encode_prompt_xl(["a mirror", "a wall"], negative_prompt="blurry")
    assert emb.shape == (4, 77, 24) and torch.count_nonzero(pooled[:2]) > 0
    _close(emb.numpy(), jemb)
    _close(pooled.numpy(), jpooled)
    emb, pooled = t.encode_prompt_xl("a mirror", do_classifier_free_guidance=False)
    assert emb.shape == (1, 77, 24) and pooled.shape == (1, POOLED)


# ---------------------------------------------------------------- pipeline

@pytest.mark.parametrize("scheduler", ["unipc", "ddim"])
def test_pipeline_matches_jax(pipes, jax_images, scheduler):
    """Two images a prompt (repeated inside each CFG half), 2 steps."""
    _, t = pipes
    kw = _call_kwargs(scheduler=scheduler)
    got = t(**kw, output_type="latent")
    assert got.shape == (2, H, W, 3)
    _assert_image_close(got, jax_images(scheduler, **kw))
    assert not np.array_equal(got[0], got[1])
    u8 = t(**kw)
    assert u8.dtype == np.uint8 and np.array_equal(u8, _uint8(got))


def test_data_parallel_matches_jax(pipes, jax_images):
    """Two CPU replicas, one image each (the CFG halves of the prompt embeds,
    the pooled embeds and the size ids split alike)."""
    _, t = pipes
    kw = _call_kwargs()
    t.enable_data_parallel(make_mesh(devices=["cpu", "cpu"]))
    try:
        got = t(**kw, output_type="latent")
    finally:
        t.disable_data_parallel()
    _assert_image_close(got, jax_images("unipc", **kw))


@pytest.mark.parametrize("mode", ["deep_cache", "encoder_reuse"])
def test_cached_modes_match_jax(pipes, jax_images, mode):
    """Interval 2 over 3 steps (full, cached, full): against JAX's, and
    different from the exact path."""
    _, t = pipes
    kw = _call_kwargs(steps=3, images=1)
    getattr(t, f"enable_{mode}")(2)
    try:
        got = t(**kw, output_type="latent")
    finally:
        t.disable_deep_cache()
        t.disable_encoder_reuse()
    _assert_image_close(got, jax_images(mode, **kw))
    assert np.abs(got - t(**kw, output_type="latent")).max() > 1e-4


def test_refusals(pipes):
    _, t = pipes
    kw = _call_kwargs(images=1)
    with pytest.raises(ValueError, match="guess_mode"):
        t(**kw, guess_mode=True)
    t.enable_deep_cache(2)
    t.enable_encoder_reuse(2)
    try:
        with pytest.raises(ValueError, match="mutually exclusive"):
            t(**kw)
    finally:
        t.disable_deep_cache()
        t.disable_encoder_reuse()


def test_int8_pipeline_matches_jax(models, pipes):
    """Every UNet and BrushNet kernel in int8 but the time and text_time
    MLPs, on both sides (fresh pipelines: int8 is one-way; the JAX one a
    shallow copy of the module's, which keeps its compiled text encoders
    and VAE encode)."""
    j = copy.copy(pipes[0])
    j._jit_cache = {}
    t = _port_pipe(models)
    n = t.enable_int8(select=quant.select_all)
    with pytest.MonkeyPatch.context() as mp:
        # the same function compiled once a shape: faster than op by op
        mp.setattr(jquant, "quantize_kernel", jax.jit(jquant.quantize_kernel))
        j.enable_int8(select=lambda k: hasattr(k, "ndim") and k.ndim in (2, 4))
    for m in (t.unet, t.brushnet):
        assert isinstance(m.add_embedding.linear_1, torch.nn.Linear)
        assert isinstance(m.time_embedding.linear_2, torch.nn.Linear)
    assert n > 0
    kw = _call_kwargs(images=1)
    got = t(**kw, output_type="latent")
    _assert_image_close(got, np.asarray(j(**_jax_kw(kw), output_type="latent")), rtol=1e-3)


def test_to_moves_the_second_text_encoder(models):
    t = _port_pipe(models)
    t.encode_prompt_xl("a mirror")
    assert t._prompt_cache
    assert t.to("cpu") is t and not t._prompt_cache
    assert next(t.text_encoder_2.parameters()).device.type == "cpu"
