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

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from reflecting_reality_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from reflecting_reality_tpu.models.brushnet import BrushNetModel as JBrushNet
from reflecting_reality_tpu.models.clip_text import CLIPTextModel as JCLIP
from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel as JUNet
from reflecting_reality_tpu.models.vae import AutoencoderKL as JVAE
from reflecting_reality_tpu.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline as JPipeline,
)
from reflecting_reality_tpu_torch.core import tracing
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.parallel.mesh import make_mesh
from reflecting_reality_tpu_torch.pipelines import cuda_graphs
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from tests.test_torch_helpers import (
    TINY, TINY_TEXT, TINY_VAE, init_jax, randn, to_torch, unet_route_counts,
)
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


def test_stats_count_the_unet_attentions_by_route(pipes):
    """On the CPU every attention takes the plain path: a call adds each of
    the UNet's attention modules once a denoise step, all of them "plain"."""
    _, tpipe = pipes
    counts, modules, routes = unet_route_counts(
        tpipe, lambda: tpipe(**_call_kwargs(), output_type="latent"))
    assert counts == (1, STEPS) and modules > 0
    assert routes == {"flash": 0, "plain": modules * STEPS}


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


# ------------------------------------------------------------ CUDA graphs


class _FakeGraph:
    """A CPU stand-in for a captured graph: a replay recomputes the forward
    from the static inputs and writes the static outputs in place, as a
    replay overwrites them on the card, so an output kept past its step
    would change under the caller."""

    def __init__(self, fn, args, kwargs, outputs):
        self.fn, self.args, self.kwargs, self.outputs = fn, args, kwargs, outputs

    def replay(self):
        new = self.fn(*self.args, **self.kwargs)
        for old, fresh in zip(pytree.tree_leaves(self.outputs), pytree.tree_leaves(new)):
            old.copy_(fresh)


@pytest.fixture
def emulated_graphs(monkeypatch):
    """The graphed path on the CPU: a CPU replica passes for a card's in the
    pipeline's choice, and a capture records a `_FakeGraph`."""
    graphed = StableDiffusionBrushNetPipeline._graphed
    monkeypatch.setattr(
        StableDiffusionBrushNetPipeline, "_graphed",
        lambda self, rep, interval: graphed(self, rep._replace(device=torch.device("cuda")),
                                            interval))
    monkeypatch.setattr(cuda_graphs, "_warm_up", lambda fn, args, kwargs: fn(*args, **kwargs))

    def record(fn, args, kwargs, owner):
        out = fn(*args, **kwargs)
        return _FakeGraph(fn, args, kwargs, out), out

    monkeypatch.setattr(cuda_graphs, "_record", record)


@pytest.fixture
def graph_pipe(pipes):
    """A copy of the tiny pipeline (so that modes and graphs stay off the
    shared one), with its eager output of `_call_kwargs()`."""
    pipe = copy.deepcopy(pipes[1])
    return pipe, pipe(**_call_kwargs(), output_type="latent")


def test_cuda_graphs_on_the_cpu_leave_every_step_eager(graph_pipe):
    pipe, eager = graph_pipe
    pipe.enable_cuda_graphs()
    tracing.enable()
    try:
        got = pipe(**_call_kwargs(), output_type="latent")
    finally:
        tracing.disable()
        spans = tracing.take()["spans"]
    np.testing.assert_array_equal(got, eager)
    assert pipe.graph_stats() == {"captures": 0, "replays": 0, "eager_steps": STEPS}
    assert [s["attrs"]["graph"] for s in spans
            if s["name"] in ("rr.unet", "rr.brushnet")] == ["eager"] * (2 * STEPS)
    pipe.disable_cuda_graphs()
    assert "forward" not in vars(pipe.unet) and "forward" not in vars(pipe.brushnet)
    assert pipe.graph_stats() == {"captures": 0, "replays": 0, "eager_steps": 0}


@pytest.mark.parametrize("variant, keys", [
    ({}, 1),                                            # CFG, BrushNet deduplicated
    (dict(guess_mode=True), 1),                         # BrushNet on the cond half
    (dict(guidance_scale=1.0, scheduler="ddim"), 1),    # no CFG: outputs used as they are
    (dict(control_guidance_start=0.34, brushnet_conditioning_scale=0.7), 2),  # scales 0, 0, 0.7
])
def test_emulated_graphs_equal_the_eager_steps(graph_pipe, emulated_graphs, variant, keys):
    """Captured once a key, replayed at every step, equal to the eager
    call; a second call of the same shape captures nothing new."""
    pipe, _ = graph_pipe
    kw = dict(_call_kwargs(), **variant)
    eager = pipe(**kw, output_type="latent")
    pipe.enable_cuda_graphs()
    tracing.enable()
    try:
        got = pipe(**kw, output_type="latent")
    finally:
        tracing.disable()
        spans = tracing.take()["spans"]
    np.testing.assert_array_equal(got, eager)
    assert pipe.graph_stats() == {"captures": 2 * keys, "replays": 2 * STEPS, "eager_steps": 0}
    modes = [s["attrs"]["graph"] for s in spans if s["name"] == "rr.unet"]
    assert modes.count("capture") == keys and modes.count("replay") == STEPS - keys
    np.testing.assert_array_equal(pipe(**kw, output_type="latent"), eager)
    assert pipe.graph_stats() == {"captures": 2 * keys, "replays": 4 * STEPS, "eager_steps": 0}


def test_emulated_graphs_per_batch_size_and_a_mismatch_raises(graph_pipe, emulated_graphs):
    pipe, _ = graph_pipe
    pipe.enable_cuda_graphs()
    kw = _call_kwargs()
    two = dict(kw, prompt=["a mirror", "a hall mirror"],
               latents=np.concatenate([kw["latents"], randn(8, 1, 8, 8, 4)]))
    solo = pipe(**dict(kw, prompt="a mirror"), output_type="latent")
    both = pipe(**two, output_type="latent")
    assert pipe.graph_stats()["captures"] == 4
    pipe.disable_cuda_graphs()
    np.testing.assert_array_equal(both, pipe(**two, output_type="latent"))
    np.testing.assert_array_equal(solo, pipe(**dict(kw, prompt="a mirror"), output_type="latent"))
    # a key that does not fix the shapes it was captured at is a fault
    pipe.enable_cuda_graphs()
    x = torch.zeros(2, 4, 8, 8)
    ehs, temb = torch.zeros(2, 77, 32), torch.zeros(1, 32)
    with torch.inference_mode():
        pipe.unet(x, None, ehs, temb=temb, graph_key="k")
        with pytest.raises(ValueError, match="captured for other arguments"):
            pipe.unet(x[:1], None, ehs[:1], temb=temb, graph_key="k")


def _int8(pipe):
    from reflecting_reality_tpu_torch.ops.quant import select_all

    pipe.enable_int8(select=select_all)


@pytest.mark.parametrize("mode", [
    lambda p: p.enable_deep_cache(2),
    lambda p: p.enable_encoder_reuse(2),
    _int8,
    lambda p: p.enable_data_parallel(make_mesh(devices=("cpu",))),
], ids=["deep_cache", "encoder_reuse", "int8", "data_parallel"])
def test_approximate_and_parallel_modes_count_eager_steps(graph_pipe, emulated_graphs, mode):
    pipe, _ = graph_pipe
    mode(pipe)
    pipe.enable_cuda_graphs()
    pipe(**_call_kwargs(), output_type="latent")
    assert pipe.graph_stats() == {"captures": 0, "replays": 0, "eager_steps": STEPS}


def test_graphs_of_many_resolutions_stay_within_the_cap(graph_pipe, emulated_graphs):
    """Past `max_keys` a new key drops the least recently used key's graphs:
    four calls at three resolutions keep the graphs of two keys at most, and
    the dropped resolution, met again, is captured anew and still exact."""
    pipe, eager = graph_pipe
    pipe.enable_cuda_graphs(max_keys=2)
    for k, px in enumerate((H, 96, 128, H)):
        kw = _call_kwargs()
        if px != H:
            rng = np.random.RandomState(k)
            kw.update(image=rng.rand(px, px, 3).astype(np.float32),
                      mask=np.pad(kw["mask"], ((0, px - H), (0, px - H), (0, 0))),
                      depth=rng.rand(px, px, 1).astype(np.float32),
                      latents=randn(20 + k, 1, px // 8, px // 8, 4))
        got = pipe(**kw, output_type="latent")
        assert got.shape == (1, px, px, 3)
        held = [len(m.forward.graphs) for m in (pipe.unet, pipe.brushnet)]
        assert held == [min(k + 1, 2)] * 2 and len(pipe._graphs.keys) == min(k + 1, 2)
    np.testing.assert_array_equal(got, eager)
    assert pipe.graph_stats() == {"captures": 8, "replays": 2 * 4 * STEPS, "eager_steps": 0}
    assert [key[1] for key in pipe._graphs.keys] == [(16, 16), (8, 8)]


def test_int8_after_a_capture_runs_eager(graph_pipe, emulated_graphs):
    """The graphs hold the float weights: once int8 is on, the steps run
    eagerly, and no captured graph is replayed."""
    pipe, _ = graph_pipe
    pipe.enable_cuda_graphs()
    pipe(**_call_kwargs(), output_type="latent")
    _int8(pipe)
    pipe(**_call_kwargs(), output_type="latent")
    assert pipe.graph_stats() == {"captures": 2, "replays": 2 * STEPS, "eager_steps": STEPS}


def test_graphed_modules_copy_without_their_graphs(graph_pipe, emulated_graphs):
    """A copied module (a data-parallel replica) runs its own weights,
    through a graphed forward of its own that holds no graph."""
    pipe, _ = graph_pipe
    pipe.enable_cuda_graphs()
    pipe(**_call_kwargs(), output_type="latent")
    unet = copy.deepcopy(pipe.unet)
    assert unet.forward.module is unet and unet.forward.graphs == {}
    assert pipe.unet.forward.graphs
    with torch.no_grad():
        for p in unet.parameters():
            p.zero_()
    x, ehs = torch.ones(2, 4, 8, 8), torch.ones(2, 77, 32)
    with torch.inference_mode():
        assert not unet(x, None, ehs, temb=torch.ones(1, 32)).abs().max() > 0
        assert pipe.unet(x, None, ehs, temb=torch.ones(1, 32)).abs().max() > 0


@pytest.mark.parametrize("field", ["rows", "hw", "embeds", "dtype", "do_cfg", "guess_mode",
                                   "dedup", "cond_scale"])
def test_step_key_tells_apart_what_fixes_a_graph(field):
    base = dict(rows=2, latent_hw=(64, 64), embeds_shape=(2, 77, 768), dtype=torch.bfloat16,
                do_cfg=True, guess_mode=False, dedup=True, cond_scale=1.0)
    other = dict(rows=dict(rows=4), hw=dict(latent_hw=(128, 128)),
                 embeds=dict(embeds_shape=(2, 78, 768)), dtype=dict(dtype=torch.float32),
                 do_cfg=dict(do_cfg=False), guess_mode=dict(guess_mode=True),
                 dedup=dict(dedup=False), cond_scale=dict(cond_scale=0.0))[field]
    key = cuda_graphs.step_key(**base)
    assert key == cuda_graphs.step_key(**dict(base, latent_hw=torch.Size([64, 64]),
                                              embeds_shape=torch.Size([2, 77, 768])))
    assert hash(key) == hash(cuda_graphs.step_key(**base))
    assert cuda_graphs.step_key(**dict(base, **other)) != key
