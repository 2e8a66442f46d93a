"""PyTorch port vs the JAX package, op by op, on the CPU in fp32.

Tolerances: fp32 on both sides; the two frameworks sum in different orders
(convolution algorithms, reductions), which moves results by a few ulps per
layer, so single ops are held at rtol/atol 1e-5 and blocks of several layers
at 1e-4.  Attention is held at the flash-kernel parity tolerance of
tests/test_flash_attention.py, rtol/atol 2e-5, and its gradients at the
flash VJP tolerance of tests/test_flash_attention.py:49, rtol/atol 1e-4.
The GroupNorm gradients (closed form against jax.vjp of the jnp norm) are
held at rtol/atol 1e-5 of the forward: one fp32 pass of group sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reflecting_reality_tpu.ops import attention as j_attn
from reflecting_reality_tpu.ops import embeddings as j_emb
from reflecting_reality_tpu.ops import resnet as j_resnet
from reflecting_reality_tpu.ops import transformer as j_tr
from reflecting_reality_tpu.ops.norms import group_norm as j_group_norm
from reflecting_reality_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from reflecting_reality_tpu_torch.ops import attention as t_attn
from reflecting_reality_tpu_torch.ops import embeddings as t_emb
from reflecting_reality_tpu_torch.ops import resnet as t_resnet
from reflecting_reality_tpu_torch.ops import transformer as t_tr
from reflecting_reality_tpu_torch.ops.kernels.flash_attention import (
    attention_plain,
    flash_attention,
    flash_attention_bwd_plain,
)
from reflecting_reality_tpu_torch.ops.kernels.groupnorm import (
    group_norm_bwd_plain,
    group_norm_plain,
)
from reflecting_reality_tpu_torch.ops.norms import group_norm
from tests.test_torch_helpers import init_jax, nchw_to_nhwc, nhwc_to_nchw, randn, to_torch
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

OP_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
VJP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("apply_silu", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 4), ((1, 5, 7, 12), 3)])
def test_group_norm_matches_jax(shape, groups, apply_silu):
    x = randn(0, *shape) * 3.0 + 1.5
    c = shape[-1]
    w, b = randn(1, c), randn(2, c)
    ref = j_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups, 1e-5,
                       apply_silu=apply_silu)
    got = group_norm(nhwc_to_nchw(x), torch.from_numpy(w), torch.from_numpy(b), groups, 1e-5,
                     apply_silu=apply_silu)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(ref), **OP_TOL)


@pytest.mark.parametrize("b,t,h,d", [(2, 256, 2, 40), (1, 512, 1, 80), (1, 600, 2, 40)])
def test_attention_matches_jax_flash(b, t, h, d):
    """The port's attention (the CPU plain path, through both the dispatcher
    and the kernel wrapper) against the JAX Pallas flash kernel in TPU
    interpret mode; T=600 is not a power of two."""
    q, k, v = (randn(s, b, t, h, d) for s in (0, 1, 2))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 block_q=128, block_k=128))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(flash_attention(tq, tk, tv).numpy(), ref, **ATTN_TOL)
    np.testing.assert_allclose(t_attn.dot_product_attention(tq, tk, tv).numpy(), ref, **ATTN_TOL)


@pytest.mark.parametrize("b,t,h,d", [(1, 256, 2, 40), (1, 264, 2, 40)])
def test_flash_backward_matches_jax_vjp(b, t, h, d):
    """`flash_attention_bwd_plain` (the plain version of kernels B3 + B4) and
    torch autograd of the plain attention, both against the VJP of the JAX
    Pallas flash kernel in TPU interpret mode; T=264 is ragged for 64-row tiles."""
    q, k, v, do = (randn(s, b, t, h, d) for s in (0, 1, 2, 3))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: j_flash(*a, block_q=128, block_k=128),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = attention_plain(tq, tk, tv, return_lse=True)
    for got, want in zip(flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo), ref):
        np.testing.assert_allclose(got.numpy(), want, **VJP_TOL)

    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    t_attn.dot_product_attention(*leaves).backward(tdo)
    for leaf, want in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), want, **VJP_TOL)


@pytest.mark.parametrize("apply_silu", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 4), ((1, 5, 7, 12), 3)])
def test_group_norm_backward_matches_jax_vjp(shape, groups, apply_silu):
    """The closed-form backward (the one kernel B2's autograd Function runs)
    and torch autograd of the plain norm against jax.vjp of the jnp norm."""
    x = randn(0, *shape) * 3.0 + 1.5
    c = shape[-1]
    w, b, dy = randn(1, c), randn(2, c), randn(3, *shape)
    _, vjp = jax.vjp(lambda x_, w_, b_: j_group_norm(x_, w_, b_, groups, 1e-5,
                                                     apply_silu=apply_silu),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    rdx, rdw, rdb = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    tx, tw, tb = nhwc_to_nchw(x), torch.from_numpy(w), torch.from_numpy(b)
    dx, dw, db = group_norm_bwd_plain(tx, tw, tb, nhwc_to_nchw(dy), groups, 1e-5, apply_silu)
    np.testing.assert_allclose(nchw_to_nhwc(dx), rdx, **OP_TOL)
    np.testing.assert_allclose(dw.numpy(), rdw, **OP_TOL)
    np.testing.assert_allclose(db.numpy(), rdb, **OP_TOL)

    leaves = [t.clone().requires_grad_(True) for t in (tx, tw, tb)]
    group_norm_plain(*leaves, groups, 1e-5, apply_silu).backward(nhwc_to_nchw(dy))
    for leaf, want in zip(leaves, (rdx, rdw, rdb)):
        got = leaf.grad if leaf.dim() == 1 else torch.from_numpy(nchw_to_nhwc(leaf.grad))
        np.testing.assert_allclose(got.numpy(), want, **OP_TOL)


@pytest.mark.parametrize("q_shape,tk,flash", [
    ((1, 4096, 1, 40), 4096, True),       # SD-1.5's 4096-token self-attention
    ((2, 4096, 10, 64), 4096, True),      # SDXL's
    ((2, 1024, 20, 64), 1024, True),      # SDXL's 1024-token self-attention
    ((2, 1024, 8, 80), 1024, True),       # SD-1.5's levels 1-3
    ((2, 256, 8, 160), 256, True),
    ((2, 64, 8, 160), 64, True),
    ((2, 4096, 8, 40), 77, True),         # cross-attention to 77 text tokens
    ((2, 4096, 10, 64), 77, True),
    ((2, 1024, 20, 64), 77, True),
    ((2, 64, 8, 160), 77, True),
    ((1, 301, 2, 64), 517, True),         # any Tq != Tk
    ((2, 4096, 8, 40), 81, True),         # IP-Adapter's extra tokens beside the text
    ((2, 4096, 8, 40), 0, False),         # no keys: no tensor map to read them
    ((1, 1024, 1, 168), 1024, False),     # head dims no instance takes
    ((1, 4096, 1, 100), 77, False),
    ((1, 4096, 1, 512), 4096, False),     # the VAE's one 512-wide head
])
def test_flash_routing_rule(q_shape, tk, flash):
    """One rule by shape: the kernels take every query and key length
    (self- and cross-attention alike) at the head dims they have instances
    for.  Shapes only: meta tensors."""
    q = torch.empty(q_shape, device="meta")
    k = torch.empty(q_shape[:1] + (tk,) + q_shape[2:], device="meta")
    assert t_attn.routes_to_flash(q, k) is flash


def _attention_calls(monkeypatch, run):
    """run() on the meta device -> the (q, k) shapes of each attention call."""
    from reflecting_reality_tpu_torch.ops import norms
    from reflecting_reality_tpu_torch.ops.kernels.groupnorm import group_norm_plain

    seen = []

    def record(q, k, v, backend=None):
        seen.append((q, k))
        return attention_plain(q, k, v)

    monkeypatch.setattr(t_attn, "dot_product_attention", record)
    monkeypatch.setattr(norms, "group_norm_silu", group_norm_plain)
    with torch.device("meta"), torch.no_grad():
        run()
    return seen


@pytest.mark.parametrize("config,px,attentions", [("sd15-mirrorfusion", 512, 32),
                                                  ("sdxl-brushnet", 1024, 140)])
def test_every_unet_attention_routes_to_flash(monkeypatch, config, px, attentions):
    """Every attention of a UNet forward at the benchmark's configuration
    (SD-1.5 at 512²: 16 transformer blocks of a self- and a cross-attention;
    SDXL at 1024²: 70) routes to the kernels, and the VAE's does not."""
    import json
    import os

    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "bench_h100", "configs", f"{config}.json")) as f:
        cfg = json.load(f)

    def unet_forward():
        unet = UNet2DConditionModel(**cfg["unet"])
        side = px // 8
        unet(torch.empty(2, 4, side, side), None,
             torch.empty(2, 77, cfg["unet"]["cross_attention_dim"]),
             temb=torch.empty(2, unet.time_embedding.linear_2.out_features))

    calls = _attention_calls(monkeypatch, unet_forward)
    assert len(calls) == attentions
    assert all(t_attn.routes_to_flash(q, k) for q, k in calls)
    assert sum(k.shape[1] == 77 for _, k in calls) == attentions // 2

    def vae_decode():
        AutoencoderKL(**cfg["vae"]).decode(torch.empty(1, 4, px // 8, px // 8))

    calls = _attention_calls(monkeypatch, vae_decode)
    assert calls and not any(t_attn.routes_to_flash(q, k) for q, k in calls)


@pytest.mark.parametrize("d,flash", [(40, True), (160, True), (161, False), (168, False),
                                     (256, False), (100, False)])
def test_flash_routing_takes_only_the_kernels_head_dims(d, flash):
    """The route sends to the kernels only the head dims they take (D % 8
    == 0, D <= 160); D = 161-256 pass JAX's rule (D <= 256) and would raise
    in the kernels' wrappers, so they take the plain path.  Shapes only:
    meta tensors."""
    q = torch.empty(1, 4096, 1, d, device="meta")
    assert t_attn.routes_to_flash(q, q) is flash


def test_plain_attention_past_the_kernels_head_dims_matches_jax():
    """At D = 192 (routed to the plain path) the port's attention equals
    JAX's dot_product_attention (its einsum path) at the flash tolerance."""
    q, k, v = (randn(s, 1, 2048, 1, 192) for s in (0, 1, 2))
    ref = np.asarray(j_attn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                  backend="xla"))
    got = t_attn.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, **ATTN_TOL)


def test_timestep_embedding_and_mlp():
    ts = np.array([0, 1, 250, 999], np.int32)
    ref = j_emb.get_timestep_embedding(jnp.asarray(ts), 32)
    got = t_emb.get_timestep_embedding(torch.from_numpy(ts), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OP_TOL)

    jm = j_emb.TimestepEmbedding(64)
    p = init_jax(jm, jnp.zeros((1, 32)))
    tm = to_torch(t_emb.TimestepEmbedding(32, 64), p)
    x = randn(3, 4, 32)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(p, jnp.asarray(x))), **OP_TOL)


@pytest.mark.parametrize("cin,cout", [(8, 8), (8, 16)])
def test_resnet_block(cin, cout):
    jm = j_resnet.ResnetBlock2D(in_channels=cin, out_channels=cout, groups=4)
    x, temb = randn(0, 2, 6, 6, cin), randn(1, 2, 24)
    p = init_jax(jm, jnp.asarray(x), jnp.asarray(temb))
    tm = to_torch(t_resnet.ResnetBlock2D(cin, cout, groups=4, temb_channels=24), p)
    ref = jm.apply(p, jnp.asarray(x), jnp.asarray(temb))
    got = tm(nhwc_to_nchw(x), torch.from_numpy(temb))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(ref), **BLOCK_TOL)


@pytest.mark.parametrize("padding", [1, 0])
def test_downsample(padding):
    jm = j_resnet.Downsample2D(8, padding=padding)
    x = randn(0, 2, 7, 6, 8)
    p = init_jax(jm, jnp.asarray(x))
    tm = to_torch(t_resnet.Downsample2D(8, padding=padding), p)
    np.testing.assert_allclose(nchw_to_nhwc(tm(nhwc_to_nchw(x))),
                               np.asarray(jm.apply(p, jnp.asarray(x))), **OP_TOL)


@pytest.mark.parametrize("output_size", [None, (5, 7), (6, 8)])
def test_upsample(output_size):
    jm = j_resnet.Upsample2D(8)
    x = randn(0, 1, 3, 4, 8)
    p = init_jax(jm, jnp.asarray(x))
    tm = to_torch(t_resnet.Upsample2D(8), p)
    ref = jm.apply(p, jnp.asarray(x), output_size=output_size)
    got = tm(nhwc_to_nchw(x), output_size=output_size)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(ref), **OP_TOL)


@pytest.mark.parametrize("kind", ["self", "cross", "vae"])
def test_attention_module(kind):
    if kind == "vae":
        kw = dict(query_dim=16, heads=1, dim_head=16, norm_num_groups=4,
                  residual_connection=True, qkv_bias=True)
        x, ctx = randn(0, 2, 4, 5, 16), None
        tx = nhwc_to_nchw(x)
    else:
        kw = dict(query_dim=16, heads=2, dim_head=8,
                  cross_attention_dim=12 if kind == "cross" else None)
        x = randn(0, 2, 20, 16)
        ctx = randn(1, 2, 7, 12) if kind == "cross" else None
        tx = torch.from_numpy(x)
    jm = j_attn.Attention(**kw)
    jargs = (jnp.asarray(x),) if ctx is None else (jnp.asarray(x), jnp.asarray(ctx))
    p = init_jax(jm, *jargs)
    tm = to_torch(t_attn.Attention(**kw), p)
    ref = np.asarray(jm.apply(p, *jargs))
    got = tm(tx, None if ctx is None else torch.from_numpy(ctx))
    got = nchw_to_nhwc(got) if kind == "vae" else got.detach().numpy()
    np.testing.assert_allclose(got, ref, **BLOCK_TOL)


@pytest.mark.parametrize("linear", [False, True])
def test_transformer2d(linear):
    kw = dict(in_channels=16, num_attention_heads=2, attention_head_dim=8,
              cross_attention_dim=12, norm_num_groups=4, use_linear_projection=linear)
    jm = j_tr.Transformer2DModel(**kw)
    x, ctx = randn(0, 2, 4, 4, 16), randn(1, 2, 7, 12)
    p = init_jax(jm, jnp.asarray(x), jnp.asarray(ctx))
    tm = to_torch(t_tr.Transformer2DModel(**kw), p)
    ref = jm.apply(p, jnp.asarray(x), jnp.asarray(ctx))
    got = tm(nhwc_to_nchw(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(ref), **BLOCK_TOL)
