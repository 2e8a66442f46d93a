"""The memory planner (`reflecting_reality_tpu_torch/tools/aot_memory.py`) on
the CPU.

- Its argument bytes equal the byte sum of the JAX planner's `init_state`
  tree for the same recipe at the dry-run widths (`jax.eval_shape`, as JAX
  `tools/aot_memory.py:99-130` builds it; nothing is compiled) plus JAX's
  batch, with EMA off, fp32 and bf16 and with `--train_base_unet`.  The
  only difference allowed is that each side's 0-d counters are left out:
  torch AdamW's per-tensor `step` scalars (counted exactly: 4 bytes for each
  trainable tensor) and JAX's step and optax counts.
- The gradient all-reduce's buckets come from `multihost._buckets`.
- The byte counter itself on a program whose peak is known.
- The kernel wrappers give fake CUDA tensors outputs of the right shape and
  dtype, without a launch or a count (the planner's gpu platform runs them
  so; no card is needed for that).
- The gpu platform raises without CUDA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from reflecting_reality_tpu_torch.tools import aot_memory
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

RES = 64
BATCH = 2
RECIPES = {
    "no_ema": dict(use_ema=False),
    "ema_fp32": dict(use_ema=True, ema_dtype="fp32"),
    "ema_bf16_train_base_unet": dict(use_ema=True, ema_dtype="bf16", train_base_unet=True),
}


@pytest.fixture(scope="module")
def jax_shapes():
    """The tiny JAX modules and their parameter shapes (eval_shape, JAX
    aot_memory.py:57-64, 88-103)."""
    from reflecting_reality_tpu.models.brushnet import BrushNetModel
    from reflecting_reality_tpu.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu.models.vae import AutoencoderKL

    cfg = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
               cross_attention_dim=768, norm_num_groups=4, layers_per_block=2)
    dt = jnp.bfloat16
    unet = UNet2DConditionModel(dtype=dt, **cfg)
    brushnet = BrushNetModel(conditioning_channels=6, dtype=dt, **cfg)
    vae = AutoencoderKL(block_out_channels=(4, 4, 4, 4), norm_num_groups=2, dtype=dt)
    text = CLIPTextModel(hidden_size=768, num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=32, dtype=dt)
    rng = jax.random.PRNGKey(0)
    lat = jnp.zeros((1, RES // 8, RES // 8, 4), dt)
    t0, ehs = jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 768), dt)
    sds = dict(
        unet=jax.eval_shape(lambda r: unet.init(r, lat, t0, ehs), rng),
        brushnet=jax.eval_shape(lambda r: brushnet.init(
            r, lat, t0, ehs, jnp.zeros((1, RES // 8, RES // 8, 6), dt)), rng),
        vae=jax.eval_shape(lambda r: vae.init(r, jnp.zeros((1, 64, 64, 3), dt),
                                              jax.random.PRNGKey(1)), rng),
        text=jax.eval_shape(lambda r: text.init(r, jnp.zeros((1, 77), jnp.int32)), rng))
    return (unet, brushnet, vae, text), sds


def _jax_argument_bytes(jax_shapes, use_ema, ema_dtype="fp32", train_base_unet=False):
    """Bytes of JAX's state tree (0-d leaves left out) and batch."""
    from reflecting_reality_tpu.training.train_step import TrainConfig, make_train_step

    (unet, brushnet, vae, text), sds = jax_shapes
    config = TrainConfig(train_base_unet=train_base_unet, use_ema=use_ema, ema_dtype=ema_dtype,
                         gradient_checkpointing=True, gradient_checkpointing_policy="dots",
                         snr_gamma=None, depth_conditioning_mode="concat")
    _, init_state = make_train_step(unet, brushnet, vae, text, config)

    def as_dtype(sd, dt):
        return jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(
            s.shape, dt if jnp.issubdtype(s.dtype, jnp.floating) else s.dtype), sd)

    u_dt = jnp.float32 if train_base_unet else jnp.bfloat16
    state = jax.eval_shape(init_state, as_dtype(sds["brushnet"], jnp.float32),
                           as_dtype(sds["unet"], u_dt), as_dtype(sds["vae"], jnp.bfloat16),
                           as_dtype(sds["text"], jnp.bfloat16))
    leaves = jax.tree_util.tree_leaves(state)
    state_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in leaves if x.shape)
    batch_bytes = BATCH * RES * RES * (3 + 3 + 1 + 1) * 4 + BATCH * 77 * 4
    return state_bytes + batch_bytes


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_arguments_equal_jax_state_and_batch(jax_shapes, recipe):
    kw = RECIPES[recipe]
    stats = aot_memory.analyze(n_devices=8, batch_per_chip=BATCH, resolution=RES, tiny=True,
                               platform="cpu", **kw)
    b = stats["bytes"]
    n_trainable = sum(1 for _ in _trainable_shapes(jax_shapes, kw.get("train_base_unet")))
    assert b["adamw_step_scalars"] == 4 * n_trainable
    assert b["argument"] - b["adamw_step_scalars"] == _jax_argument_bytes(jax_shapes, **kw)
    assert b["ema"] == (0 if not kw["use_ema"] else b["trainable_parameters"] // (
        2 if kw["ema_dtype"] == "bf16" else 1))
    assert b["adamw_state"] == 2 * b["trainable_parameters"] + b["adamw_step_scalars"]
    # one bucket holds every tiny gradient and the loss
    assert b["allreduce"] == b["trainable_parameters"] + 4
    assert b["temp"] > 0 and b["peak"] == b["argument"] + b["temp"] + b["allreduce"]
    assert stats["fits"] and stats["output_gib_per_device"] == stats["alias_gib_per_device"] == 0


def _trainable_shapes(jax_shapes, train_base_unet):
    _, sds = jax_shapes
    for name in ("brushnet", "unet") if train_base_unet else ("brushnet",):
        yield from jax.tree_util.tree_leaves(sds[name])


def test_allreduce_buckets_follow_the_bucketing():
    """Two buckets of BUCKET_ELEMENTS fp32 and a smaller third: the largest
    pair alive at once is the first two."""
    from reflecting_reality_tpu_torch.parallel.multihost import BUCKET_ELEMENTS

    with torch.device("meta"):
        params = [torch.empty(BUCKET_ELEMENTS), torch.empty(BUCKET_ELEMENTS), torch.empty(10)]
    assert aot_memory.allreduce_bytes(params, 1) == 0
    assert aot_memory.allreduce_bytes(params, 2) == 8 * BUCKET_ELEMENTS


def test_live_bytes_peak():
    """x (4 MB) and y = 2x alive together, then y freed and z = x + 1 made:
    the peak is 8 MB, the live bytes at the end 8 MB, cuda blocks of 512."""
    with FakeTensorMode():
        live = aot_memory.LiveBytes(torch.device("cpu"))
        x = torch.empty(1 << 20)
        live.add([x])
        with live:
            y = x * 2
            del y
            z = x + 1
            w = z[:10]                    # a view: no new storage
        assert (live.live, live.peak) == (8 << 20, 8 << 20)
        del z, w
        assert live.live == 4 << 20
    assert aot_memory._block(1, torch.device("cuda")) == 512
    assert aot_memory._block(513, torch.device("cuda")) == 1024
    assert aot_memory._block(513, torch.device("cpu")) == 513


def test_kernel_wrappers_take_fake_tensors_without_a_launch():
    from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
    from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                gn.group_norm_silu_fwd)
    before = [w.launches for w in wrappers]
    with FakeTensorMode():
        q, k, v, do = (torch.empty((2, 4096, 8, 40), dtype=torch.bfloat16, device="cuda")
                       for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v)
        assert (out.shape, out.dtype, lse.shape, lse.dtype, out.device.type) == (
            q.shape, q.dtype, (16, 4096), torch.float32, "cuda")
        delta = torch.empty((16, 4096), device="cuda")
        assert fa.flash_attention_bwd_dq(q, k, v, do, lse, delta).shape == q.shape
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        assert dk.shape == dv.shape == k.shape
        x = torch.empty((2, 320, 64, 64), dtype=torch.bfloat16, device="cuda")
        w, b = torch.empty(320, device="cuda"), torch.empty(320, device="cuda")
        y = gn.group_norm_silu_fwd(x, w, b, 32, 1e-5, True)
        assert (y.shape, y.dtype) == (x.shape, x.dtype)
    assert [w.launches for w in wrappers] == before


def test_gpu_platform_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        aot_memory.analyze(tiny=True)
