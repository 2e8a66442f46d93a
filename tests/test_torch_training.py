"""The port's training step and its pieces against the JAX package, on the CPU
in fp32 (plain PyTorch paths).

One whole step runs at the tiny config of tests/test_training.py (2-block
UNet and BrushNet, 4-level VAE, 1-layer CLIP, 16x16 pixels) with jittered
parameters carried across and JAX's own random draws (VAE posterior noise,
diffusion noise, timesteps) passed in through `draws=`.  JAX's gradients
come out of its AdamW state: after the first update the first moment is
exactly (1 − β1)·clip(g), and the step reports ‖g‖, so g is recovered on
both sides the same way and every trainable gradient is compared.

Tolerances (fp32 on both sides; the two frameworks sum in different orders
through ~60 conv/matmul layers forward and back):
- loss and ‖g‖: rtol 1e-5;
- gradients: atol 1e-4 of the largest gradient of the model (an element's
  error is set by the magnitudes summed into it, not by its own size);
- params, AdamW moments and EMA after the step: the first update moves each
  element by lr·g/(|g| + ε) ≈ ±lr, which an error δ in g moves by at most
  lr·δ/|g| (and by 2·lr where g is within δ of 0), so params and the EMA are
  held elementwise at 1e-6 + lr·min(2, tol/|g|) with tol the gradient
  tolerance; the first moment (linear in g) at 1e-4 of its largest element,
  the second (0.001·g²) at 2e-4 of its largest.
The pieces (schedules, noise math, EMA, weight surgery) are held at rtol
1e-6 or exactly where both sides do the same fp32 arithmetic.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.models.brushnet import BrushNetModel as JBrushNet
from reflecting_reality_tpu.models.brushnet import init_params_from_unet
from reflecting_reality_tpu.models.clip_text import CLIPTextModel as JCLIP
from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel as JUNet
from reflecting_reality_tpu.models.vae import AutoencoderKL as JVAE
from reflecting_reality_tpu.schedulers import common as j_common
from reflecting_reality_tpu.training.ema import ema_update as j_ema_update
from reflecting_reality_tpu.training.lr_schedules import get_schedule as j_get_schedule
from reflecting_reality_tpu.training.train_step import TrainConfig as JTrainConfig
from reflecting_reality_tpu.training.train_step import (
    assemble_conditioning_latents as j_assemble,
)
from reflecting_reality_tpu.training.train_step import make_train_step as j_make_train_step
from reflecting_reality_tpu_torch.core.io import state_dict_from_jax_params
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.schedulers import common as t_common
from reflecting_reality_tpu_torch.training import (
    TrainConfig, assemble_conditioning_latents, ema_update, get_schedule, make_train_step,
    nearest_resize,
)
from tests.test_torch_helpers import jitter, nhwc_to_nchw, randn, to_torch

# tests/test_training.py:22-45
CFG = dict(
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(8, 16),
    attention_head_dim=2,
    cross_attention_dim=16,
    norm_num_groups=4,
    layers_per_block=1,
)
BCFG = dict(CFG, down_block_types=("DownBlock2D", "DownBlock2D"), mid_block_type="MidBlock2D",
            up_block_types=("UpBlock2D", "UpBlock2D"))
VAE_CFG = dict(block_out_channels=(4, 4, 4, 4), norm_num_groups=2)
TEXT_CFG = dict(vocab_size=100, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=32)
H = W = 16           # pixels; latents 2x2
BATCH = 2
LR = 1e-3
STEP_CFG = dict(learning_rate=LR, lr_warmup_steps=0, max_train_steps=100)
VARIANT = dict(train_base_unet=True, use_ema=True, snr_gamma=5.0, prediction_type="v_prediction")


def batch_of(n: int, seed: int = 0) -> dict:
    """The loader's NHWC dict (tests/test_training.py:66-74), as numpy."""
    r = np.random.RandomState(seed)
    return {
        "pixel_values": r.randn(n, H, W, 3).astype(np.float32),
        "conditioning_pixel_values": r.randn(n, H, W, 3).astype(np.float32),
        "masks": (r.rand(n, H, W, 1) > 0.5).astype(np.float32),
        "depths": r.randn(n, H, W, 1).astype(np.float32),
        "input_ids": r.randint(0, 100, (n, 7)).astype(np.int32),
    }


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny torch ops here are launch-bound; with the suite's parallel
    workers each using every core they slow ~20x, so this module runs torch
    on one thread and restores the setting after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_models():
    """The four tiny JAX modules and their jittered params (numpy)."""
    mods = dict(unet=JUNet(sample_size=2, **CFG), brushnet=JBrushNet(conditioning_channels=6, **BCFG),
                vae=JVAE(**VAE_CFG), text=JCLIP(**TEXT_CFG))
    r = jax.random.split(jax.random.PRNGKey(0), 4)
    sample, t, ehs = jnp.zeros((1, 2, 2, 4)), jnp.array([1]), jnp.zeros((1, 7, 16))
    args = dict(unet=(sample, t, ehs), brushnet=(sample, t, ehs, jnp.zeros((1, 2, 2, 6))),
                vae=(jnp.zeros((1, H, W, 3)), jax.random.PRNGKey(9)),
                text=(jnp.zeros((1, 7), jnp.int32),))
    params = {k: jitter(jax.jit(m.init)(r[i], *args[k]), seed=i)
              for i, (k, m) in enumerate(mods.items())}
    return mods, params


def jax_draws(rng, n: int) -> dict:
    """The draws JAX's loss_fn takes from `rng` (train_step.py:254-280 and
    assemble_conditioning_latents :166), as numpy NHWC."""
    r_cond, r_noise, r_t = jax.random.split(rng, 3)
    r1, r2, _, _ = jax.random.split(r_cond, 4)
    shape = (n, 2, 2, 4)
    return {
        "vae_noise": {"latents": np.asarray(jax.random.normal(r1, shape, jnp.float32)),
                      "cond": np.asarray(jax.random.normal(r2, shape, jnp.float32))},
        "noise": np.asarray(jax.random.normal(r_noise, shape, jnp.float32)),
        "timesteps": np.asarray(jax.random.randint(r_t, (n,), 0, 1000, dtype=jnp.int32)),
    }


def torch_draws(d: dict) -> dict:
    return {"vae_noise": {k: nhwc_to_nchw(v) for k, v in d["vae_noise"].items()},
            "noise": nhwc_to_nchw(d["noise"]),
            "timesteps": torch.tensor(d["timesteps"]).long()}


def torch_models(params):
    return dict(
        unet=to_torch(UNet2DConditionModel(sample_size=2, **CFG), params["unet"]),
        brushnet=to_torch(BrushNetModel(conditioning_channels=6, **BCFG), params["brushnet"]),
        vae=to_torch(AutoencoderKL(**VAE_CFG), params["vae"]),
        text=to_torch(CLIPTextModel(**TEXT_CFG), params["text"]),
    )


def adam_moments(opt_state):
    """(mu, nu) param trees of an optax chain(clip, adamw) state."""
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise AssertionError("no Adam state")


def flat(tree) -> dict:
    """A JAX param subtree as the port's {state_dict key: numpy}."""
    return {k: v.numpy() for k, v in state_dict_from_jax_params(jax.device_get(tree)).items()}


def recover_grads(mu: dict, grad_norm: float, max_norm: float = 1.0) -> dict:
    """g from the first moment after one update: mu = (1 − β1)·clip(g)."""
    unclip = grad_norm / max_norm if grad_norm >= max_norm else 1.0
    return {k: v / 0.1 * unclip for k, v in mu.items()}


@pytest.fixture(scope="module", params=["default", "variant"])
def one_step(request, jax_models):
    """One JAX step and one port step from the same params, batch and draws."""
    kw = VARIANT if request.param == "variant" else {}
    mods, params = jax_models
    j_step, j_init = j_make_train_step(mods["unet"], mods["brushnet"], mods["vae"],
                                       mods["text"], JTrainConfig(**STEP_CFG, **kw))
    j_state = j_init(params["brushnet"], params["unet"], params["vae"], params["text"])
    batch = batch_of(BATCH)
    rng = jax.random.PRNGKey(3)
    j_s1, j_m = jax.jit(j_step)(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    tm = torch_models(params)
    t_step, t_init = make_train_step(tm["unet"], tm["brushnet"], tm["vae"], tm["text"],
                                     TrainConfig(**STEP_CFG, **kw), device="cpu")
    t_state = t_init()
    p0 = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
          for k, m in t_state.trainable.items()}
    t_state, t_m = t_step(t_state, batch, draws=torch_draws(jax_draws(rng, BATCH)))
    return dict(kw=kw, j_state=j_state, j_s1=j_s1, j_m=j_m, t_state=t_state, t_m=t_m, p0=p0)


def _grad_tol(grads: dict) -> float:
    return 1e-4 * max(np.abs(g).max() for g in grads.values())


def _update_tol(g, tol: float):
    """Elementwise bound on a param after one AdamW update from a gradient
    known to within `tol` (see the module docstring)."""
    with np.errstate(divide="ignore"):
        return 1e-6 + LR * np.minimum(2.0, tol / np.abs(np.asarray(g)))


def test_step_loss_and_grad_norm(one_step):
    r = one_step
    assert np.isfinite(float(r["j_m"]["loss"]))
    np.testing.assert_allclose(float(r["t_m"]["loss"]), float(r["j_m"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(r["t_m"]["grad_norm"]), float(r["j_m"]["grad_norm"]),
                               rtol=1e-5)
    assert float(r["t_m"]["nonfinite_skipped"]) == 0.0
    assert r["t_state"].step == 1 and r["t_state"].updates == 1


def test_step_gradients_params_moments_and_ema(one_step):
    r = one_step
    st, j_s1 = r["t_state"], r["j_s1"]
    j_mu, j_nu = adam_moments(j_s1.opt_state)
    gn = float(r["j_m"]["grad_norm"])
    modules = ["brushnet"] + (["unet"] if r["kw"].get("train_base_unet") else [])
    assert sorted(st.trainable) == sorted(modules)
    for name in modules:
        module = st.trainable[name]
        mu, nu = flat(j_mu[name]), flat(j_nu[name])
        j_grads = recover_grads(mu, gn)
        tol = _grad_tol(j_grads)
        mu_tol = _grad_tol(mu)
        nu_tol = 2 * _grad_tol(nu)
        t_mu = {n: st.optimizer.state[p]["exp_avg"].numpy() for n, p in module.named_parameters()}
        t_nu = {n: st.optimizer.state[p]["exp_avg_sq"].numpy()
                for n, p in module.named_parameters()}
        t_grads = recover_grads(t_mu, float(r["t_m"]["grad_norm"]))
        assert sorted(t_grads) == sorted(j_grads)
        j_p1, j_p0 = flat(j_s1.trainable[name]), flat(r["j_state"].trainable[name])
        j_ema = flat(j_s1.ema[name]) if j_s1.ema is not None else None
        for n, p in module.named_parameters():
            np.testing.assert_allclose(t_grads[n], j_grads[n], rtol=0, atol=tol, err_msg=n)
            np.testing.assert_allclose(t_mu[n], mu[n], rtol=0, atol=mu_tol, err_msg=n)
            np.testing.assert_allclose(t_nu[n], nu[n], rtol=0, atol=nu_tol, err_msg=n)
            # params: the initial ones agree exactly
            np.testing.assert_array_equal(r["p0"][name][n].numpy(), j_p0[n], err_msg=n)
            atol = _update_tol(j_grads[n], tol)
            diff = np.abs(p.detach().numpy() - j_p1[n])
            assert (diff <= atol).all(), (n, diff.max())
            if j_ema is not None:
                e = st.ema[name][n].numpy()
                assert (np.abs(e - j_ema[n]) <= atol).all(), (n, np.abs(e - j_ema[n]).max())
        # the step moved the params: every sure element by about lr
        moved = [np.abs(p.detach().numpy() - r["p0"][name][n].numpy()).max()
                 for n, p in module.named_parameters()]
        assert max(moved) > 0.5 * LR
    if "unet" not in modules:
        for n, p in st.frozen["unet"].named_parameters():
            assert not p.requires_grad


# ---------------------------------------------------------------- guards

def _tiny_torch_step(jax_models, **kw):
    tm = torch_models(jax_models[1])
    step, init = make_train_step(tm["unet"], tm["brushnet"], tm["vae"], tm["text"],
                                 TrainConfig(**STEP_CFG, **kw), device="cpu")
    return step, init()


def _snapshot(state):
    params = [p.detach().clone() for p in state.params]
    opt = {i: {k: v.clone() for k, v in state.optimizer.state[p].items()}
           for i, p in enumerate(state.params)}
    ema = ({m: {n: t.clone() for n, t in d.items()} for m, d in state.ema.items()}
           if state.ema is not None else None)
    return params, opt, ema


def test_nonfinite_guard_leaves_state_untouched(jax_models):
    step, state = _tiny_torch_step(jax_models, use_ema=True)
    draws = torch_draws(jax_draws(jax.random.PRNGKey(1), BATCH))
    state, m = step(state, batch_of(BATCH), draws=draws)
    assert float(m["nonfinite_skipped"]) == 0.0
    before = _snapshot(state)
    bad = batch_of(BATCH)
    bad["pixel_values"][0, 0, 0, 0] = np.nan
    state, m = step(state, bad, draws=draws)
    assert float(m["nonfinite_skipped"]) == 1.0 and not np.isfinite(float(m["loss"]))
    assert state.step == 2 and state.updates == 1
    after = _snapshot(state)
    for a, b in zip(before[0], after[0]):
        assert torch.equal(a, b)
    for i in before[1]:
        for k in before[1][i]:
            assert torch.equal(before[1][i][k], after[1][i][k])
    for m_name in before[2]:
        for n in before[2][m_name]:
            assert torch.equal(before[2][m_name][n], after[2][m_name][n])
    assert all(p.grad is None for p in state.params)


def test_gradient_accumulation_matches_one_big_step(jax_models):
    """K = 2 micro-steps of one sample each update once, as one step on both
    samples does (epsilon MSE: the mean of the two means is the mean)."""
    batch = batch_of(BATCH)
    draws = torch_draws(jax_draws(jax.random.PRNGKey(2), BATCH))
    step1, big = _tiny_torch_step(jax_models)
    big, m_big = step1(big, batch, draws=draws)

    stepk, acc = _tiny_torch_step(jax_models, gradient_accumulation_steps=2)
    p0 = [p.detach().clone() for p in acc.params]
    half = []
    for i in range(2):
        sl = slice(i, i + 1)
        d = {"vae_noise": {k: v[sl] for k, v in draws["vae_noise"].items()},
             "noise": draws["noise"][sl], "timesteps": draws["timesteps"][sl]}
        acc, m = stepk(acc, {k: v[sl] for k, v in batch.items()}, draws=d)
        half.append(float(m["loss"]))
        if i == 0:
            assert acc.updates == 0 and acc.micro_step == 1
            assert all(torch.equal(a, p) for a, p in zip(p0, acc.params))
    assert acc.updates == 1 and acc.micro_step == 0 and acc.step == 2
    np.testing.assert_allclose(np.mean(half), float(m_big["loss"]), rtol=1e-5)
    # as in the JAX comparison: the first moment (0.1·clipped g) at 1e-4 of
    # its largest element, params by `_update_tol`
    mus = [(acc.optimizer.state[a]["exp_avg"], big.optimizer.state[b]["exp_avg"])
           for a, b in zip(acc.params, big.params)]
    tol = 1e-4 * max(m.abs().max().item() for _, m in mus)
    for (m_acc, m_big), a, b in zip(mus, acc.params, big.params):
        torch.testing.assert_close(m_acc, m_big, rtol=0, atol=tol)
        atol = torch.from_numpy(_update_tol(m_big.numpy(), tol)).float()
        assert ((a - b).abs() <= atol).all()


def test_entry_point_defaults_to_the_card(jax_models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tm = torch_models(jax_models[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(tm["unet"], tm["brushnet"], tm["vae"], tm["text"], TrainConfig())


def test_unported_options_raise(jax_models):
    """ip_adapter is still to port; a checkpointing policy that neither
    package has is refused."""
    with pytest.raises(NotImplementedError, match="item 14"):
        _tiny_torch_step(jax_models, normals_conditioning_mode="ip_adapter")
    with pytest.raises(ValueError, match="everything"):
        _tiny_torch_step(jax_models, gradient_checkpointing=True,
                         gradient_checkpointing_policy="everything")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_gradient_checkpointing_gives_the_same_step(jax_models, policy):
    """Checkpointing under either policy (dots: the outputs of mm, addmm and
    convolution saved, the rest recomputed) gives the bits of the step
    without it: the recomputation repeats the same CPU arithmetic."""
    draws = torch_draws(jax_draws(jax.random.PRNGKey(4), BATCH))
    runs = []
    for ckpt in (False, True):
        step, state = _tiny_torch_step(jax_models, gradient_checkpointing=ckpt,
                                       gradient_checkpointing_policy=policy)
        state, m = step(state, batch_of(BATCH), draws=draws)
        runs.append((float(m["loss"]), float(m["grad_norm"]),
                     [p.detach().clone() for p in state.params]))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2], runs[1][2]):
        assert torch.equal(a, b)


def test_dots_policy_recomputes_everything_but_the_products(jax_models):
    """Under "dots" the backward pass recomputes no convolution or matrix
    product (their outputs were saved) but does recompute the rest (SiLU);
    under "full" it recomputes both.  Ops are counted as they reach the
    dispatcher during the backward pass."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    from reflecting_reality_tpu_torch.training.train_step import denoise

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls[func] += 1
            return func(*args, **(kwargs or {}))

    tm = torch_models(jax_models[1])
    tm["unet"].requires_grad_(False)
    r = np.random.RandomState(8)
    noisy, cond = (torch.from_numpy(r.randn(BATCH, c, 2, 2).astype(np.float32)) for c in (4, 6))
    ehs = torch.from_numpy(r.randn(BATCH, 7, 16).astype(np.float32))
    t = torch.tensor([10, 700])
    aten = torch.ops.aten
    counts = {}
    for policy in ("full", "dots"):
        tm["brushnet"].zero_grad(set_to_none=True)
        out = denoise(tm["unet"], tm["brushnet"], noisy, t, ehs, cond, True, policy)
        with Count() as c:
            out.square().mean().backward()
        counts[policy] = {op: c.calls[op] for op in (
            aten.convolution.default, aten.mm.default, aten.addmm.default, aten.silu.default)}
    # convolution and addmm run only in forwards (their backward ops are
    # others); mm also computes the gradients of every Linear, so only its
    # surplus under "full" is the recomputation
    full, dots = counts["full"], counts["dots"]
    assert full[aten.convolution.default] > 0 and full[aten.addmm.default] > 0
    assert dots[aten.convolution.default] == dots[aten.addmm.default] == 0
    assert full[aten.mm.default] > dots[aten.mm.default]
    assert dots[aten.silu.default] == full[aten.silu.default] > 0


def test_resolve_device_cache_matches_jax():
    from reflecting_reality_tpu.training.train_step import resolve_device_cache as j_resolve

    from reflecting_reality_tpu_torch.training.train_step import resolve_device_cache

    r = np.random.RandomState(7)
    cache = {"latent_moments": r.randn(6, 2, 2, 8).astype(np.float32),
             "masks": (r.rand(6, 2, 2, 1) > 0.5).astype(np.float32)}
    batch = {"index": np.array([4, 0, 4], np.int32),
             "input_ids": r.randint(0, 100, (3, 7)).astype(np.int32)}
    want = j_resolve({k: jnp.asarray(v) for k, v in batch.items()},
                     {k: jnp.asarray(v) for k, v in cache.items()})
    got = resolve_device_cache({k: torch.from_numpy(v) for k, v in batch.items()},
                               {k: torch.from_numpy(v) for k, v in cache.items()})
    assert set(got) == set(want) == {"latent_moments", "masks", "input_ids"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------- pieces

@pytest.mark.parametrize("depth,normals,cached", [
    ("latents", "concat", False), (None, "latents", False), ("latents", "latents", True)])
def test_conditioning_latents_match_jax(jax_models, depth, normals, cached):
    """The conditioning modes the full step does not take: depth and normals
    `latents` (VAE-encoded), normals `concat`, and the cached-moments branch,
    with JAX's four posterior draws passed in (fp32 VAE encoder: 1e-5)."""
    mods, params = jax_models
    r = np.random.RandomState(5)
    batch = batch_of(BATCH)
    batch["normals"] = r.randn(BATCH, H, W, 3).astype(np.float32)
    if cached:
        for key in ("latent_moments", "cond_latent_moments", "depth_latent_moments",
                    "normals_latent_moments"):
            batch[key] = r.randn(BATCH, 2, 2, 8).astype(np.float32)
    kw = dict(depth_conditioning_mode=depth, normals_conditioning_mode=normals)
    rng = jax.random.PRNGKey(6)
    ref = jax.jit(lambda p, b: j_assemble(mods["vae"], p, b, rng, JTrainConfig(**kw))[:2])(
        params["vae"], {k: jnp.asarray(v) for k, v in batch.items()})
    keys = jax.random.split(rng, 4)
    noise = {k: nhwc_to_nchw(np.asarray(jax.random.normal(kk, (BATCH, 2, 2, 4), jnp.float32)))
             for k, kk in zip(("latents", "cond", "depth", "normals"), keys)}
    vae = to_torch(AutoencoderKL(**VAE_CFG), params["vae"])
    with torch.no_grad():
        got = assemble_conditioning_latents(vae, batch, TrainConfig(**kw), vae_noise=noise)
    assert got[1].shape[1] == 4 + 1 + (4 if depth else 0) + (3 if normals == "concat" else 4)
    for g, want in zip(got, ref):
        np.testing.assert_allclose(np.moveaxis(g.numpy(), 1, -1), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["constant", "linear", "cosine", "cosine_with_restarts",
                                  "polynomial"])
def test_lr_schedules(name):
    w, t = 10, 100
    j = j_get_schedule(name, 1e-4, w, t, num_cycles=1.5, power=2.0)
    p = get_schedule(name, 1e-4, w, t, num_cycles=1.5, power=2.0)
    # JAX evaluates in fp32: near a zero of the cosine its rounding is ~1e-7
    # of the peak lr, hence the absolute term
    for step in (0, 1, w - 1, w, w + 7, t - 1, t, t + 5):
        np.testing.assert_allclose(p(step), float(j(step)), rtol=1e-6, atol=1e-6 * 1e-4,
                                   err_msg=f"{name} step {step}")
    assert p(0) == 0.0   # warm-up starts at lr 0, as in optax


def test_noise_math_matches_jax():
    js = j_common.NoiseSchedule.create(1000, 0.00085, 0.012, "scaled_linear")
    ts = t_common.NoiseSchedule.create(1000, 0.00085, 0.012, "scaled_linear",
                                       prediction_type="v_prediction")
    assert ts.prediction_type == "v_prediction"
    x0, eps = randn(0, 3, 2, 4, 4), randn(1, 3, 2, 4, 4)
    t = np.array([0, 517, 999], np.int32)
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    for jf, tf in ((j_common.add_noise, t_common.add_noise),
                   (j_common.get_velocity, t_common.get_velocity)):
        ref = np.asarray(jf(js, jnp.asarray(x0), jnp.asarray(eps), jt))
        got = tf(ts, torch.from_numpy(x0), torch.from_numpy(eps), tt).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_common.compute_snr(ts, tt).numpy(),
                               np.asarray(j_common.compute_snr(js, jt)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["squaredcos_cap_v2", "trained"])
def test_beta_schedules_match_jax(kind):
    kw = (dict(beta_schedule="squaredcos_cap_v2") if kind == "squaredcos_cap_v2"
          else dict(trained_betas=np.linspace(1e-4, 2e-2, 50)))
    n = 1000 if kind == "squaredcos_cap_v2" else 50
    js = j_common.NoiseSchedule.create(n, **kw)
    ts = t_common.NoiseSchedule.create(n, **kw)
    np.testing.assert_array_equal(ts.betas.numpy(), np.asarray(js.betas))
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ema_update_matches_jax(dtype):
    p = {"a": randn(0, 5, 7), "b": randn(1, 3)}
    e = {k: v + 0.5 * randn(2 + i, *v.shape) for i, (k, v) in enumerate(p.items())}
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    for step in (0, 3, 100000):
        ref = j_ema_update({k: jnp.asarray(v, jd) for k, v in e.items()},
                           {k: jnp.asarray(v) for k, v in p.items()}, jnp.int32(step))
        got = {k: torch.from_numpy(v).to(td) for k, v in e.items()}
        ema_update(got, {k: torch.from_numpy(v) for k, v in p.items()}, step)
        for k in p:
            assert got[k].dtype == td
            np.testing.assert_allclose(got[k].float().numpy(), np.asarray(ref[k], np.float32),
                                       rtol=1e-6, atol=1e-7)


def test_init_from_unet_matches_jax(jax_models):
    """The weight surgery against `init_params_from_unet`, both from the
    jittered tiny weights (so every copy shows)."""
    mods, params = jax_models
    ref = state_dict_from_jax_params(
        init_params_from_unet(params["brushnet"]["params"], params["unet"]["params"]))
    tm = torch_models(params)
    unet, brushnet = tm["unet"], tm["brushnet"]
    assert (BrushNetModel.config_from_unet(unet, 6)
            == {k: v for k, v in JBrushNet.config_from_unet(mods["unet"], 6).items()
                if k in BrushNetModel._config_field_names()})
    brushnet.init_from_unet(unet)
    got = brushnet.state_dict()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)
    w = got["conv_in_condition.weight"]
    assert torch.equal(w[:, :4], unet.conv_in.weight) and torch.equal(w[:, 4:8], w[:, :4])
    assert not w[:, 8:].any()

    fresh = BrushNetModel.from_unet(unet, conditioning_channels=6)
    for conv in list(fresh.brushnet_down_blocks) + [fresh.brushnet_mid_block]:
        assert not conv.weight.any() and not conv.bias.any()
    torch.testing.assert_close(fresh.conv_in_condition.weight, w, rtol=0, atol=0)
    torch.testing.assert_close(fresh.time_embedding.linear_1.weight,
                               unet.time_embedding.linear_1.weight, rtol=0, atol=0)


def test_nearest_resize_matches_interpolate():
    x = torch.from_numpy(randn(0, 2, 3, 16, 12))
    for hw in ((2, 2), (5, 3), (16, 12), (32, 24)):
        torch.testing.assert_close(nearest_resize(x, *hw),
                                   torch.nn.functional.interpolate(x, size=hw, mode="nearest"),
                                   rtol=0, atol=0)


def test_profiling_helpers(tmp_path):
    from reflecting_reality_tpu_torch.training import profiling

    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8).add_(1)
    assert any(e.key == "aten::add_" for e in prof.key_averages())
    assert [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    timer = profiling.StepTimer(window=2)
    assert timer.tick() is None and timer.tick() > 0
    assert profiling.device_memory_stats() == {} or torch.cuda.is_available()
