"""The port's normals ip_adapter mode against the JAX package, on the CPU in
fp32: the frequency encoding and `NormalProjModel`, the decoupled
IP-Adapter attention, the to_k/to_v -> to_k_ip/to_v_ip initialisation, a
tiny UNet in ip mode, the tiny pipeline in ip mode, one training step, and a
checkpoint's layout and resume.

Tolerances (fp32 on both sides, differences are summation order):
- encoding, projection and one attention: 1e-5 absolute;
- the UNet: 1e-4 of its output's largest value;
- the pipeline: the decoded float image within 1e-3, uint8 within 1 level
  (as tests/test_torch_pipeline.py);
- the training step: loss and gradient norm rtol 1e-5, gradients 1e-4 of
  the largest gradient of their module (as tests/test_torch_training.py);
  every UNet leaf but to_k_ip/to_v_ip bit-identical after the AdamW update.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflecting_reality_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from reflecting_reality_tpu.models import ip_adapter as j_ip
from reflecting_reality_tpu.models.brushnet import BrushNetModel as JBrushNet
from reflecting_reality_tpu.models.clip_text import CLIPTextModel as JCLIP
from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel as JUNet
from reflecting_reality_tpu.models.vae import AutoencoderKL as JVAE
from reflecting_reality_tpu.ops.attention import Attention as JAttention
from reflecting_reality_tpu.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline as JPipeline,
)
from reflecting_reality_tpu.training import checkpoint as j_ckpt
from reflecting_reality_tpu.training.train_step import TrainConfig as JTrainConfig
from reflecting_reality_tpu.training.train_step import make_train_step as j_make_train_step
from reflecting_reality_tpu_torch.core.io import load_into, state_dict_from_jax_params
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models import ip_adapter
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.ops.attention import Attention
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from reflecting_reality_tpu_torch.training import TrainConfig, make_train_step
from reflecting_reality_tpu_torch.training import checkpoint as ckpt
from tests.test_torch_helpers import (
    TINY, TINY_TEXT, TINY_VAE, init_jax, nchw_to_nhwc, nhwc_to_nchw, port_and_jax, randn,
    to_torch,
)
from tests.test_torch_pipeline import H, W, _call_kwargs
from tests.test_torch_training import (
    BATCH, BCFG, CFG, LR, STEP_CFG, TEXT_CFG, VAE_CFG, adam_moments, batch_of, jax_draws,
    recover_grads, torch_draws,
)
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

N_TOK = j_ip.DEFAULT_NUM_TOKENS


def _unit_normals(seed, n):
    v = randn(seed, n, 1, 3)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_freq_encode_and_normal_proj_match_jax():
    x = _unit_normals(0, 3)
    want = np.asarray(j_ip.freq_encode(jnp.asarray(x)))
    got = ip_adapter.freq_encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 1, ip_adapter.NORMALS_EMBED_DIM)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    jp = j_ip.NormalProjModel(cross_attention_dim=32)
    params = init_jax(jp, jnp.zeros((1, 1, j_ip.NORMALS_EMBED_DIM)), seed=4)
    proj = to_torch(ip_adapter.NormalProjModel(32), params)
    assert sorted(proj.state_dict()) == ["proj.0.bias", "proj.0.weight"]
    want = np.asarray(j_ip.normal_tokens(jnp.asarray(x), params, cross_attention_dim=32))
    with torch.no_grad():
        got = ip_adapter.normal_tokens(torch.from_numpy(x), proj).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _ip_attention_pair(scale):
    ja = JAttention(query_dim=16, heads=2, dim_head=8, cross_attention_dim=16,
                    ip_num_tokens=N_TOK, ip_scale=scale)
    x, ctx = randn(1, 1, 10, 16), randn(2, 1, 12, 16)
    params = init_jax(ja, jnp.asarray(x), jnp.asarray(ctx), seed=5)
    ta = to_torch(Attention(16, 2, 8, cross_attention_dim=16, ip_num_tokens=N_TOK,
                            ip_scale=scale), params)
    return ja, ta, params, x, ctx


@pytest.mark.parametrize("scale", [0.0, 1.0, 0.6])
def test_ip_attention_matches_jax(scale):
    """The decoupled cross-attention against JAX's; with ip_scale 0 it is
    attention over the context without its last ip_num_tokens, and with a
    scale the IP branch contributes."""
    ja, ta, params, x, ctx = _ip_attention_pair(scale)
    want = np.asarray(ja.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    with torch.no_grad():
        got = ta(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
        plain = Attention(16, 2, 8, cross_attention_dim=16)
        plain.load_state_dict({k: v for k, v in ta.state_dict().items() if "_ip" not in k})
        truncated = plain(torch.from_numpy(x), torch.from_numpy(ctx[:, :-N_TOK])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if scale == 0.0:
        np.testing.assert_allclose(got, truncated, rtol=0, atol=1e-6)
    else:
        assert np.abs(got - truncated).max() > 1e-3


def _port_unet(seed, **cfg):
    return port_and_jax(UNet2DConditionModel, seed, **cfg)


@pytest.fixture(scope="module")
def ip_unet():
    unet, params = _port_unet(6, sample_size=8, ip_num_tokens=N_TOK, **TINY)
    return JUNet(sample_size=8, ip_num_tokens=N_TOK, **TINY), params, unet


def test_init_ip_params_copies_twins_as_jax(ip_unet):
    """A plain UNet's weights loaded into the ip UNet (IP leaves allowed
    missing) and to_k/to_v copied into to_k_ip/to_v_ip: JAX's
    init_ip_params_from_unet on the same trees."""
    _, ip_params, _ = ip_unet
    _, plain = _port_unet(7, sample_size=8, **TINY)
    want = state_dict_from_jax_params(
        j_ip.init_ip_params_from_unet(ip_params["params"], plain["params"]))
    unet = UNet2DConditionModel(sample_size=8, ip_num_tokens=N_TOK, **TINY)
    load_into(unet, state_dict_from_jax_params(plain), allow_missing=ip_adapter.IP_NAMES)
    ip_adapter.init_ip_params_from_unet(unet)
    got = unet.state_dict()
    assert sorted(got) == sorted(want)
    n_ip = 0
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
        n_ip += ip_adapter.is_ip_param_name(k)
    assert n_ip == 2 * 16         # to_k_ip and to_v_ip of 16 cross-attentions


def test_ip_unet_matches_jax(ip_unet):
    ju, params, unet = ip_unet
    x, ctx, t = randn(8, 2, 8, 8, 4), randn(9, 2, 78, 32), np.array([10, 700])
    want = np.asarray(jax.jit(ju.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(ctx)))
    with torch.no_grad():
        got = nchw_to_nhwc(unet(nhwc_to_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx)))
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def ip_pipes(ip_unet):
    """Tiny pipelines (tests/test_torch_pipeline.py's configs) with an ip UNet
    and a NormalProjModel, JAX and port on the same weights."""
    ju, up, unet = ip_unet
    vae, vp = port_and_jax(AutoencoderKL, 2, **TINY_VAE)
    text, tp = port_and_jax(CLIPTextModel, 3, **TINY_TEXT)
    brushnet, bp = port_and_jax(BrushNetModel, 1, conditioning_channels=6, **TINY)
    jp = j_ip.NormalProjModel(cross_attention_dim=32)
    pp = init_jax(jp, jnp.zeros((1, 1, j_ip.NORMALS_EMBED_DIM)), seed=8)
    j = JPipeline(vae=(JVAE(**TINY_VAE), vp), text_encoder=(JCLIP(**TINY_TEXT), tp),
                  tokenizer=JHashTokenizer(vocab_size=1000), unet=(ju, up),
                  brushnet=(JBrushNet(conditioning_channels=6, **TINY), bp),
                  depth_conditioning_mode="concat", normals_conditioning_mode="ip_adapter",
                  normal_proj=(jp, pp))
    t = StableDiffusionBrushNetPipeline(
        vae=vae, text_encoder=text, tokenizer=HashTokenizer(vocab_size=1000),
        unet=unet, brushnet=brushnet, depth_conditioning_mode="concat",
        normals_conditioning_mode="ip_adapter",
        normal_proj=to_torch(ip_adapter.NormalProjModel(32), pp), device="cpu")
    return j, t


def test_ip_pipeline_matches_jax(ip_pipes):
    """Depth concat + the mean normal's token on both CFG halves of the
    UNet's embeds (BrushNet keeps the text), two seeds of one prompt,
    against JAX's pipeline."""
    jpipe, tpipe = ip_pipes
    n = 2
    kw = dict(_call_kwargs(), normals=_unit_normals(3, 1)[0], latents=randn(7, n, 8, 8, 4),
              num_images_per_prompt=n)
    jkw = dict(kw, latents=jnp.asarray(kw["latents"]))
    ref = np.asarray(jpipe(**jkw, output_type="latent"))
    got = tpipe(**kw, output_type="latent")
    assert got.shape == ref.shape == (n, H, W, 3) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-3, np.abs(got - ref).max()
    got8, ref8 = tpipe(**kw, output_type="np"), jpipe(**jkw, output_type="np")
    assert np.abs(got8.astype(int) - ref8.astype(int)).max() <= 1
    # the normal token matters: another normal gives another image
    other = tpipe(**dict(kw, normals=-kw["normals"]), output_type="latent")
    assert np.abs(other - got).max() > 1e-3


def test_ip_pipeline_needs_normal_proj(ip_pipes):
    _, tpipe = ip_pipes
    with pytest.raises(ValueError, match="normal_proj"):
        StableDiffusionBrushNetPipeline(
            vae=tpipe.vae, text_encoder=tpipe.text_encoder, tokenizer=tpipe.tokenizer,
            unet=tpipe.unet, brushnet=tpipe.brushnet, normals_conditioning_mode="ip_adapter",
            device="cpu")


# ------------------------------------------------------------- training

IP_CFG = dict(STEP_CFG, normals_conditioning_mode="ip_adapter")


@pytest.fixture(scope="module")
def ip_models():
    """tests/test_torch_training.py's tiny configs with an ip UNet and a
    NormalProjModel: {name: (JAX module, JAX params, port module)}."""
    out = {}
    for seed, (name, jcls, tcls, cfg) in enumerate((
            ("unet", JUNet, UNet2DConditionModel,
             dict(sample_size=2, ip_num_tokens=N_TOK, **CFG)),
            ("brushnet", JBrushNet, BrushNetModel, dict(conditioning_channels=6, **BCFG)),
            ("vae", JVAE, AutoencoderKL, VAE_CFG), ("text", JCLIP, CLIPTextModel, TEXT_CFG))):
        module, params = port_and_jax(tcls, 11 + seed, **cfg)
        out[name] = (jcls(**cfg), params, module)
    jp = j_ip.NormalProjModel(cross_attention_dim=16)
    pp = init_jax(jp, jnp.zeros((1, 1, j_ip.NORMALS_EMBED_DIM)), seed=12)
    out["normal_proj"] = (jp, pp, to_torch(ip_adapter.NormalProjModel(16), pp))
    return out


def _ip_batch(seed=0):
    return dict(batch_of(BATCH, seed=seed), normals=_unit_normals(20 + seed, BATCH))


def _port_ip_step(ip_models, **kw):
    m = {k: copy.deepcopy(v[2]) for k, v in ip_models.items()}
    return make_train_step(m["unet"], m["brushnet"], m["vae"], m["text"],
                           TrainConfig(**IP_CFG, **kw), device="cpu", normal_proj=m["normal_proj"])


def _jax_ip_state(ip_models, **kw):
    j = {k: v[0] for k, v in ip_models.items()}
    p = {k: v[1] for k, v in ip_models.items()}
    step, init = j_make_train_step(j["unet"], j["brushnet"], j["vae"], j["text"],
                                   JTrainConfig(**IP_CFG, **kw))
    return step, init(p["brushnet"], p["unet"], p["vae"], p["text"],
                      normal_proj_params=p["normal_proj"])


@pytest.fixture(scope="module")
def ip_step(ip_models):
    j_step, j_state = _jax_ip_state(ip_models)
    batch, rng = _ip_batch(), jax.random.PRNGKey(3)
    j_s1, j_m = jax.jit(j_step)(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    t_step, t_init = _port_ip_step(ip_models)
    t_state = t_init()
    p0 = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
          for k, m in t_state.trainable.items()}
    t_state, t_m = t_step(t_state, batch, draws=torch_draws(jax_draws(rng, BATCH)))
    return dict(j_s1=j_s1, j_m=j_m, t_state=t_state, t_m=t_m, p0=p0)


def _arrays(tree, prefix=()):
    """{path: array} of a (possibly optax-masked) param subtree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_arrays(v, prefix + (k,)))
        elif hasattr(v, "shape"):
            out[prefix + (k,)] = np.asarray(v)
    return out


def _flat(tree):
    """Like state_dict_from_jax_params, skipping optax's masked leaves."""
    flat = {}
    for path, v in _arrays(jax.device_get(tree)).items():
        node = flat
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return {k: t.numpy() for k, t in state_dict_from_jax_params(flat).items()}


def test_ip_step_matches_jax(ip_step):
    """Loss, ‖g‖ and every trained gradient (recovered from AdamW's first
    moment: to_k_ip/to_v_ip, normal_proj, BrushNet) against JAX's; the
    optimizer holds exactly those leaves."""
    r = ip_step
    np.testing.assert_allclose(float(r["t_m"]["loss"]), float(r["j_m"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(r["t_m"]["grad_norm"]), float(r["j_m"]["grad_norm"]),
                               rtol=1e-5)
    st = r["t_state"]
    assert sorted(st.trainable) == ["brushnet", "normal_proj", "unet"]
    j_mu, _ = adam_moments(r["j_s1"].opt_state)
    gn, t_gn = float(r["j_m"]["grad_norm"]), float(r["t_m"]["grad_norm"])
    n_trained = 0
    for name, module in st.trainable.items():
        j_grads = recover_grads(_flat(j_mu[name]), gn)
        trained = {n: p for n, p in module.named_parameters() if p.requires_grad}
        if name == "unet":
            assert sorted(trained) == sorted(n for n in j_grads if ip_adapter.is_ip_param_name(n))
            assert trained and all(ip_adapter.is_ip_param_name(n) for n in trained)
        else:
            assert sorted(trained) == sorted(j_grads)
        t_grads = recover_grads({n: st.optimizer.state[p]["exp_avg"].numpy()
                                 for n, p in trained.items()}, t_gn)
        tol = 1e-4 * max(np.abs(j_grads[n]).max() for n in trained)
        for n in trained:
            np.testing.assert_allclose(t_grads[n], j_grads[n], rtol=0, atol=tol,
                                       err_msg=f"{name}.{n}")
            assert np.abs(j_grads[n]).max() > 0, f"{name}.{n} took no gradient"
        n_trained += len(trained)
    assert n_trained == len(st.params) == len(st.optimizer.state)


def test_ip_step_moves_only_the_trained_leaves(ip_step):
    """After one AdamW step with weight decay (1e-2): every UNet leaf but
    to_k_ip/to_v_ip is bit-identical, the IP leaves and normal_proj moved by
    about lr, as in JAX (tests/test_ip_adapter.py::test_partial_freeze)."""
    r = ip_step
    st, p0 = r["t_state"], r["p0"]
    assert st.optimizer.param_groups[0]["weight_decay"] == 1e-2
    ip_moved = 0.0
    for n, p in st.trainable["unet"].named_parameters():
        if ip_adapter.is_ip_param_name(n):
            ip_moved = max(ip_moved, (p - p0["unet"][n]).abs().max().item())
        else:
            assert torch.equal(p, p0["unet"][n]), n
    assert ip_moved > 0.5 * LR
    proj_moved = max((p - p0["normal_proj"][n]).abs().max().item()
                     for n, p in st.trainable["normal_proj"].named_parameters())
    assert proj_moved > 0.5 * LR
    j_unet = _flat(r["j_s1"].trainable["unet"])
    for n, p in st.trainable["unet"].named_parameters():
        if not ip_adapter.is_ip_param_name(n):
            np.testing.assert_array_equal(p.detach().numpy(), j_unet[n], err_msg=n)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_ip_checkpoint_layout_and_resume(ip_models, tmp_path):
    """The checkpoint holds JAX's files (brushnet/, unet/ with the IP
    leaves, ip_adapter/normal_proj.safetensors, ema/brushnet and ema/unet);
    the JAX loader reads its normal_proj file; a fresh state resumes it bit
    for bit."""
    kw = dict(use_ema=True)
    step, init = _port_ip_step(ip_models, **kw)
    state = init()
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        state, _ = step(state, _ip_batch(i), gen)
    path = ckpt.save_state(str(tmp_path / "port"), 2, state)
    _, j_state = _jax_ip_state(ip_models, **kw)
    j_path = j_ckpt.save_state(str(tmp_path / "jax"), 2, j_state, ip_models["brushnet"][0],
                               ip_models["unet"][0])
    port_files = [p for p in _tree(path) if p != ckpt.TRAIN_STATE_NAME]
    assert port_files == [p for p in _tree(j_path) if p != "train_state.msgpack"]
    assert os.path.join("ip_adapter", "normal_proj.safetensors") in port_files

    from reflecting_reality_tpu.core.io import load_safetensors as j_load_safetensors
    j_file = j_load_safetensors(os.path.join(j_path, ip_adapter.NORMAL_PROJ_FILE))
    p_file = j_load_safetensors(os.path.join(path, ip_adapter.NORMAL_PROJ_FILE))
    assert sorted(p_file) == sorted(j_file) == ["proj_0.bias", "proj_0.weight"]
    np.testing.assert_array_equal(
        p_file["proj_0.weight"], state.trainable["normal_proj"].proj[0].weight.detach().numpy())

    _, init2 = _port_ip_step(ip_models, **kw)
    fresh = init2()
    ckpt.load_state(path, fresh)
    assert (fresh.step, fresh.updates) == (state.step, state.updates)
    for name in state.trainable:
        a, b = state.trainable[name].state_dict(), fresh.trainable[name].state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), f"{name}.{k}"
    for name in ("brushnet", "unet"):
        for k, t in state.ema[name].items():
            assert torch.equal(t, fresh.ema[name][k]), f"ema {name}.{k}"
    for a, b in zip(state.params, fresh.params):
        assert torch.equal(state.optimizer.state[a]["exp_avg"], fresh.optimizer.state[b]["exp_avg"])
    # the port loads JAX's normal_proj file (its `proj_0.*` names)
    proj = ip_adapter.load_normal_proj(ip_adapter.NormalProjModel(16),
                                       os.path.join(j_path, ip_adapter.NORMAL_PROJ_FILE))
    np.testing.assert_array_equal(proj.proj[0].weight.detach().numpy(),
                                  np.asarray(ip_models["normal_proj"][1]["params"]["proj_0"]
                                             ["kernel"]).T)
