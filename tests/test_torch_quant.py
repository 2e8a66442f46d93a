"""The port's W8A8 int8 mode (`ops/quant.py`, `Attention`'s int8 fusion,
`StableDiffusionBrushNetPipeline.enable_int8`) against the JAX package's
(`ops/quant.py`, `Attention`, `enable_int8`), on the CPU.

Tolerances:
- weight codes and scales: bit-equal;
- the selection at full SD-1.5 width: the same modules, by name;
- single layers on the same fp32 input: activation codes and int32
  accumulators equal, outputs within 1 fp32 ulp (within 1 bf16 ulp for a
  bf16 module);
- attention with int8 projections: 1e-5 of the output's largest value (the
  attention itself is float arithmetic, ordered differently);
- `int8_mm`'s padded operands against the unpadded int32 product: equal;
- the tiny pipeline with every kernel quantized against JAX's, 2 steps, the
  same latents and the deterministic encode: the decoded float image within
  1e-4 (2.1e-6 measured), uint8 within 1 level (0 measured).  The float
  arithmetic around the int8 products is ordered differently on the two
  sides, so an activation that lands at a code boundary could round to the
  neighbouring code on one side only; at these inputs none does (a flipped
  code would move the image by a whole activation step, far past 1e-4);
- int8 against exact, the port: mean absolute uint8 difference < 16 (JAX's
  own bound, tests/test_quant.py).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn
from torch import nn

from reflecting_reality_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from reflecting_reality_tpu.models.brushnet import BrushNetModel as JBrushNet
from reflecting_reality_tpu.models.clip_text import CLIPTextModel as JCLIP
from reflecting_reality_tpu.models.unet2d import UNet2DConditionModel as JUNet
from reflecting_reality_tpu.models.vae import AutoencoderKL as JVAE
from reflecting_reality_tpu.ops import quant as jq
from reflecting_reality_tpu.ops.attention import Attention as JAttention
from reflecting_reality_tpu.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline as JPipeline,
)
from reflecting_reality_tpu_torch.core.io import _jax_path_to_key
from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
from reflecting_reality_tpu_torch.ops import quant
from reflecting_reality_tpu_torch.ops.attention import Attention
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from tests.test_torch_helpers import (
    TINY, TINY_TEXT, TINY_VAE, nchw_to_nhwc, nhwc_to_nchw, port_and_jax, randn, to_torch,
)
from tests.test_torch_pipeline import _call_kwargs
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

J_ALL = jq.select_all


def _jkernel(seed, shape, zero_channel=False):
    k = randn(seed, *shape) * np.arange(1, shape[-1] + 1, dtype=np.float32)
    if zero_channel:
        k[..., 0] = 0.0
    return k


def _torch_weight(kernel: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T))


@pytest.mark.parametrize("shape", [(3, 3, 16, 8), (1, 1, 40, 6), (48, 24)])
def test_weight_codes_and_scales_bit_equal_jax(shape):
    """Per-output-channel codes and scales, a conv and a dense kernel, with
    an all-zero output channel (scale 1e-12/127, codes 0)."""
    kernel = _jkernel(0, shape, zero_channel=True)
    jwq, jscale = jq.quantize_kernel(jnp.asarray(kernel))
    wq, scale = quant.quantize_kernel(_torch_weight(kernel))
    jwq = np.asarray(jwq)
    want = jwq.transpose(3, 2, 0, 1) if jwq.ndim == 4 else jwq.T
    np.testing.assert_array_equal(wq.numpy(), want)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert (wq[0] == 0).all() and wq.dtype == torch.int8


def test_selection_and_exclusion_on_a_tree_like_jax():
    """JAX's tests/test_quant.py tree: a big conv and dense are selected, a
    tiny dense and everything under time_embedding/time_emb_proj is not."""
    root = nn.Module()
    root.conv = nn.Conv2d(64, 128, 3)
    root.dense = nn.Linear(512, 128, bias=False)
    root.tiny = nn.Linear(8, 8)
    root.time_embedding = nn.Module()
    root.time_embedding.linear_1 = nn.Linear(512, 128)
    root.blocks = nn.Module()
    root.blocks.time_emb_proj = nn.Linear(512, 128)
    assert quant.quantize_modules(root) == 2
    assert isinstance(root.conv, quant.Int8Conv2d) and root.conv.bias is not None
    assert isinstance(root.dense, quant.Int8Linear)
    assert not hasattr(root.conv, "weight")
    for m in (root.tiny, root.time_embedding.linear_1, root.blocks.time_emb_proj):
        assert type(m) is nn.Linear
    assert quant.default_select(torch.ones(320, 320, 3, 3))
    assert quant.default_select(torch.ones(2560, 320))
    assert not quant.default_select(torch.ones(320, 4, 3, 3))
    assert not quant.default_select(torch.ones(4, 320, 3, 3))
    assert not quant.default_select(torch.ones(77))


def _jax_selected(module, *inputs):
    """Names (the port's) of the kernels JAX's `quantize_params` selects in
    a full-width module, from shapes alone (`jax.eval_shape`)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    out = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == jq.QKERNEL:
                out.append(_jax_path_to_key(path) + ".weight")
    walk(jax.eval_shape(lambda p: jq.quantize_params(p)[0], shapes), ())
    return sorted(out)


@pytest.mark.parametrize("which", ["unet", "brushnet"])
def test_full_width_selection_is_jaxs(which):
    """At full SD-1.5 width the default policy quantizes the modules JAX's
    does, by name: 256 of the UNet's 282 kernels (50 conv 3x3, 46 conv 1x1,
    160 dense) and 92 of BrushNet's 117.  Both sides are built without
    memory (meta device; `jax.eval_shape`)."""
    x, t, ehs = jnp.zeros((1, 8, 8, 4)), jnp.array([1]), jnp.zeros((1, 77, 768))
    with torch.device("meta"):
        if which == "unet":
            module, want_n, total = UNet2DConditionModel(), 256, 282
            jax_names = _jax_selected(JUNet(), x, t, ehs)
        else:
            module, want_n, total = BrushNetModel(conditioning_channels=6), 92, 117
            jax_names = _jax_selected(JBrushNet(conditioning_channels=6), x, t, ehs,
                                      jnp.zeros((1, 8, 8, 6)))
    n_layers = sum(isinstance(m, (nn.Conv2d, nn.Linear)) for m in module.modules())
    assert quant.quantize_modules(module) == want_n
    ours = sorted(f"{name}.weight" for name, _ in quant.int8_modules(module))
    assert len(jax_names) == want_n and n_layers == total
    assert ours == jax_names
    if which == "unet":
        kinds = [m.weight_q.shape[1:3] if m.weight_q.dim() == 4 else "dense"
                 for _, m in quant.int8_modules(module)]
        assert (kinds.count((3, 3)), kinds.count((1, 1)), kinds.count("dense")) == (50, 46, 160)


def _assert_within_ulp(got: torch.Tensor, want: np.ndarray, dtype):
    want = np.asarray(want, np.float32)
    got = got.float().detach().numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    if dtype == torch.bfloat16:
        ulp = ulp * 2.0 ** 16
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


CONV_CASES = {
    "1x1": dict(k=1, padding=0),
    "3x3_pad1": dict(k=3, padding=1),
    "stride2": dict(k=3, padding=1, stride=2),
    "no_bias": dict(k=3, padding=1, bias=False),
    "bf16": dict(k=3, padding=1, dtype=torch.bfloat16),
    "dilation2": dict(k=3, padding=2, dilation=2),
    "groups2": dict(k=3, padding=1, groups=2),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv_matches_jax(case):
    """`Int8Conv2d` against `_conv_int8` through `quantized_apply` with
    `select_all`, the same fp32 input: activation codes and int32
    accumulators equal, outputs within 1 ulp of the module's dtype."""
    c = {**dict(stride=1, dilation=1, groups=1, bias=True, dtype=torch.float32),
         **CONV_CASES[case]}
    cin, cout, k, p = 12, 24, c["k"], c["padding"]
    kernel = _jkernel(1, (k, k, cin // c["groups"], cout))
    bias = 0.1 * randn(2, cout)
    if c["dtype"] == torch.bfloat16:     # values both sides store exactly
        kernel = torch.from_numpy(kernel).bfloat16().float().numpy()
        bias = torch.from_numpy(bias).bfloat16().float().numpy()
    jm = jnn.Conv(cout, (k, k), strides=c["stride"], padding=((p, p), (p, p)),
                  kernel_dilation=c["dilation"], feature_group_count=c["groups"],
                  use_bias=c["bias"], dtype=jnp.bfloat16 if c["dtype"] == torch.bfloat16
                  else jnp.float32)
    params = {"kernel": jnp.asarray(kernel), **({"bias": jnp.asarray(bias)} if c["bias"] else {})}
    qp, n = jq.quantize_params(params, select=J_ALL)
    assert n == 1
    x = randn(3, 2, 9, 9, cin)
    want = jq.quantized_apply(jm, {"params": qp}, jnp.asarray(x))

    conv = nn.Conv2d(cin, cout, k, stride=c["stride"], padding=p, dilation=c["dilation"],
                     groups=c["groups"], bias=c["bias"])
    with torch.no_grad():
        conv.weight.copy_(_torch_weight(kernel))
        if c["bias"]:
            conv.bias.copy_(torch.from_numpy(bias))
    conv = conv.to(c["dtype"])
    m = quant.Int8Conv2d(conv)
    xt = nhwc_to_nchw(x)
    got = m(xt)
    assert got.dtype == c["dtype"] and got.shape[1:] == (cout, *want.shape[1:3])

    jxq, js = jq._quantize_activation(jnp.asarray(x))
    xq, s = quant.quantize_activation(xt)
    np.testing.assert_array_equal(nchw_to_nhwc(xq), np.asarray(jxq))
    assert s.item() == float(js)
    dn = jax.lax.conv_dimension_numbers(x.shape, qp["kernel_q"].shape, ("NHWC", "HWIO", "NHWC"))
    jacc = jax.lax.conv_general_dilated(
        jxq, qp["kernel_q"], (c["stride"],) * 2, ((p, p), (p, p)),
        rhs_dilation=(c["dilation"],) * 2, dimension_numbers=dn,
        feature_group_count=c["groups"], preferred_element_type=jnp.int32)
    acc = quant.conv_int8_accumulate(xq, m.weight_q, m.stride, m.padding, m.dilation, m.groups)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    _assert_within_ulp(got, np.moveaxis(np.asarray(want.astype(jnp.float32)), -1, 1),
                       c["dtype"])


def test_int8_linear_matches_jax():
    """`Int8Linear` against `_dense_int8`: codes, accumulators, outputs
    within 1 fp32 ulp."""
    kernel, bias = _jkernel(4, (32, 48)), 0.1 * randn(5, 48)
    jm = jnn.Dense(48)
    qp, _ = jq.quantize_params({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)},
                               select=J_ALL)
    x = randn(6, 2, 5, 32)
    want = np.asarray(jq.quantized_apply(jm, {"params": qp}, jnp.asarray(x)))
    lin = nn.Linear(32, 48)
    with torch.no_grad():
        lin.weight.copy_(_torch_weight(kernel))
        lin.bias.copy_(torch.from_numpy(bias))
    m = quant.Int8Linear(lin)
    got = m(torch.from_numpy(x))
    xq, s = quant.quantize_activation(torch.from_numpy(x))
    acc = quant.int8_mm(xq.reshape(-1, 32), m.weight_q.t())
    jxq, _ = jq._quantize_activation(jnp.asarray(x))
    jacc = jax.lax.dot_general(jxq, qp["kernel_q"], (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc).reshape(-1, 48))
    _assert_within_ulp(got, want, torch.float32)


def test_int8_module_keeps_fp32_scales_under_a_dtype_cast():
    m = quant.Int8Linear(nn.Linear(32, 16))
    scale = m.weight_scale.clone()
    m.to(torch.bfloat16)
    assert m.dtype == torch.bfloat16 and m.weight_scale.dtype == torch.float32
    assert torch.equal(m.weight_scale, scale) and m.weight_q.dtype == torch.int8
    assert m(torch.randn(2, 32)).dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["self_fused", "cross_fused", "mixed_unfused", "ip_cross"])
def test_attention_int8_projections_match_jax(mode):
    """Fused self-attention qkv, fused cross-attention kv (the codes and
    scales concatenated, one activation scale), only to_q quantized
    (unfused), and the IP-Adapter cross-attention (its to_k_ip/to_v_ip in
    int8 over 4 tokens a sample, M = 8) against JAX's Attention on the same
    weights."""
    cross = mode in ("cross_fused", "ip_cross")
    ip = dict(ip_num_tokens=4) if mode == "ip_cross" else {}
    jattn = JAttention(query_dim=32, heads=2, dim_head=16,
                       cross_attention_dim=48 if cross else None, **ip)
    x, ctx = randn(7, 2, 24, 32), randn(8, 2, 7 + 4 * bool(ip), 48)
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
    params = jattn.init(jax.random.PRNGKey(1), *args)
    jex, ex = ("to_out_0",), ("to_out",)
    if mode == "mixed_unfused":
        jex, ex = ("to_k", "to_v", "to_out_0"), ("to_k", "to_v", "to_out")
    qp, n = jq.quantize_params(params["params"], select=J_ALL, exclude=jex)
    want = np.asarray(jq.quantized_apply(jattn, {"params": qp}, *args))
    attn = to_torch(Attention(32, 2, 16, cross_attention_dim=48 if cross else None, **ip),
                    jax.tree_util.tree_map(np.asarray, params))
    assert quant.quantize_modules(attn, quant.select_all, exclude=ex) == n
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.from_numpy(ctx) if cross else None).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(8, 4, 4), (8, 10, 4), (40, 36, 8), (32, 64, 16)])
def test_int8_mm_padding_is_exact(m, k, n):
    """`pad_for_int_mm` meets `torch._int_mm`'s rules on the card (M > 16,
    K and N multiples of 8, a row-major, b column-major) and the padded
    product, cut back, equals the unpadded int32 product; the CPU wrapper
    is the plain fp64 product, exact."""
    g = torch.Generator().manual_seed(m * k * n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).t()
    ap, bp = quant.pad_for_int_mm(a, b)
    assert ap.shape[0] > 16 and ap.shape[1] % 8 == 0 and bp.shape[1] % 8 == 0
    assert ap.is_contiguous() and bp.t().is_contiguous() and ap.shape[1] == bp.shape[0]
    want = a.int() @ b.int()
    assert torch.equal(quant.int8_mm_plain(ap, bp)[:m, :n], want)
    assert torch.equal(quant.int8_mm(a, b), want)


# -------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def pipes():
    """JAX's and the port's tiny pipelines on the same weights, and an
    exact copy of the port's (enable_int8 is one-way)."""
    unet, up = port_and_jax(UNet2DConditionModel, 0, sample_size=8, **TINY)
    vae, vp = port_and_jax(AutoencoderKL, 2, **TINY_VAE)
    text, tp = port_and_jax(CLIPTextModel, 3, **TINY_TEXT)
    brushnet, bp = port_and_jax(BrushNetModel, 1, conditioning_channels=6, **TINY)
    j = JPipeline(vae=(JVAE(**TINY_VAE), vp), text_encoder=(JCLIP(**TINY_TEXT), tp),
                  tokenizer=JHashTokenizer(vocab_size=1000),
                  unet=(JUNet(sample_size=8, **TINY), up),
                  brushnet=(JBrushNet(conditioning_channels=6, **TINY), bp),
                  depth_conditioning_mode="concat")

    def port():
        return StableDiffusionBrushNetPipeline(
            vae=copy.deepcopy(vae), text_encoder=copy.deepcopy(text),
            tokenizer=HashTokenizer(vocab_size=1000), unet=copy.deepcopy(unet),
            brushnet=copy.deepcopy(brushnet), depth_conditioning_mode="concat", device="cpu")
    exact, q = port(), port()
    with pytest.raises(ValueError, match="no kernels selected"):
        q.enable_int8()               # the default policy selects nothing here
    n = q.enable_int8(select=quant.select_all)
    with pytest.MonkeyPatch.context() as mp:
        # the same function compiled once a shape: 8 s less than op by op
        mp.setattr(jq, "quantize_kernel", jax.jit(jq.quantize_kernel))
        j.enable_int8(select=J_ALL)
    return j, q, exact, n


def _kw(steps=2):
    return dict(_call_kwargs(), num_inference_steps=steps)


def test_enable_int8_raises_when_nothing_is_selected(pipes):
    _, q, exact, n = pipes
    with pytest.raises(ValueError, match="no kernels selected"):
        copy.deepcopy(exact).enable_int8()
    unet_layers = sum(isinstance(m, (nn.Conv2d, nn.Linear)) for m in exact.unet.modules())
    bn_layers = sum(isinstance(m, (nn.Conv2d, nn.Linear)) for m in exact.brushnet.modules())
    excluded = sum(isinstance(m, nn.Linear) and "time_emb" in name
                   for mod in (exact.unet, exact.brushnet) for name, m in mod.named_modules())
    assert n == unet_layers + bn_layers - excluded
    assert quant.int8_modules(q.vae) == [] and quant.int8_modules(q.text_encoder) == []


def test_int8_pipeline_matches_jax(pipes):
    """Every kernel quantized, 2 steps, JAX's latents, the deterministic
    encode: the port against JAX's int8 pipeline."""
    j, q, _, _ = pipes
    kw = _kw()
    jkw = dict(kw, latents=jnp.asarray(kw["latents"]))
    ref = np.asarray(j(**jkw, output_type="latent"))
    got = q(**kw, output_type="latent")
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4, np.abs(got - ref).max()
    got8, ref8 = (np.round(np.clip(x / 2 + 0.5, 0, 1) * 255).astype(int) for x in (got, ref))
    assert np.abs(got8 - ref8).max() <= 1


def test_int8_is_deterministic_and_near_exact(pipes):
    _, q, exact, _ = pipes
    kw = _kw()
    a, b = q(**kw), q(**kw)
    np.testing.assert_array_equal(a, b)
    e = exact(**kw)
    assert a.shape == e.shape and a.dtype == np.uint8
    assert np.abs(a.astype(int) - e.astype(int)).mean() < 16.0


@pytest.mark.parametrize("mode", ["deep_cache", "encoder_reuse"])
def test_int8_composes_with_cached_modes_and_per_step(pipes, mode):
    """DeepCache and encoder reuse over the int8 modules run and differ
    from the full int8 path; `dispatch="per_step"` gives the same bits."""
    _, q, _, _ = pipes
    kw = _kw(3)
    base = q(**kw, output_type="latent")
    getattr(q, f"enable_{mode}")(2)
    try:
        cached = q(**kw, output_type="latent")
    finally:
        getattr(q, f"disable_{mode}")()
    assert cached.shape == base.shape and np.isfinite(cached).all()
    assert np.abs(cached - base).max() > 0
    np.testing.assert_array_equal(q(**kw, output_type="latent", dispatch="per_step"), base)
