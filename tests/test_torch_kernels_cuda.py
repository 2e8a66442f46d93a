"""The port's hand-written kernels against their plain PyTorch versions, on
the card.  Marked `cuda`; each test skips where torch sees no CUDA device.
This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances scale with the output.  Flash attention over randn q/k/v and
thousands of keys gives outputs of order T^-1/2 (max a few tenths at
T=4096), not of order one.  fp32 inputs: summation order only, 1e-4 of the output's max.
bf16 inputs: P and O round to bf16 at other points than in the plain path,
which moves an element by about one ulp: 4 bf16 ulps at the output's max;
and, since a wrong P V fragment or 1/l moves the whole output rather than
one element by an ulp, the relative L2 error is held under 1e-2 (1e-4 in
fp32).  GroupNorm: fp32 at 1e-5 of the output scale; bf16 rounds the same
fp32 value on both sides, so a last-bit difference in the statistics flips
at most a rounding boundary: 2 bf16 ulps (2^-6 relative).  GroupNorm is
checked at every shape of a denoise step (the single-pass cluster regime),
in the split regime and on ragged spans.

The flash backward kernels (B3 dQ, B4 dK/dV) are held to
`flash_attention_bwd_plain` on the same q/k/v/dO and the kernel's own out
and lse, with the forward's tolerances applied to each of dq, dk and dv
(4 bf16 ulps at the gradient's max and a relative L2 error under 1e-2;
fp32 1e-4 of the max and L2 under 1e-4): the kernels round p and dS to
bf16 before the products, as the Pallas kernels do, which moves each
gradient by a few tenths of a per cent.  The autograd Functions are held to
torch autograd of the plain versions at the same tolerances.  A tiny UNet +
BrushNet loss, fp32 with TF32 off, has the same BrushNet gradients on the
card (through the Functions) as on the CPU (plain paths, torch autograd):
1e-4 of the largest gradient, summation order through ~30 layers and back.
"""

import math

import pytest
import torch

from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def assert_flash_close(out, ref, dtype):
    out, ref = out.float(), ref.float()
    scale = ref.abs().max().item()
    bf16 = dtype == torch.bfloat16
    atol = 4 * bf16_ulp(scale) if bf16 else 1e-4 * scale
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)
    rel_l2 = ((out - ref).norm() / ref.norm()).item()
    assert rel_l2 < (1e-2 if bf16 else 1e-4), rel_l2


@pytest.mark.parametrize("shape,dtype", [
    ((2, 4096, 8, 40), torch.bfloat16),
    ((1, 4608, 2, 40), torch.bfloat16),
    ((1, 2048, 2, 80), torch.bfloat16),
    ((1, 2048, 2, 160), torch.bfloat16),
    ((1, 2056, 1, 152), torch.bfloat16),
    ((1, 40, 2, 40), torch.bfloat16),
    ((1, 72, 1, 64), torch.bfloat16),
    ((1, 4608, 24, 128), torch.bfloat16),   # FLUX.1 Fill's joint attention at 1024²
    ((1, 2056, 2, 40), torch.float32),
    ((1, 2048, 1, 160), torch.float32),
    ((2, 4096, 8, 40), torch.float32),      # the test CLI's default step
    ((1, 2056, 1, 152), torch.float32),     # D = 160 instance, ragged rows and columns
    ((1, 72, 1, 64), torch.float32),
])
def test_flash_matches_plain(cuda, shape, dtype):
    g = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda, dtype=dtype) for _ in range(3))
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v)
    ref, ref_lse = fa.attention_plain(q, k, v, return_lse=True)
    assert_flash_close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    assert fa.flash_attention_fwd.launches == before + 1
    assert fa.flash_attention_fwd.launches_by_shape[(shape, str(dtype)[6:], shape[1])] >= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_reads_fused_qkv_slices(cuda, dtype):
    """q/k/v as column slices of one (B, T, 3·H·D) projection, read in place."""
    b, t, h, d = 2, 2048, 4, 40
    qkv = torch.randn(b, t, 3 * h * d, device=cuda, dtype=dtype)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    out, _ = fa.flash_attention_fwd(q, k, v)
    ref = fa.attention_plain(q, k, v)
    assert_flash_close(out, ref, dtype)


@pytest.mark.parametrize("tq,tk,d,dtype", [
    (301, 517, 64, torch.float32),
    (2048, 1000, 40, torch.float32),
    (200, 3000, 160, torch.float32),
    (2056, 77, 80, torch.float32),      # a cross-attention's key count
    (301, 517, 64, torch.bfloat16),
    (200, 3000, 160, torch.bfloat16),
    (4096, 4, 40, torch.bfloat16),      # the IP-Adapter's 4 trailing context tokens
    (4096, 4, 40, torch.float32),
])
def test_flash_fwd_unequal_lengths(cuda, tq, tk, d, dtype):
    """Tq != Tk: query tails in the last CTA, key tails in the last tile."""
    g = torch.Generator(cuda).manual_seed(6)
    q = torch.randn(1, tq, 2, d, generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn(1, tk, 2, d, generator=g, device=cuda, dtype=dtype) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v)
    ref, ref_lse = fa.attention_plain(q, k, v, return_lse=True)
    assert_flash_close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


def test_fwd_f32_plan_is_the_library_tiling(cuda):
    for d in (8, 40, 48, 64, 72, 80, 88, 152, 160):
        p = fa.fwd_f32_plan(d)
        assert fa.library_fwd_f32_plan(d) == (p.rows, p.tile, p.stages, p.smem)


def _randn(cuda, shape, dtype, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda, dtype=dtype) for _ in range(4)]


def _bwd(q, k, v, do):
    """B1, then B3 and B4, -> (kernel grads, plain grads)."""
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.flash_attention_delta(out, do)
    got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
           *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    return got, fa.flash_attention_bwd_plain(q, k, v, out, lse, do)


@pytest.mark.parametrize("shape,dtype", [
    ((4, 4096, 8, 40), torch.bfloat16),     # the training step's shape
    ((2, 4096, 8, 40), torch.bfloat16),
    ((1, 4608, 2, 40), torch.bfloat16),
    ((1, 2056, 2, 40), torch.bfloat16),
    ((1, 2048, 2, 80), torch.bfloat16),
    ((1, 2048, 2, 160), torch.bfloat16),
    ((1, 2056, 1, 152), torch.bfloat16),    # D = 160 instance, ragged rows and columns
    ((1, 72, 1, 64), torch.bfloat16),
    ((1, 4608, 24, 128), torch.bfloat16),   # FLUX.1 Fill's joint attention at 1024²
    ((1, 2056, 2, 40), torch.float32),
    ((1, 2048, 1, 160), torch.float32),
    ((2, 4096, 8, 40), torch.float32),
    ((4, 4096, 8, 40), torch.float32),      # the training CLI's default step
    ((1, 2048, 2, 64), torch.float32),
    ((1, 2048, 2, 80), torch.float32),      # B4: two warpgroups split the columns
    ((1, 2056, 1, 152), torch.float32),     # D = 160 instance, ragged rows and columns
])
def test_flash_bwd_matches_plain(cuda, shape, dtype):
    q, k, v, do = _randn(cuda, shape, dtype)
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    got, ref = _bwd(q, k, v, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert_flash_close(a, b, dtype)
    assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    key = (shape, str(dtype)[6:], shape[1])
    assert fa.flash_attention_bwd_dq.launches_by_shape[key] >= 1
    assert fa.flash_attention_bwd_dkv.launches_by_shape[key] >= 1


@pytest.mark.parametrize("tq,tk,d,dtype", [
    (301, 517, 64, torch.bfloat16),   # lse/delta rows padded for B4's TMA map
    (2048, 1000, 40, torch.bfloat16),
    (200, 3000, 160, torch.bfloat16),
    (301, 517, 64, torch.float32),
    (2048, 1000, 40, torch.float32),
    (200, 3000, 160, torch.float32),
    (4096, 4, 40, torch.bfloat16),    # the IP-Adapter's 4 trailing context tokens
    (4096, 4, 40, torch.float32),
])
def test_flash_bwd_unequal_lengths(cuda, tq, tk, d, dtype):
    """Tq != Tk: query tails in B3's CTAs and B4's tiles, key tails the other way."""
    g = torch.Generator(cuda).manual_seed(4)
    q, do = (torch.randn(1, tq, 2, d, generator=g, device=cuda, dtype=dtype) for _ in range(2))
    k, v = (torch.randn(1, tk, 2, d, generator=g, device=cuda, dtype=dtype) for _ in range(2))
    got, ref = _bwd(q, k, v, do)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert_flash_close(a, r, dtype)


ROUTED_SHORT = pytest.mark.parametrize("tq,tk,d,dtype", [
    (tq, tk, d, dtype) for dtype in (torch.bfloat16, torch.float32) for d in (40, 64, 80, 160)
    for tq in (64, 256, 1024) for tk in (77, tq)])


@ROUTED_SHORT
def test_flash_fwd_at_the_routed_short_shapes(cuda, tq, tk, d, dtype):
    """B1 at what the routing rule sends it beside the 4096-token
    self-attentions: the UNets' cross-attentions to 77 text tokens (one
    ragged key tile) and their self-attentions at 64-1024 tokens (query
    rows past Tq in the last CTA at 64), at every head dim of SD-1.5 and
    SDXL.  The tolerances of `assert_flash_close`: over 77 keys the output
    is of order 77^-1/2, and its bf16 rounding of P and O moves an element
    by about one ulp."""
    g = torch.Generator(cuda).manual_seed(8)
    q = torch.randn(2, tq, 4, d, generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn(2, tk, 4, d, generator=g, device=cuda, dtype=dtype) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v)
    ref, ref_lse = fa.attention_plain(q, k, v, return_lse=True)
    assert_flash_close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    assert fa.flash_attention_fwd.launches_by_shape[((2, tq, 4, d), str(dtype)[6:], tk)] >= 1


@ROUTED_SHORT
def test_flash_bwd_at_the_routed_short_shapes(cuda, tq, tk, d, dtype):
    """B3 + B4 at the same shapes, as training meets them: B4's one CTA of
    128 keys holds 77 (keys past Tk are computed and never stored), B3's
    last key tile is ragged.  The forward's tolerances on each of dq, dk and
    dv (the kernels round p and dS to bf16 before their products, as the
    Pallas kernels do)."""
    g = torch.Generator(cuda).manual_seed(9)
    q, do = (torch.randn(2, tq, 4, d, generator=g, device=cuda, dtype=dtype) for _ in range(2))
    k, v = (torch.randn(2, tk, 4, d, generator=g, device=cuda, dtype=dtype) for _ in range(2))
    got, ref = _bwd(q, k, v, do)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert_flash_close(a, r, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 4096, 8, 40), (1, 2056, 2, 152), (1, 2048, 2, 80)])
def test_flash_bwd_is_deterministic(cuda, shape, dtype):
    """Each output element is summed by one CTA in a fixed order, so two
    launches on the same inputs give the same bits."""
    q, k, v, do = _randn(cuda, shape, dtype, seed=5)
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.flash_attention_delta(out, do)
    first = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
             *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    second = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
              *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_bwd_plan_is_the_library_tiling(cuda):
    for d in (40, 64, 80, 152, 160):
        plan = fa.bwd_plan(d)
        assert fa.library_bwd_plan(d) == {k: (p.tile, p.stages, p.smem) for k, p in plan.items()}


def test_bwd_f32_plan_is_the_library_tiling(cuda):
    for d in (8, 40, 48, 64, 72, 80, 88, 152, 160):
        plan = fa.bwd_f32_plan(d)
        assert fa.library_bwd_f32_plan(d) == {
            k: (p.rows, p.cols, p.tile, p.stages, p.smem) for k, p in plan.items()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_reads_strided_slices(cuda, dtype):
    """q/k/v as column slices of one fused qkv projection and dO as a column
    slice of a wider tensor, all read in place."""
    b, t, h, d = 2, 2048, 4, 40
    qkv = torch.randn(b, t, 3 * h * d, device=cuda, dtype=dtype)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    do = torch.randn(b, t, 2 * h * d, device=cuda, dtype=dtype)[..., :h * d]
    do = do.unflatten(-1, (h, d))
    assert not do.is_contiguous() and not q.is_contiguous()
    got, ref = _bwd(q, k, v, do)
    for a, r in zip(got, ref):
        assert_flash_close(a, r, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_function_grads_match_plain_autograd(cuda, dtype):
    shape = (1, 2048, 2, 40)
    q, k, v, do = _randn(cuda, shape, dtype, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out = fa.flash_attention(*leaves)
    assert out.grad_fn is not None
    out.backward(do)
    fa.attention_plain(*plain).backward(do)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    for a, b in zip(leaves, plain):
        assert_flash_close(a.grad, b.grad, dtype)
    with torch.no_grad():
        assert fa.flash_attention(*leaves).grad_fn is None
    assert fa.flash_attention_bwd_dq.launches == counts[1] + 1


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_groupnorm_function_grads_match_plain_autograd(cuda, dtype, silu):
    g = torch.Generator(cuda).manual_seed(2)
    x = torch.randn(2, 64, 16, 16, generator=g, device=cuda, dtype=dtype) * 2.0 + 0.5
    w = (1.0 + 0.1 * torch.randn(64, generator=g, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(64, generator=g, device=cuda)).to(dtype)
    dy = torch.randn(x.shape, generator=g, device=cuda, dtype=dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    plain = [t.clone().requires_grad_(True) for t in (x, w, b)]
    before = gn.group_norm_silu_fwd.launches
    y = gn.group_norm_silu(*leaves, 32, 1e-5, silu)
    assert y.grad_fn is not None and gn.group_norm_silu_fwd.launches == before + 1
    y.backward(dy)
    gn.group_norm_plain(*plain, 32, 1e-5, silu).backward(dy)
    for a, r in zip(leaves, plain):
        scale = max(1.0, r.grad.float().abs().max().item())
        # fp32: one pass of group sums; bf16: the gradient rounds once to bf16
        # on each side from fp32 values that differ in the last bits
        tol = 1e-4 * scale if dtype == torch.float32 else 2 * 2.0 ** -7 * scale
        torch.testing.assert_close(a.grad.float(), r.grad.float(), rtol=0, atol=tol)


def test_unet_brushnet_gradient_on_card_matches_cpu(cuda):
    """Before the autograd Functions, the card's wrappers returned tensors
    without a grad_fn, so every gradient path through attention and
    GroupNorm was silently dropped; now the card's BrushNet gradients equal
    the CPU's."""
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        torch.manual_seed(0)
        unet = UNet2DConditionModel(
            sample_size=64, block_out_channels=(16, 32), attention_head_dim=2,
            cross_attention_dim=16, norm_num_groups=4, layers_per_block=1,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D")).requires_grad_(False)
        brushnet = BrushNetModel.from_unet(unet, conditioning_channels=5)
        with torch.no_grad():
            for conv in (list(brushnet.brushnet_down_blocks) + [brushnet.brushnet_mid_block]
                         + list(brushnet.brushnet_up_blocks)):
                conv.weight.normal_(0, 0.1)
                conv.bias.normal_(0, 0.1)
        g = torch.Generator().manual_seed(1)
        x, cond = torch.randn(1, 4, 64, 64, generator=g), torch.randn(1, 5, 64, 64, generator=g)
        ehs, target = torch.randn(1, 7, 16, generator=g), torch.randn(1, 4, 64, 64, generator=g)
        t = torch.tensor([321])

        def grads(device):
            u, bn = unet.to(device), brushnet.to(device)
            bn.zero_grad(set_to_none=True)
            args = [a.to(device) for a in (x, t, ehs, cond)]
            down, mid, up = bn(*args)
            pred = u(args[0], args[1], args[2], down_block_add_samples=down,
                     mid_block_add_sample=mid, up_block_add_samples=up)
            ((pred - target.to(device)) ** 2).mean().backward()
            return {n: p.grad.detach().cpu().clone() for n, p in bn.named_parameters()}

        counts = (fa.flash_attention_bwd_dq.launches, gn.group_norm_silu_fwd.launches)
        on_card = grads(cuda)
        # 4 transformer blocks (down block 0 one, the mid block one, up block
        # 1 two), each a self- and a cross-attention, all on BrushNet's path
        assert fa.flash_attention_bwd_dq.launches == counts[0] + 8
        assert gn.group_norm_silu_fwd.launches > counts[1]
        on_cpu = grads(torch.device("cpu"))
        tol = 1e-4 * max(v.abs().max().item() for v in on_cpu.values())
        for n in on_cpu:
            torch.testing.assert_close(on_card[n], on_cpu[n], rtol=0, atol=tol, msg=n)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def test_flash_wrapper_raises_on_what_it_does_not_take(cuda):
    for d in (36, 168, 256):
        q = torch.randn(1, 2048, 1, d, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention_fwd(q, q, q)
    q = torch.randn(1, 2048, 1, 40, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 320, 64, 64), (2, 1280, 8, 8), (1, 128, 512, 512),
                                   (1, 96, 5, 7)])
def test_groupnorm_matches_plain(cuda, shape, dtype, silu):
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda, dtype=dtype) * 3.0 + 1.5
    c = shape[1]
    w = (1.0 + 0.1 * torch.randn(c, generator=g, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(c, generator=g, device=cuda)).to(dtype)
    y = gn.group_norm_silu_fwd(x, w, b, 32, 1e-5, silu)
    ref = gn.group_norm_plain(x, w, b, 32, 1e-5, silu)
    scale = max(1.0, ref.float().abs().max().item())
    tol = 1e-5 * scale if dtype == torch.float32 else 2 * 2.0 ** -7 * scale
    torch.testing.assert_close(y.float(), ref.float(), rtol=0, atol=tol)


# every GroupNorm shape of a denoise step at 512² (BrushNet at batch 1, UNet at
# CFG batch 2; tests/test_torch_kernel_plans.py records them from the modules)
MAIN_PATH_GN_SHAPES = [
    (b, c, s, s) for b in (1, 2) for c, s in (
        (320, 32), (320, 64), (640, 16), (640, 32), (640, 64), (960, 32), (960, 64),
        (1280, 8), (1280, 16), (1280, 32), (1920, 16), (1920, 32), (2560, 8), (2560, 16))]


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", MAIN_PATH_GN_SHAPES + [(1, 128, 256, 256), (1, 96, 5, 7),
                                                         (1, 64, 3, 3)])
def test_groupnorm_matches_plain_at_main_path_shapes(cuda, shape, silu):
    """bf16 at every main-path shape (single-pass cluster regime), a VAE shape
    (split regime) and ragged spans (scalar loads); run twice, bit-identical
    (the cluster merges its partials in a fixed rank order)."""
    g = torch.Generator(cuda).manual_seed(3)
    x = torch.randn(shape, generator=g, device=cuda, dtype=torch.bfloat16) * 3.0 + 1.5
    c = shape[1]
    w = (1.0 + 0.1 * torch.randn(c, generator=g, device=cuda)).to(torch.bfloat16)
    b = (0.1 * torch.randn(c, generator=g, device=cuda)).to(torch.bfloat16)
    plan = gn.launch_plan(shape, 32)
    assert plan.regime == ("split" if shape == (1, 128, 256, 256) else "cluster")
    y = gn.group_norm_silu_fwd(x, w, b, 32, 1e-5, silu)
    assert torch.equal(y, gn.group_norm_silu_fwd(x, w, b, 32, 1e-5, silu))
    ref = gn.group_norm_plain(x, w, b, 32, 1e-5, silu)
    scale = max(1.0, ref.float().abs().max().item())
    torch.testing.assert_close(y.float(), ref.float(), rtol=0, atol=2 * 2.0 ** -7 * scale)


def test_groupnorm_takes_fp32_weights_with_bf16_input(cuda):
    """Under autocast the input is bf16 and the affine parameters fp32."""
    x = torch.randn(2, 320, 64, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.rand(320, device=cuda) + 0.5
    b = torch.randn(320, device=cuda)
    y = gn.group_norm_silu_fwd(x, w, b, 32, 1e-6, True)
    ref = gn.group_norm_plain(x, w, b, 32, 1e-6, True)
    scale = max(1.0, ref.float().abs().max().item())
    torch.testing.assert_close(y.float(), ref.float(), rtol=0, atol=2 * 2.0 ** -7 * scale)


def test_groupnorm_wrapper_raises_on_non_contiguous(cuda):
    x = torch.randn(2, 64, 8, 8, device=cuda).transpose(2, 3)
    w = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu_fwd(x, w, w, 32, 1e-5)
    x = torch.randn(2, 64, 8, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        gn.group_norm_silu_fwd(x, w.half(), w.half(), 32, 1e-5)


# ------------------------------------------------------------ CUDA graphs

GRAPH_PX, GRAPH_STEPS = 512, 4


@pytest.fixture(scope="module")
def graph_pipe():
    """The SD-1.5 pipeline at full width and one resnet a level, bf16 at
    512², BrushNet's zero convs given seeded values; the decoder's pre-hook
    keeps each call's final latents."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from reflecting_reality_tpu_torch.data.tokenizer import HashTokenizer
    from reflecting_reality_tpu_torch.models.brushnet import BrushNetModel
    from reflecting_reality_tpu_torch.models.clip_text import CLIPTextModel
    from reflecting_reality_tpu_torch.models.unet2d import UNet2DConditionModel
    from reflecting_reality_tpu_torch.models.vae import AutoencoderKL
    from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
        StableDiffusionBrushNetPipeline,
    )

    torch.manual_seed(0)
    with torch.device("cuda"):
        unet, vae = UNet2DConditionModel(layers_per_block=1), AutoencoderKL(layers_per_block=1)
        brushnet = BrushNetModel(conditioning_channels=6, layers_per_block=1)
        text = CLIPTextModel()
    g = torch.Generator("cuda").manual_seed(1)
    convs = (list(brushnet.brushnet_down_blocks) + [brushnet.brushnet_mid_block]
             + list(brushnet.brushnet_up_blocks))
    with torch.no_grad():
        for conv in convs:
            for p in (conv.weight, conv.bias):
                p.copy_(torch.randn(p.shape, generator=g, device=p.device) * 0.02)
    pipe = StableDiffusionBrushNetPipeline(
        vae=vae, text_encoder=text, tokenizer=HashTokenizer(vocab_size=49408), unet=unet,
        brushnet=brushnet, depth_conditioning_mode="concat", dtype=torch.bfloat16, device="cuda")
    pipe.final_latents = []       # (a copy, the storage address) a call
    pipe.vae.decoder.register_forward_pre_hook(lambda module, args: pipe.final_latents.append(
        (args[0].clone(), args[0].untyped_storage().data_ptr())))
    return pipe


def _graph_call(pipe, batch: int, seed: int) -> torch.Tensor:
    import numpy as np

    rng = np.random.RandomState(seed)
    mask = np.zeros((batch, GRAPH_PX, GRAPH_PX, 3), np.float32)
    mask[:, 128:384, 160:352] = 1.0
    latents = torch.randn((batch, GRAPH_PX // 8, GRAPH_PX // 8, 4),
                          generator=torch.Generator().manual_seed(seed))
    return pipe([f"a mirror, request {k}" for k in range(batch)],
                image=rng.rand(batch, GRAPH_PX, GRAPH_PX, 3).astype(np.float32), mask=mask,
                depth=rng.rand(batch, GRAPH_PX, GRAPH_PX, 1).astype(np.float32),
                num_inference_steps=GRAPH_STEPS, latents=latents.numpy(),
                deterministic_vae_encode=True, output_type="device")


@pytest.mark.parametrize("batch", [1, 3])
def test_graphed_steps_equal_the_eager_steps(graph_pipe, batch):
    """A 4-step call on graphs against the eager call: the same final
    latents (expected bitwise; held to 1e-3 of their largest value); the
    same B1 and B2 kernels, as often, in a profiler trace, the steps' among
    those the two graph launches a step launch; the wrappers count only the
    launches the host makes, none of a replay's; a second call of the shape
    captures nothing; nothing a call returns or keeps is a graph's output,
    which the next call of its shape overwrites."""
    from chip_smoke import graph_kernels

    pipe, out = graph_pipe, {}
    pipe.disable_cuda_graphs()
    n0 = fa.flash_attention_fwd.launches
    eager_kernels = graph_kernels(torch, lambda: out.update(
        image=_graph_call(pipe, batch, seed=batch)))
    n1 = fa.flash_attention_fwd.launches
    eager_image, eager = out["image"], pipe.final_latents[-1][0]
    pipe.enable_cuda_graphs()
    try:
        _graph_call(pipe, batch, seed=batch)                   # captures the key
        stats = pipe.graph_stats()
        assert stats["captures"] == 2 and stats["eager_steps"] == 0
        n2 = fa.flash_attention_fwd.launches
        replayed = graph_kernels(torch, lambda: out.update(           # replays only
            image=_graph_call(pipe, batch, seed=batch)))
        n3 = fa.flash_attention_fwd.launches
        image = out["image"]
        graphed, graphed_ptr = pipe.final_latents[-1]
        assert pipe.graph_stats() == {"captures": 2, "replays": 4 * GRAPH_STEPS,
                                      "eager_steps": 0}
        assert replayed["graph_launches"] == 2 * GRAPH_STEPS
        assert replayed["all"] == eager_kernels["all"], (replayed, eager_kernels)
        in_graphs = replayed["in_graphs"]
        assert in_graphs.get("flash_fwd_wgmma", 0) > 0 and in_graphs.get("gn_kernel", 0) > 0
        assert n1 - n0 == eager_kernels["all"]["flash_fwd_wgmma"]
        assert n3 - n2 == n1 - n0 - in_graphs["flash_fwd_wgmma"]
        gap = (graphed.float() - eager.float()).abs().max().item()
        assert gap <= 1e-3 * eager.float().abs().max().item(), gap
        print(f"batch {batch}: graphed latents bitwise equal to eager: "
              f"{torch.equal(graphed, eager)}, max gap {gap}; kernels in graphs {in_graphs}")
        assert (image.int() - eager_image.int()).abs().max().item() <= 1

        outputs = [x for fwd in (pipe.unet.forward, pipe.brushnet.forward)
                   for g in fwd.graphs.values()
                   for x in torch.utils._pytree.tree_leaves(g.outputs)]
        ptrs = {x.untyped_storage().data_ptr() for x in outputs}
        assert graphed_ptr not in ptrs
        assert image.untyped_storage().data_ptr() not in ptrs
        kept = image.clone()
        _graph_call(pipe, batch, seed=batch + 100)             # other inputs, same key
        assert torch.equal(image, kept)
        assert pipe.graph_stats()["captures"] == 2
    finally:
        pipe.disable_cuda_graphs()
