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
at most a rounding boundary: 2 bf16 ulps (2^-6 relative).
"""

import math

import pytest
import torch

from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn

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
    ((1, 2056, 2, 40), torch.float32),
    ((1, 2048, 1, 160), torch.float32),
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
    assert fa.flash_attention_fwd.launches_by_shape[(shape, str(dtype)[6:])] >= 1


def test_flash_reads_fused_qkv_slices(cuda):
    """q/k/v as column slices of one (B, T, 3·H·D) projection, read in place."""
    b, t, h, d = 2, 2048, 4, 40
    qkv = torch.randn(b, t, 3 * h * d, device=cuda, dtype=torch.bfloat16)
    q, k, v = (x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    out, _ = fa.flash_attention_fwd(q, k, v)
    ref = fa.attention_plain(q, k, v)
    assert_flash_close(out, ref, torch.bfloat16)


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


def test_groupnorm_wrapper_raises_on_non_contiguous(cuda):
    x = torch.randn(2, 64, 8, 8, device=cuda).transpose(2, 3)
    w = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu_fwd(x, w, w, 32, 1e-5)
    x = torch.randn(2, 64, 8, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        gn.group_norm_silu_fwd(x, w.half(), w.half(), 32, 1e-5)
