"""GroupNorm(+SiLU) on Hopper in CUDA C++: the port of TPU kernel B2.

Replaces `reflecting_reality_tpu/ops/pallas/groupnorm.py::_gn_kernel`
(launched by `group_norm_silu_pallas`, `pl.pallas_call` at :95).  The kernel
is `csrc/groupnorm.cu`, built by nvcc into a shared library with a plain C
interface and called through ctypes (a few microseconds of host time per
launch, where the earlier Triton kernels' launcher took tens).

What bounds it on the H100: bytes.  The work is about ten operations per
element against two bytes read and two written (bf16), far below the ~295
operations per byte at which the tensor cores would be the limit; the least
time is one read of x and one write of y at 3.35 TB/s (the UNet's
(2, 320, 64, 64) bf16 activation: 5.2 MB, about 1.6 µs; the VAE decoder's
(1, 128, 512, 512): 67 MB, about 20 µs).

What the design does about it (see the source note): a (b, group) span of
the contiguous NCHW input is N = (C / G) · H · W elements.
- Single-pass regime, N ≤ `CLUSTER_MAX` · `SLICE_MAX` = 131072: every UNet
  and BrushNet norm at 512² (the largest, the up-blocks' 960- and
  640-channel resnet inputs at 64², are 122880 and 81920 elements).  The
  span is cut into at most 8 slices, one CTA each, forming one thread-block
  cluster; each CTA reads its slice once into shared memory, forms a
  (count, mean, M2) partial, the partials are merged by Chan's rule in rank
  order through distributed shared memory, and each CTA writes its slice of
  y.  One launch, x read once.
- Split regime, longer spans (most of the VAE's groups at 128² and up): slices of
  `SLICE_MAX` elements as independent CTAs, a statistics launch writing the
  partials and an apply launch merging them (Chan's rule, slice order) and
  writing y; x read twice.
`launch_plan` picks the regime, the cluster size and the slice bounds from
the shape alone; the C entry point takes its numbers.

`group_norm_silu_fwd` is the wrapper: it checks device, dtype, shape and
contiguity, raises on anything the kernel does not take, launches, and
counts calls that launch (one per norm, whatever the regime) in
`group_norm_silu_fwd.launches` and, per (shape, dtype, SiLU), in
`group_norm_silu_fwd.launches_by_shape`.  Given a fake tensor (the memory
plan of `tools/aot_memory.py`) it allocates its outputs and returns them
without a launch or a count.

`GroupNormSiLU` is the `torch.autograd.Function` for training: B2 forward,
and a backward in plain fp32 PyTorch (`group_norm_bwd_plain`, the closed
form, group statistics recomputed from the saved input).  The JAX package
has no GroupNorm backward kernel (its Pallas GN has no VJP and training
takes the jnp norm), so there is none to port; a backward kernel is
performance work.
`group_norm_silu` routes by device and grad mode: CPU tensors go to
`group_norm_plain` (torch autograd differentiates it), CUDA tensors to
`GroupNormSiLU` when a gradient is needed and straight to B2 when not.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import NamedTuple, Tuple

import torch

from reflecting_reality_tpu_torch.ops.kernels import build

SOURCE = "reflecting_reality_tpu_torch/ops/kernels/csrc/groupnorm.cu"
REPLACES = "reflecting_reality_tpu/ops/pallas/groupnorm.py:33"

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
SLICE_MAX = 16384      # elements one CTA stages in shared memory (SLICE_MAX in the source)
CLUSTER_MAX = 8        # the portable thread-block cluster size
SLICE_TARGET = 2048    # elements per CTA the single-pass regime aims for
_VEC = 8               # elements per 16-byte load in bf16 (4 in fp32): slice alignment
_MAX_GROUP_CHANNELS = 8192  # the kernel's per-channel table (SMEM_ATTR in the source)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float, apply_silu: bool = False) -> torch.Tensor:
    """(B, C, ...) group normalization; fp32 statistics with the two-pass
    variance, result in x.dtype (`reflecting_reality_tpu/ops/norms.py:26-35`)."""
    b, c = x.shape[:2]
    xg = x.reshape(b, num_groups, -1).float()
    mean = xg.mean(dim=-1, keepdim=True)
    var = (xg - mean).square().mean(dim=-1, keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    shape = (1, c) + (1,) * (x.dim() - 2)
    out = xg.reshape(x.shape) * weight.float().reshape(shape) + bias.float().reshape(shape)
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


class LaunchPlan(NamedTuple):
    """How B2 covers each (b, group) span of `span` elements: `regime`
    "cluster" (one launch, the `slices` CTAs of a span form one cluster) or
    "split" (statistics + apply launches); `slice_len` elements per CTA,
    `bounds` the [start, end) of each slice within the span; `vec` whether
    the kernel takes 16-byte loads (span and spatial size multiples of 8)."""
    regime: str
    slices: int
    slice_len: int
    bounds: Tuple[Tuple[int, int], ...]
    vec: bool
    span: int
    hw: int


def launch_plan(shape, num_groups: int) -> LaunchPlan:
    """The regime, cluster size and slice bounds of B2 for a (B, C, *spatial)
    input; pure (no device), the C entry point takes its numbers."""
    c = shape[1]
    hw = math.prod(shape[2:])
    n = (c // num_groups) * hw
    if n <= CLUSTER_MAX * SLICE_MAX:
        regime = "cluster"
        want = min(CLUSTER_MAX, max(2, -(-n // SLICE_TARGET)), -(-n // _VEC))
        slice_len = -(-(-(-n // want)) // _VEC) * _VEC
    else:
        regime = "split"
        slice_len = SLICE_MAX
    slices = -(-n // slice_len)          # no empty slice
    bounds = tuple((r * slice_len, min(n, (r + 1) * slice_len)) for r in range(slices))
    return LaunchPlan(regime, slices, slice_len, bounds, n % _VEC == 0 and hw % _VEC == 0, n, hw)


def _lib() -> ctypes.CDLL:
    lib = build.load("groupnorm")
    if not getattr(lib, "_rr_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rr_group_norm_fwd.argtypes = [p] * 5 + [i] * 12 + [ctypes.c_float, p]
        lib.rr_group_norm_fwd.restype = i
        lib._rr_typed = True
    return lib


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int) -> None:
    if not x.is_cuda:
        raise ValueError("group_norm_silu_fwd takes CUDA tensors")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"group_norm_silu_fwd takes fp32/bf16, got {x.dtype}")
    if x.dim() < 3:
        raise ValueError(f"expected (B, C, *spatial), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu_fwd takes a contiguous (NCHW) tensor")
    c = x.shape[1]
    if c % num_groups or c // num_groups > _MAX_GROUP_CHANNELS:
        raise ValueError(f"{c} channels do not split into {num_groups} groups of at most "
                         f"{_MAX_GROUP_CHANNELS}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (c,) or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"{name} must be a contiguous ({c},) tensor on {x.device}")
        if p.dtype not in _DTYPE_CODE:
            raise TypeError(f"group_norm_silu_fwd takes fp32/bf16 {name}, got {p.dtype}")


@functools.lru_cache(maxsize=None)
def _launch_args(shape, num_groups: int):
    """The plan of a shape and the integers the C entry point takes from it."""
    plan = launch_plan(shape, num_groups)
    return plan, (shape[0] * num_groups, num_groups, plan.span, plan.hw,
                  0 if plan.regime == "cluster" else 1, plan.slices, plan.slice_len)


def group_norm_silu_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        num_groups: int, eps: float, apply_silu: bool = False) -> torch.Tensor:
    """Kernel B2 on a contiguous (B, C, *spatial) CUDA tensor."""
    _check(x, weight, bias, num_groups)
    shape = tuple(x.shape)
    plan, args = _launch_args(shape, num_groups)
    y = torch.empty_like(x)
    partials = (torch.empty((args[0], plan.slices, 2), dtype=torch.float32, device=x.device)
                if plan.regime == "split" else None)
    if build.is_fake(x):        # a memory plan: the outputs, no launch
        return y
    lib = _lib()
    ptr = x.data_ptr()
    launch = (ptr, y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
              partials.data_ptr() if partials is not None else None,
              _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], _DTYPE_CODE[bias.dtype], *args,
              int(plan.vec and ptr % 16 == 0), int(bool(apply_silu)), float(eps))
    err = build.launch(lib.rr_group_norm_fwd, x.device, *launch)
    if err != 0:
        raise RuntimeError(f"groupnorm launch failed: cudaError {err}")
    group_norm_silu_fwd.launches += 1
    group_norm_silu_fwd.launches_by_shape[(shape, str(x.dtype)[6:], bool(apply_silu))] += 1
    return y


group_norm_silu_fwd.launches = 0
group_norm_silu_fwd.launches_by_shape = Counter()


def group_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         dy: torch.Tensor, num_groups: int, eps: float,
                         apply_silu: bool = False):
    """Closed-form gradient of `group_norm_plain` -> (dx, dweight, dbias) in
    the dtypes of x, weight and bias; fp32 throughout, the group statistics
    (two-pass variance) recomputed from x."""
    b, c = x.shape[:2]
    shape = (1, c) + (1,) * (x.dim() - 2)
    xg = x.reshape(b, num_groups, -1).float()
    mean = xg.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xg - mean).square().mean(dim=-1, keepdim=True) + eps)
    xhat = ((xg - mean) * rstd).reshape(x.shape)
    w = weight.float().reshape(shape)
    dz = dy.float()
    if apply_silu:
        z = xhat * w + bias.float().reshape(shape)
        sig = torch.sigmoid(z)
        dz = dz * sig * (1.0 + z * (1.0 - sig))
    reduce_dims = (0,) + tuple(range(2, x.dim()))
    dweight = (dz * xhat).sum(dim=reduce_dims)
    dbias = dz.sum(dim=reduce_dims)
    dxhat = (dz * w).reshape(b, num_groups, -1)
    xhat_g = xhat.reshape(b, num_groups, -1)
    dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - xhat_g * (dxhat * xhat_g).mean(dim=-1, keepdim=True))
    return dx.reshape(x.shape).to(x.dtype), dweight.to(weight.dtype), dbias.to(bias.dtype)


class GroupNormSiLU(torch.autograd.Function):
    """B2 forward, closed-form plain backward (see the module docstring)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, bias, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (num_groups, eps, apply_silu)
        return group_norm_silu_fwd(x, weight, bias, num_groups, eps, apply_silu)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        dx, dweight, dbias = group_norm_bwd_plain(x, weight, bias, dy, *ctx.cfg)
        return dx, dweight, dbias, None, None, None


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float, apply_silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU): the plain version for CPU tensors; for CUDA tensors
    `GroupNormSiLU` when a gradient is needed, else B2 alone."""
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, apply_silu)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return GroupNormSiLU.apply(x, weight, bias, num_groups, eps, apply_silu)
    return group_norm_silu_fwd(x, weight, bias, num_groups, eps, apply_silu)
