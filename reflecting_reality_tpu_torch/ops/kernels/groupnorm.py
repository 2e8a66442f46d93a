"""GroupNorm(+SiLU) on Hopper in Triton: the port of TPU kernel B2.

Replaces `reflecting_reality_tpu/ops/pallas/groupnorm.py::_gn_kernel`
(launched by `group_norm_silu_pallas`, `pl.pallas_call` at :95).

What bounds it on the H100: bytes.  The work is about ten operations per
element against two bytes read and two written (bf16), far below the ~295
operations per byte at which the tensor cores would be the limit; the least
time is one read of x and one write of y at 3.35 TB/s (the UNet's
(2, 320, 64, 64) bf16 activation: 5.2 MB, about 1.6 µs; the VAE decoder's
(1, 128, 512, 512): 67 MB, about 20 µs).

What the design does about it.  The TPU kernel stages a whole sample in VMEM
and runs one grid step per sample; on the card that would leave most of the
132 SMs idle, since a (b, group) span of the contiguous NCHW input is up to
~1M elements.  So the statistics are split:

1. `_gn_stats_kernel`, grid (B·G, chunks): each program reads one chunk of a
   group's span and keeps per-lane Welford (count, mean, M2) in fp32, merged
   across lanes with Chan's rule, and writes one (mean, M2) partial.  The
   TPU kernel's E[x²] − mean² would lose digits on million-element groups
   and would not match `ops/norms.py`'s two-pass variance.
2. `_gn_apply_kernel`, the same grid: each program merges its group's
   partials (Chan's rule again), folds mean, rstd and the affine into one
   per-channel multiply-add, applies it (+SiLU) in fp32 and stores in x's
   dtype.

x is read twice (the second read of a chunk often hits L2) and y written
once.  A group of at most `_FUSED_MAX` elements (every UNet and BrushNet
norm at 512², whose (b, group) spans are at most 40960 elements, and the
VAE's up to 64²) instead takes `_gn_fused_kernel`, grid (B·G,): one program
does both passes over its group, so one launch replaces two; at those sizes
the launch, not the bytes, is the cost.  Fusing into the following conv is
later work.

`group_norm_silu_fwd` is the wrapper: it checks device, dtype, shape and
contiguity, raises on anything the kernel does not take, launches, and
counts calls that launch (one per fused kernel or stats+apply pair) in
`group_norm_silu_fwd.launches` and, per (shape, dtype, SiLU), in
`group_norm_silu_fwd.launches_by_shape`.

`GroupNormSiLU` is the `torch.autograd.Function` for training: B2 forward,
and a backward in plain fp32 PyTorch (`group_norm_bwd_plain`, the closed
form, group statistics recomputed from the saved input).  The JAX package
has no GroupNorm backward kernel (its Pallas GN has no VJP and training
takes the jnp norm), so there is none to port; a Triton backward is
performance work.
`group_norm_silu` routes by device and grad mode: CPU tensors go to
`group_norm_plain` (torch autograd differentiates it), CUDA tensors to
`GroupNormSiLU` when a gradient is needed and straight to B2 when not.
"""

from __future__ import annotations

from collections import Counter

import torch

SOURCE = "reflecting_reality_tpu_torch/ops/kernels/groupnorm.py"
REPLACES = "reflecting_reality_tpu/ops/pallas/groupnorm.py:33"

_DTYPES = (torch.float32, torch.bfloat16)
_BLOCK = 1024
_CHUNK = 8192
_FUSED_MAX = 65536
_KERNELS = {}


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


def _kernels():
    """The Triton kernels, defined on first use (this module must import where
    Triton is absent)."""
    if _KERNELS:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _gn_stats_kernel(x_ptr, mean_ptr, m2_ptr, N, n_chunks,
                         CHUNK: tl.constexpr, BLOCK: tl.constexpr):
        pid_g = tl.program_id(0)
        pid_c = tl.program_id(1)
        base = pid_g.to(tl.int64) * N
        start = pid_c * CHUNK
        cnt = tl.zeros([BLOCK], dtype=tl.float32)
        mean = tl.zeros([BLOCK], dtype=tl.float32)
        m2 = tl.zeros([BLOCK], dtype=tl.float32)
        for off in range(0, CHUNK, BLOCK):
            idx = start + off + tl.arange(0, BLOCK)
            mask = idx < N
            x = tl.load(x_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
            cnt_new = cnt + mask.to(tl.float32)
            delta = x - mean
            mean = mean + tl.where(mask, delta / tl.maximum(cnt_new, 1.0), 0.0)
            m2 = m2 + tl.where(mask, delta * (x - mean), 0.0)
            cnt = cnt_new
        n = tl.sum(cnt, axis=0)
        mean_c = tl.sum(cnt * mean, axis=0) / n
        dm = mean - mean_c
        m2_c = tl.sum(m2, axis=0) + tl.sum(cnt * dm * dm, axis=0)
        out = pid_g * n_chunks + pid_c
        tl.store(mean_ptr + out, mean_c)
        tl.store(m2_ptr + out, m2_c)

    @triton.jit
    def _gn_apply_kernel(x_ptr, y_ptr, w_ptr, b_ptr, mean_ptr, m2_ptr,
                         N, HW, CG, G, n_chunks, eps,
                         CHUNK: tl.constexpr, BLOCK: tl.constexpr,
                         NC_POW2: tl.constexpr, APPLY_SILU: tl.constexpr):
        pid_g = tl.program_id(0)
        pid_c = tl.program_id(1)
        g = pid_g % G
        ci = tl.arange(0, NC_POW2)
        cm = ci < n_chunks
        pm = tl.load(mean_ptr + pid_g * n_chunks + ci, mask=cm, other=0.0)
        pm2 = tl.load(m2_ptr + pid_g * n_chunks + ci, mask=cm, other=0.0)
        pn = tl.where(cm, tl.minimum(N - ci * CHUNK, CHUNK).to(tl.float32), 0.0)
        n = tl.sum(pn, axis=0)
        mean = tl.sum(pn * pm, axis=0) / n
        dm = pm - mean
        var = (tl.sum(pm2, axis=0) + tl.sum(pn * dm * dm, axis=0)) / n
        rstd = 1.0 / tl.sqrt(var + eps)
        base = pid_g.to(tl.int64) * N
        start = pid_c * CHUNK
        for off in range(0, CHUNK, BLOCK):
            idx = start + off + tl.arange(0, BLOCK)
            mask = idx < N
            c = g * CG + idx // HW
            w = tl.load(w_ptr + c, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + c, mask=mask, other=0.0).to(tl.float32)
            mul = rstd * w
            add = b - mean * mul
            x = tl.load(x_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
            y = x * mul + add
            if APPLY_SILU:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def _gn_fused_kernel(x_ptr, y_ptr, w_ptr, b_ptr, N, HW, CG, G, eps,
                         BLOCK: tl.constexpr, APPLY_SILU: tl.constexpr):
        pid_g = tl.program_id(0)
        g = pid_g % G
        base = pid_g.to(tl.int64) * N
        cnt = tl.zeros([BLOCK], dtype=tl.float32)
        mean = tl.zeros([BLOCK], dtype=tl.float32)
        m2 = tl.zeros([BLOCK], dtype=tl.float32)
        for off in range(0, N, BLOCK):
            idx = off + tl.arange(0, BLOCK)
            mask = idx < N
            x = tl.load(x_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
            cnt_new = cnt + mask.to(tl.float32)
            delta = x - mean
            mean = mean + tl.where(mask, delta / tl.maximum(cnt_new, 1.0), 0.0)
            m2 = m2 + tl.where(mask, delta * (x - mean), 0.0)
            cnt = cnt_new
        n = tl.sum(cnt, axis=0)
        mean_g = tl.sum(cnt * mean, axis=0) / n
        dm = mean - mean_g
        var = (tl.sum(m2, axis=0) + tl.sum(cnt * dm * dm, axis=0)) / n
        rstd = 1.0 / tl.sqrt(var + eps)
        for off in range(0, N, BLOCK):
            idx = off + tl.arange(0, BLOCK)
            mask = idx < N
            c = g * CG + idx // HW
            w = tl.load(w_ptr + c, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + c, mask=mask, other=0.0).to(tl.float32)
            mul = rstd * w
            add = b - mean_g * mul
            x = tl.load(x_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
            y = x * mul + add
            if APPLY_SILU:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=mask)

    _KERNELS.update(stats=_gn_stats_kernel, apply=_gn_apply_kernel, fused=_gn_fused_kernel)
    return _KERNELS


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int) -> None:
    if not x.is_cuda:
        raise ValueError("group_norm_silu_fwd takes CUDA tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm_silu_fwd takes fp32/bf16, got {x.dtype}")
    if x.dim() < 3:
        raise ValueError(f"expected (B, C, *spatial), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu_fwd takes a contiguous (NCHW) tensor")
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (c,) or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"{name} must be a contiguous ({c},) tensor on {x.device}")


def group_norm_silu_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        num_groups: int, eps: float, apply_silu: bool = False) -> torch.Tensor:
    """Kernel B2 on a contiguous (B, C, *spatial) CUDA tensor."""
    _check(x, weight, bias, num_groups)
    k = _kernels()
    b, c = x.shape[:2]
    hw = x[0, 0].numel()
    cg = c // num_groups
    n = cg * hw
    bg = b * num_groups
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        if n <= _FUSED_MAX:
            k["fused"][(bg,)](x, y, weight, bias, n, hw, cg, num_groups, float(eps),
                              BLOCK=_BLOCK, APPLY_SILU=bool(apply_silu), num_warps=8)
        else:
            n_chunks = -(-n // _CHUNK)
            mean = torch.empty(bg * n_chunks, dtype=torch.float32, device=x.device)
            m2 = torch.empty_like(mean)
            grid = (bg, n_chunks)
            k["stats"][grid](x, mean, m2, n, n_chunks, CHUNK=_CHUNK, BLOCK=_BLOCK,
                             num_warps=4)
            k["apply"][grid](x, y, weight, bias, mean, m2, n, hw, cg, num_groups, n_chunks,
                             float(eps), CHUNK=_CHUNK, BLOCK=_BLOCK,
                             NC_POW2=_next_pow2(n_chunks), APPLY_SILU=bool(apply_silu),
                             num_warps=4)
    group_norm_silu_fwd.launches += 1
    group_norm_silu_fwd.launches_by_shape[(tuple(x.shape), str(x.dtype)[6:],
                                           bool(apply_silu))] += 1
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
