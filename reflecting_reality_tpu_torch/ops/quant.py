"""W8A8 int8 serving mode (counterpart of `reflecting_reality_tpu/ops/quant.py`).

The scheme is the JAX package's, term for term:
- weights: per-output-channel symmetric int8, quantized once ahead of time
  (`quantize_modules`); the float weight is dropped;
- activations: one dynamic symmetric int8 scale per call, the absmax over
  the whole tensor, batch included, so both CFG halves and every request of
  a server batch share it;
- int32 accumulation, dequantized as `y.float() * (s_x * s_w)`, the bias
  added in fp32, the result cast to the module's dtype.

`quantize_modules` replaces each selected `nn.Conv2d` / `nn.Linear` in place
with an `Int8Conv2d` / `Int8Linear` (the JAX package rewrites the param tree
and intercepts `nn.Conv`/`nn.Dense` instead).  The attention q/k/v
projections are `Int8Linear`s too, and `ops.attention.Attention` fuses them
into one int8 product when all of a group are quantized (JAX :185-194).

The integer products go through `int8_mm`: `torch._int_mm` (cuBLASLt) on the
card.  They are XLA `dot_general`s in JAX, not Pallas kernels, so a library
GEMM is their port.  `torch._int_mm` wants M > 16 and K, N multiples of 8;
`int8_mm` zero-pads the operands to that, which is exact because the
zero-point is 0.  A k x k convolution is one GEMM over an im2col of the int8
activation (K = kh*kw*cin, in (ky, kx, c) order) where JAX sums kh*kw
shifted GEMMs: integer accumulation is exact in any order, so the int32
results are equal, in one launch instead of kh*kw products and adds.
Dilated or grouped convolutions (none in SD-1.5) take JAX's generic branch
as an fp64 convolution over the int8 codes, which is exact: every partial
sum is an integer below 2^53.

On CPU tensors `int8_mm` computes its plain version, an fp64 product (exact
for the same reason, and on BLAS).  Scales stay on the device: no call
reads a value back to the host.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

QKERNEL = "weight_q"
QSCALE = "weight_scale"

# int8 symmetric range; 127 (not 128) keeps the grid symmetric around 0
_QMAX = 127.0

# Timestep conditioning stays exact (JAX :82-88): these MLPs are tiny (M =
# batch) and their output shifts every feature map in the net.  Matched as
# substrings of module-path components, as `quantize_params` matches them.
DEFAULT_EXCLUDE = ("time_embedding", "time_emb_proj", "add_embedding", "class_embedding")


def _geometry(weight: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(reduction, output) size of a Linear (out, in) or Conv2d (cout, cin,
    kh, kw) weight: JAX's kernel geometry, in torch layout."""
    if weight.dim() == 2:
        return weight.shape[1], weight.shape[0]
    if weight.dim() == 4:
        cout, cin, kh, kw = weight.shape
        return kh * kw * cin, cout
    return None


def default_select(weight: torch.Tensor) -> bool:
    """JAX's policy (:48-58): reduction >= 256 and at least 64 outputs."""
    geom = _geometry(weight)
    return geom is not None and geom[0] >= 256 and geom[1] >= 64


def select_all(weight: torch.Tensor) -> bool:
    """Every conv and dense weight, whatever its size (JAX :61-69): the
    quality policy of the tiny test configs."""
    return weight.dim() in (2, 4)


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (dim 0) symmetric int8 codes and fp32 scales,
    bit-equal to JAX's `quantize_kernel` on the same values."""
    w = weight.detach().float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = torch.clamp(amax, min=1e-12) / _QMAX
    codes = torch.round(w / scale.view(-1, *(1,) * (w.dim() - 1)))
    return torch.clamp(codes, -_QMAX, _QMAX).to(torch.int8), scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One symmetric int8 scale for the whole tensor (JAX
    `_quantize_activation`) -> (codes, 0-d fp32 scale on x's device)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(), min=1e-12) / _QMAX
    return torch.clamp(torch.round(xf / s), -_QMAX, _QMAX).to(torch.int8), s


# ------------------------------------------------------------- int8 GEMM

def _up8(n: int) -> int:
    return -(-n // 8) * 8


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 as an fp64 product: every
    partial sum is an integer below 2^53 (|a b| <= 127^2 K), so it is exact."""
    return (a.double() @ b.double()).to(torch.int32)


def pad_for_int_mm(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Operands for `torch._int_mm`: zero-padded to M >= 17 and K, N
    multiples of 8 where they fall short (the zero-point is 0, so the
    padding adds nothing), `a` row-major and `b` column-major (`b.t()`
    contiguous), the layout cuBLASLt's int8 GEMM takes."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _up8(k), _up8(n)
    if (mp, kp) != (m, k) or not a.is_contiguous():
        a = F.pad(a, (0, kp - k, 0, mp - m))
    bt = b.t()
    if (np_, kp) != (n, k) or not bt.is_contiguous():
        bt = F.pad(bt, (0, kp - k, 0, np_ - n))
    return a, bt.t()


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32.

    On the card: `torch._int_mm` on `pad_for_int_mm`'s operands; each launch
    adds one to `int8_mm.launches` and to `int8_mm.launches_by_shape[(M, K,
    N)]` (padded).  On the CPU: `int8_mm_plain`."""
    if not a.is_cuda:
        return int8_mm_plain(a, b)
    m, n = a.shape[0], b.shape[1]
    a, b = pad_for_int_mm(a, b)
    y = torch._int_mm(a, b)
    int8_mm.launches += 1
    int8_mm.launches_by_shape[(a.shape[0], a.shape[1], b.shape[1])] += 1
    return y if y.shape == (m, n) else y[:m, :n]


int8_mm.launches = 0
int8_mm.launches_by_shape = collections.Counter()


def dequantize(y: torch.Tensor, s_x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """int32 accumulators -> `y.float() * (s_x * scale) [+ bias.float()]` in
    the module's dtype, in JAX's order of operations."""
    out = y.float() * (s_x * scale)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


# ------------------------------------------------------------- the layers

def dense_int8(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """`_dense_int8`: x (..., in) against (out, in) codes."""
    xq, s_x = quantize_activation(x)
    y = int8_mm(xq.reshape(-1, x.shape[-1]), weight_q.t())
    return dequantize(y, s_x, scale, bias, dtype).view(*x.shape[:-1], weight_q.shape[0])


def conv_int8_accumulate(xq: torch.Tensor, weight_q: torch.Tensor, stride=(1, 1),
                         padding=(0, 0), dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """int8 codes (B, cin, H, W) convolved with (cout, kh, kw, cin/groups)
    codes -> int32 accumulators (B, OH, OW, cout), NHWC as in JAX."""
    cout, kh, kw, _ = weight_q.shape
    b, cin, h, w = xq.shape
    if tuple(dilation) != (1, 1) or groups != 1 or isinstance(padding, str):
        # JAX's generic branch (:183-191): exact as an fp64 convolution
        y = F.conv2d(xq.double(), weight_q.permute(0, 3, 1, 2).double(), None, stride,
                     padding, dilation, groups)
        return y.to(torch.int32).permute(0, 2, 3, 1)
    xh = xq.permute(0, 2, 3, 1)                           # NHWC
    (sy, sx), (pt, pl) = tuple(stride), tuple(padding)
    oh, ow = (h + 2 * pt - kh) // sy + 1, (w + 2 * pl - kw) // sx + 1
    if (kh, kw, sy, sx, pt, pl) == (1, 1, 1, 1, 0, 0):
        a = xh.reshape(-1, cin)
    else:
        # im2col in (ky, kx, c) order, the order of weight_q's rows
        xp = F.pad(xh, (0, 0, pl, pl, pt, pt))
        cols = [xp[:, ky:ky + sy * (oh - 1) + 1:sy, kx:kx + sx * (ow - 1) + 1:sx]
                for ky in range(kh) for kx in range(kw)]
        a = torch.stack(cols, dim=3).reshape(b * oh * ow, kh * kw * cin)
    return int8_mm(a, weight_q.reshape(cout, -1).t()).view(b, oh, ow, cout)


def conv_int8(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], dtype: torch.dtype, stride=(1, 1),
              padding=(0, 0), dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """`_conv_int8` in NCHW: x (B, cin, H, W) -> (B, cout, OH, OW) in `dtype`."""
    xq, s_x = quantize_activation(x)
    y = conv_int8_accumulate(xq, weight_q, stride, padding, dilation, groups)
    return dequantize(y, s_x, scale, bias, dtype).permute(0, 3, 1, 2).contiguous()


class _Int8Module(nn.Module):
    """Codes (`weight_q`, int8) and per-output-channel scales
    (`weight_scale`, fp32) as buffers, the float layer's bias, and the
    layer's dtype, which the output takes.  `.to(device)` moves them;
    `.to(dtype)` changes the output dtype and the bias, never the codes or
    the fp32 scales."""

    def _init(self, layer: nn.Module, weight_q: torch.Tensor, scale: torch.Tensor) -> None:
        self.register_buffer(QKERNEL, weight_q)
        self.register_buffer(QSCALE, scale)
        self.bias = layer.bias
        self.dtype = layer.weight.dtype

    def _apply(self, fn, recurse=True):
        scale = self.weight_scale
        self.dtype = fn(torch.empty(0, dtype=self.dtype, device=scale.device)).dtype
        super()._apply(fn, recurse)
        self._buffers[QSCALE] = scale.to(self.weight_scale.device)
        return self


class Int8Linear(_Int8Module):
    """An `nn.Linear` in W8A8 (`_dense_int8`); `weight_q` is (out, in)."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self._init(linear, *quantize_kernel(linear.weight))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_int8(x, self.weight_q, self.weight_scale, self.bias, self.dtype)


class Int8Conv2d(_Int8Module):
    """An `nn.Conv2d` in W8A8 (`_conv_int8`); `weight_q` is (cout, kh, kw,
    cin/groups), the GEMM layout: its rows are the output channels."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        if conv.padding_mode != "zeros":
            raise ValueError(f"int8 conv with padding_mode={conv.padding_mode!r}")
        wq, scale = quantize_kernel(conv.weight)
        self._init(conv, wq.permute(0, 2, 3, 1).contiguous(), scale)
        self.stride, self.padding, self.dilation, self.groups = (
            conv.stride, conv.padding, conv.dilation, conv.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_int8(x, self.weight_q, self.weight_scale, self.bias, self.dtype,
                         self.stride, self.padding, self.dilation, self.groups)


def quantize_modules(root: nn.Module, select: Callable[[torch.Tensor], bool] = default_select,
                     exclude: Iterable[str] = DEFAULT_EXCLUDE) -> int:
    """Replace every selected `nn.Conv2d` / `nn.Linear` under `root` in place
    by its int8 counterpart (JAX `quantize_params`): selected by `select` on
    its weight, kept exact under a module-path component that contains a
    name in `exclude`.  -> the number replaced."""
    exclude = tuple(exclude)
    count = 0
    for prefix, parent in list(root.named_modules()):
        for name, child in list(parent.named_children()):
            if not isinstance(child, (nn.Conv2d, nn.Linear)) or not select(child.weight):
                continue
            path = (prefix.split(".") if prefix else []) + [name]
            if any(e in p for p in path for e in exclude):
                continue
            cls = Int8Conv2d if isinstance(child, nn.Conv2d) else Int8Linear
            setattr(parent, name, cls(child))
            count += 1
    return count


def int8_modules(root: nn.Module):
    """(name, module) of every int8 layer under `root`."""
    return [(n, m) for n, m in root.named_modules() if isinstance(m, _Int8Module)]
