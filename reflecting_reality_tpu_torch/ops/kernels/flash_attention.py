"""Flash-attention forward on Hopper: the port of TPU kernel B1.

Replaces `reflecting_reality_tpu/ops/pallas/flash_attention.py::_fwd_kernel`
(launched by `_flash_fwd`, `pl.pallas_call` at :130).  The kernel is CUDA C++
for sm_90a in `csrc/flash_attn_fwd.cu`, built by nvcc into a shared library
with a plain C interface and called through ctypes.

What bounds it on the H100: at the UNet level-0 self-attention (B=2, T=4096,
H=8, D=40, bf16) the work is 4·B·H·T²·D ≈ 4.3e10 FLOP against 10.5 MB of
q/k/v/o, so the tensor cores (989 TFLOP/s) bind, not memory (about 43 µs
against 3 µs).  With D=40 the exponentials (B·H·T² = 2.7e8) are the other
wall: the MUFU unit does far fewer of them per cycle than the tensor cores
do MACs.  What the design does about it: Q Kᵀ and P V run on the tensor
cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) and the logits never
leave registers; D pads only to the MMA depth (40 -> 48) inside shared
memory instead of to the TPU's 128 lanes; the softmax runs in the log2
domain, one exp2 per logit.  wgmma, TMA and a pipelined K/V ring are later
work.

`flash_attention_fwd` is the wrapper: it checks device, dtype, shape and
strides, raises on anything the kernel does not take (head dims past 160
among them: no model of the port meets one), launches, and counts launches
in `flash_attention_fwd.launches` and, per (shape, dtype) of q, in
`flash_attention_fwd.launches_by_shape`.  `flash_attention` routes by
device: CPU tensors go to `attention_plain` (the einsum path of
`reflecting_reality_tpu/ops/attention.py:69-72`), CUDA tensors to the kernel.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Tuple

import torch

from reflecting_reality_tpu_torch.ops.kernels import build

SOURCE = "reflecting_reality_tpu_torch/ops/kernels/csrc/flash_attn_fwd.cu"
REPLACES = "reflecting_reality_tpu/ops/pallas/flash_attention.py:81"

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_D = 160  # MAX_D in csrc/flash_attn_fwd.cu


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    return_lse: bool = False):
    """Einsum attention over (B, T, H, D): fp32 logits and softmax, probs cast
    to q.dtype before P V (the JAX `dot_product_attention` numerics)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh = q.permute(0, 2, 1, 3).float()                 # (B, H, Tq, D)
    kh = k.permute(0, 2, 3, 1).float()                 # (B, H, D, Tk)
    logits = torch.matmul(qh, kh) * scale              # (B, H, Tq, Tk) fp32
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v.permute(0, 2, 1, 3))   # (B, H, Tq, D)
    out = out.permute(0, 2, 1, 3)
    if return_lse:
        b, h, tq, _ = logits.shape
        return out, torch.logsumexp(logits, dim=-1).reshape(b * h, tq)
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn_fwd")
    if not getattr(lib, "_rr_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rr_flash_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                          ll, ll, ll, ll, ll, ll, ll, ll,
                                          ctypes.c_float, p]
        lib.rr_flash_attn_fwd.restype = i
        lib._rr_typed = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_fwd takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share one device")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention_fwd takes bf16 or fp32 q/k/v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected (B, T, H, D) q and equal k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d % 8 or d > _MAX_D:
        raise ValueError(f"head dim {d} not taken (needs D % 8 == 0 and D <= {_MAX_D})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or x.stride(2) != d:
            raise ValueError(f"{name} needs packed (H, D) dims, got strides {x.stride()}")
        if q.dtype == torch.bfloat16 and (
                x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16):
            raise ValueError(f"{name} rows must be 16-byte aligned for the bf16 kernel")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 on (B, T, H, D) CUDA tensors -> (out in q.dtype, lse fp32 (B·H, Tq))."""
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rr_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, tq, tk, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            1.0 / math.sqrt(d), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_shape[(tuple(q.shape), str(q.dtype)[6:])] += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_shape = Counter()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (B, T, H, D): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return flash_attention_fwd(q, k, v)[0]
