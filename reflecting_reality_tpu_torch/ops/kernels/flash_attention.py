"""Flash attention on Hopper: the ports of TPU kernels B1 (forward), B3 (dQ)
and B4 (dK/dV).

B1 replaces `reflecting_reality_tpu/ops/pallas/flash_attention.py::_fwd_kernel`
(launched by `_flash_fwd`, `pl.pallas_call` at :130); B3 and B4 replace
`_bwd_dq_kernel` and `_bwd_dkv_kernel` (`_flash_bwd`, calls at :234 and
:250).  The kernels are CUDA C++ for sm_90a in `csrc/flash_attn_fwd.cu` and
`csrc/flash_attn_bwd.cu`, each built by nvcc into a shared library with a
plain C interface and called through ctypes.

What bounds it on the H100: at the UNet level-0 self-attention (B=2, T=4096,
H=8, D=40, bf16) the work is 4·B·H·T²·D ≈ 4.3e10 FLOP against 10.5 MB of
q/k/v/o, so the tensor cores (989 TFLOP/s) bind, not memory (about 43 µs
against 3 µs).  With D=40 the exponentials (B·H·T² = 2.7e8) are the other
wall, and the higher one: the multi-function unit does 16 exp2 per clock
per SM, ~64 µs at the H100's top SM clock.  What the design does about it
(see `csrc/flash_attn_fwd.cu`): a warp-specialised kernel, one producer warp
issuing TMA loads of K/V tiles into a ring of mbarrier-guarded stages and
two consumer warpgroups (128 query rows per CTA) running Q Kᵀ and P V as
wgmma with P kept in registers; a tile's softmax runs while the previous
tile's P V is in the tensor cores, and the two warpgroups take turns at the
softmax, so the exponentials overlap the products.  q/k/v are read in place through 4-D
tensor maps (D, H, T, B) whose 16-column boxes pad D only to 48 (zeros past
D come from TMA's out-of-bounds fill).  `tma_geometry` is the map's
geometry (dims, byte strides, box) with TMA's alignment rules, checked here
before every launch.

B1's fp32 instance (the test CLI's default dtype and the parity runs) is the
same warp-specialised kernel on the TF32 tensor cores, each product three
passes over operands split into TF32 hi and lo parts (hi·lo + lo·hi +
hi·hi, "3xTF32"), which keeps fp32 accuracy where one TF32 pass would miss
the fp32 tolerances tenfold.  That is 3 · 4·B·H·T²·D FLOP (0.26 ms at (2,
4096, 8, 40) at 495 TFLOP/s, against 0.64 ms for the same work on the
CUDA cores), so the tensor cores bind.  The producer warpgroup's other
three warps split Q and K into hi and lo and write V transposed (TF32
wgmma takes no MN-major operand), its keys permuted within each group of 8
so that the S accumulator already is P's A fragment; its 8-column fp32
slabs keep D = 40 unpadded.  `fwd_f32_plan` is each fp32 instance's tiling,
the mirror of the source's `F32Cfg`, held against the library by
`chip_smoke.py`.

The backward (B3 + B4) does 7·B·H·Tq·Tk·D multiply-adds (3 products in B3,
4 in B4) against 4 reads of (B, T, H, D) per kernel and 3 writes: at the
training shape (4, 4096, 8, 40) bf16 that is 3.0e11 FLOP (0.30 ms at 989
TFLOP/s) against ~75 MB (22 µs), so it is bound by operations, and at
D = 40 as much by the 2·B·H·T² exponentials of the two recomputations of p.
The design is B1's (see `csrc/flash_attn_bwd.cu`): warp-specialised, a TMA
ring of the streamed tiles (K and V for B3, Q and dO with their lse and
delta rows for B4), two consumer warpgroups over 128 rows a CTA whose S and
dP products are wgmma with both operands in shared memory, and whose dQ (B3)
or dK and dV (B4) products are wgmma with p or dS kept in registers; JAX's
two-kernel split, so no atomics are needed and the result is deterministic.
`bwd_plan` is each head-dim instance's tiling (tiles, stages, shared memory,
wgmma widths, TMA boxes, register split), the mirror of the source's
`DqCfg` / `DkvCfg` that the CPU tests check and `chip_smoke.py` holds
against the library.  Their fp32 instances (the training CLI's default
`--mixed_precision no`) carry B1's fp32 design over: 3xTF32 wgmma, the
producer's warps 1-3 splitting each landed tile into hi and lo and writing
the operand a product runs over the rows of transposed (K^T in B3, Q^T and
dO^T in B4, rows permuted within groups of 8 so that the dS accumulator
already is the A fragment), and a fresh accumulator each tile for dQ, dK
and dV; 3 · 7 · 2·B·H·T²·D FLOP, 1.82 ms at (4, 4096, 8, 40) at 495
TFLOP/s.  `bwd_f32_plan` mirrors their `DqF32Cfg` / `DkvF32Cfg`.

`flash_attention_fwd`, `flash_attention_bwd_dq` and `flash_attention_bwd_dkv`
are the wrappers: each checks device, dtype, shape and strides, raises on
anything its kernel does not take (head dims past 160 among them), launches,
and counts launches in `.launches` and, per (shape of q, dtype, key count
Tk), in `.launches_by_shape`.  Given fake tensors (the
memory plan of `tools/aot_memory.py`) they allocate their outputs and
return them without a launch or a count.  `FlashAttention` is the
`torch.autograd.Function` over them (the `_flash` custom VJP of the JAX
package, :281-298): B1 forward saving q, k, v, out and lse; backward the
delta = rowsum(dO∘O) prologue in plain fp32 PyTorch (XLA in JAX, :231),
then B3 and B4.  `flash_attention_bwd_plain` is the plain version of B3 +
B4 (fp32 einsums), for the tests and the chip comparison only.

`flash_attention` routes by device and grad mode: CPU tensors go to
`attention_plain` (the einsum path of `reflecting_reality_tpu/ops/attention.py:69-72`),
which torch autograd differentiates; CUDA tensors go through `FlashAttention`
when a gradient is needed, and straight to B1 when not (the pipeline runs
under `inference_mode`, so serving pays nothing for the backward).
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from reflecting_reality_tpu_torch.ops.kernels import build

SOURCE = "reflecting_reality_tpu_torch/ops/kernels/csrc/flash_attn_fwd.cu"
REPLACES = "reflecting_reality_tpu/ops/pallas/flash_attention.py:81"
BWD_SOURCE = "reflecting_reality_tpu_torch/ops/kernels/csrc/flash_attn_bwd.cu"
DQ_REPLACES = "reflecting_reality_tpu/ops/pallas/flash_attention.py:164"
DKV_REPLACES = "reflecting_reality_tpu/ops/pallas/flash_attention.py:191"

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_D = 160  # MAX_D in csrc/flash_common.cuh
TMA_SLAB_BYTES = 32  # one 32-byte swizzled slab per TMA box (SLAB_BYTES in csrc/flash_common.cuh)
TMA_SLAB = 16   # bf16 head-dim columns per TMA box (SLAB); fp32 boxes take 8
TMA_ROWS = 128  # rows a CTA owns (CTA_BM); streamed tiles are 128, 64 or 32 rows
_PADDED_DIMS = (48, 64, 80, 160)  # the bf16 instances (padded_dim in csrc/flash_common.cuh)
_F32_DIMS = (40, 64, 80, 160)     # the fp32 instances (f32_padded_dim)
SMEM_MAX = 232448  # dynamic shared memory a CTA can take on the H100


def tma_geometry(shape, strides, data_ptr: int, itemsize: int = 2,
                 rows: int = TMA_ROWS) -> dict:
    """The 4-D TMA tensor map of one (B, T, H, D) operand with element
    `strides`: dims (D, H, T, B) innermost first, byte strides of H, T and B,
    and a box of one 32-byte slab (16 bf16 or 8 fp32 columns) x `rows`
    tokens of one head.  Raises ValueError on what TMA cannot take: (H, D)
    not packed, a base address or a byte stride that is not a multiple of
    16, a stride of 2^40 bytes or more, a box wider than 256 rows."""
    b, t, h, d = shape
    sb, st, sh, sd = strides
    if sd != 1 or sh != d:
        raise ValueError(f"the tensor map needs packed (H, D) dims, got strides {tuple(strides)}")
    if data_ptr % 16:
        raise ValueError(f"TMA needs a 16-byte aligned base, got address {data_ptr:#x}")
    byte_strides = (sh * itemsize, st * itemsize, sb * itemsize)
    for name, s in zip(("head", "token", "batch"), byte_strides):
        if s % 16 or not 0 < s < 2 ** 40:
            raise ValueError(f"TMA needs {name} strides that are positive multiples of 16 "
                             f"bytes below 2^40, got {s}")
    if not 0 < rows <= 256:
        raise ValueError(f"a TMA box takes 1 to 256 rows, got {rows}")
    return {"dims": (d, h, t, b), "strides_bytes": byte_strides,
            "box": (TMA_SLAB_BYTES // itemsize, 1, rows, 1)}


def padded_dim(d: int, dims=_PADDED_DIMS) -> int:
    """The padded head dim of the bf16 instance (of the fp32 one with
    `dims=_F32_DIMS`) that takes d, 0 if none does."""
    if d <= 0 or d > _MAX_D or d % 8:
        return 0
    return next(c for c in dims if c >= d)


class FwdF32Plan(NamedTuple):
    """One fp32 head-dim instance of B1, as `F32Cfg` in csrc/flash_attn_fwd.cu
    lays it out: `consumers` warpgroups of 64 query rows (`rows` a CTA),
    `tile` keys per K/V tile, `stages` in the ring, `smem` bytes of dynamic
    shared memory (Q hi and lo, then per stage K, K lo, raw V, V^T hi and
    lo, 4 bytes an element), `ss_n` the N of the S = Q Kᵀ wgmma, `rs_n` the
    N of O += P V, `boxes` the TMA box rows of q, k and v, `threads` of the
    producer and the consumer warpgroups and `regs` their setmaxnreg (None:
    ptxas's own count, no setmaxnreg)."""
    dp: int
    consumers: int
    rows: int
    tile: int
    stages: int
    smem: int
    ss_n: int
    rs_n: int
    boxes: Dict[str, int]
    threads: Tuple[int, int]
    regs: Optional[Tuple[int, int]]


def fwd_f32_plan(d: int) -> FwdF32Plan:
    """The tiling of B1's fp32 instance for head dim d; pure (no device).
    Raises ValueError for a head dim no instance takes."""
    dp = padded_dim(d, _F32_DIMS)
    if not dp:
        raise ValueError(f"head dim {d} not taken (needs D % 8 == 0 and D <= {_MAX_D})")
    nc = 1 if dp == 160 else 2           # Q hi and lo of 128 rows at 160 would take 160 KB
    rows = 64 * nc
    tile = {40: 64, 64: 64, 80: 32, 160: 16}[dp]
    stages = 3 if dp == 40 else 2
    smem = 2 * rows * dp * 4 + 5 * stages * tile * dp * 4 + 256 + 1024
    return FwdF32Plan(dp, nc, rows, tile, stages, smem, tile, dp,
                      {"q": rows, "k": tile, "v": tile}, (128, 128 * nc),
                      (56, 224) if nc == 2 else None)


class BwdPlan(NamedTuple):
    """One bf16 head-dim instance of B3 ("dq") or B4 ("dkv"), as `DqCfg` /
    `DkvCfg` in csrc/flash_attn_bwd.cu lay it out: `tile` keys per streamed
    K/V tile (B3) or queries per Q/dO tile (B4), `stages` in the TMA ring,
    `smem` bytes of dynamic shared memory, `ss_n` the N of its wgmma_ss
    products (S and dP, or their transposes), `rs_n` the N of its wgmma_rs
    products (dQ, or dK and dV), `boxes` the TMA box rows of each operand,
    and the `threads` and `regs` (setmaxnreg) of the producer and the
    consumer warpgroups."""
    kernel: str
    dp: int
    tile: int
    stages: int
    smem: int
    ss_n: int
    rs_n: int
    boxes: Dict[str, int]
    threads: Tuple[int, int]
    regs: Tuple[int, int]


def bwd_plan(d: int) -> Dict[str, BwdPlan]:
    """The tiling of B3 and B4 for head dim d -> {"dq": ..., "dkv": ...};
    pure (no device).  Raises ValueError for a head dim no instance takes."""
    dp = padded_dim(d)
    if not dp:
        raise ValueError(f"head dim {d} not taken (needs D % 8 == 0 and D <= {_MAX_D})")
    rows, slack = TMA_ROWS, 256 + 1024   # the mbarriers, and the 1 KB alignment of the base
    split = dict(threads=(128, 256), regs=(24, 240))
    bn = 128 if dp <= 64 else 64         # S and dP of 64 x bn beside dQ and dS in registers
    stages = 3 if dp == 160 else 4
    dq = BwdPlan("dq", dp, bn, stages, 2 * rows * dp * 2 + 2 * stages * bn * dp * 2 + slack,
                 bn, dp, {"q": rows, "do": rows, "k": bn, "v": bn}, **split)
    bq = 32 if dp == 160 else 64         # dK and dV alone take dp registers
    stages = 4
    dkv = BwdPlan("dkv", dp, bq, stages,
                  2 * rows * dp * 2 + stages * (2 * bq * dp * 2 + 2 * bq * 4) + slack,
                  bq, dp, {"k": rows, "v": rows, "q": bq, "do": bq, "lse": bq, "delta": bq},
                  **split)
    return {"dq": dq, "dkv": dkv}


class BwdF32Plan(NamedTuple):
    """One fp32 head-dim instance of B3 ("dq") or B4 ("dkv"), as `DqF32Cfg`
    / `DkvF32Cfg` in csrc/flash_attn_bwd.cu lay it out: `consumers`
    warpgroups over `rows` rows a CTA owns (query rows in B3, keys in B4),
    each owning `cols` output columns (B4 at DP >= 80: two warpgroups share
    64 keys and split the columns), `tile` keys per streamed K/V tile (B3)
    or queries per Q/dO tile (B4), `stages` in the ring, `smem` bytes of
    dynamic shared memory, `ss_n` the N of the S and dP products (or their
    transposes), `rs_n` the N of the dQ (or dK and dV) products, `boxes` the
    TMA box rows of each operand (columns of lse and delta), `threads` and
    `regs` (setmaxnreg; None: ptxas's own count) of the producer and the
    consumer warpgroups."""
    kernel: str
    dp: int
    consumers: int
    rows: int
    cols: int
    tile: int
    stages: int
    smem: int
    ss_n: int
    rs_n: int
    boxes: Dict[str, int]
    threads: Tuple[int, int]
    regs: Optional[Tuple[int, int]]


def bwd_f32_plan(d: int) -> Dict[str, BwdF32Plan]:
    """The tiling of B3's and B4's fp32 (3xTF32) instances for head dim d ->
    {"dq": ..., "dkv": ...}; pure (no device).  Raises ValueError for a head
    dim no instance takes."""
    dp = padded_dim(d, _F32_DIMS)
    if not dp:
        raise ValueError(f"head dim {d} not taken (needs D % 8 == 0 and D <= {_MAX_D})")
    slack = 256 + 1024                   # the mbarriers, and the 1 KB alignment of the base
    # B3: Q and dO (hi, lo) of `rows` rows; per stage K, K lo, V, V lo, K^T hi and lo
    nc = 1 if dp == 160 else 2           # S, dP, dS and dQ with its tile sum in registers
    rows = 64 * nc
    bn = {40: 32, 64: 32, 80: 16, 160: 8}[dp]
    stages = 4 if dp == 40 else 2
    dq = BwdF32Plan("dq", dp, nc, rows, dp, bn, stages,
                    4 * rows * dp * 4 + 6 * stages * bn * dp * 4 + slack, bn, dp,
                    {"q": rows, "do": rows, "k": bn, "v": bn}, (128, 128 * nc),
                    (56, 224) if nc == 2 else None)
    # B4: K and V (hi, lo); per stage Q, Q lo, dO, dO lo, Q^T and dO^T hi
    # and lo, and lse and delta in 128-byte slots.  dK and dV of 64 keys
    # with their tile sums fit a thread's registers up to DP = 64; above it
    # the two warpgroups share 64 keys and split the columns.
    split = 2 if dp >= 80 else 1
    rows, cols = 128 // split, dp // split
    bq = {40: 32, 64: 16, 80: 16, 160: 8}[dp]
    stages = {40: 3, 64: 2, 80: 3, 160: 1}[dp]
    slot = -(-bq * 4 // 128) * 128
    dkv = BwdF32Plan("dkv", dp, 2, rows, cols, bq, stages,
                     4 * rows * dp * 4 + stages * (8 * bq * dp * 4 + 2 * slot) + slack, bq, cols,
                     {"k": rows, "v": rows, "q": bq, "do": bq, "lse": bq, "delta": bq},
                     (128, 256), (56, 224))
    return {"dq": dq, "dkv": dkv}


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


def _lib(name: str, fns) -> ctypes.CDLL:
    """The library for `csrc/<name>.cu` with argtypes set on its functions;
    `fns` maps each function to its number of stride arguments."""
    lib = build.load(name)
    if not getattr(lib, "_rr_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn, (n_ptr, n_strides) in fns.items():
            f = getattr(lib, fn)
            f.argtypes = [p] * n_ptr + [i] * 6 + [ll] * n_strides + [ctypes.c_float, p]
            f.restype = i
        lib._rr_typed = True
    return lib


def _fwd_lib() -> ctypes.CDLL:
    return _lib("flash_attn_fwd", {"rr_flash_attn_fwd": (5, 8)})


def _bwd_lib() -> ctypes.CDLL:
    return _lib("flash_attn_bwd", {"rr_flash_attn_bwd_dq": (7, 10),
                                   "rr_flash_attn_bwd_dkv": (8, 13)})


def library_bwd_plan(d: int) -> Dict[str, Tuple[int, int, int]]:
    """(tile, stages, smem) of B3 and B4 for head dim d as the built library
    lays them out, to hold `bwd_plan` against."""
    fn = _bwd_lib().rr_flash_attn_bwd_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    plans = {}
    for code, kernel in enumerate(("dq", "dkv")):
        _raise_on(fn(code, d, out), "flash_attn_bwd_plan")
        plans[kernel] = tuple(out)
    return plans


def library_bwd_f32_plan(d: int) -> Dict[str, Tuple[int, int, int, int, int]]:
    """(rows, cols, tile, stages, smem) of B3's and B4's fp32 instances for
    head dim d as the built library lays them out, to hold `bwd_f32_plan`
    against."""
    fn = _bwd_lib().rr_flash_attn_bwd_f32_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    plans = {}
    for code, kernel in enumerate(("dq", "dkv")):
        _raise_on(fn(code, d, out), "flash_attn_bwd_f32_plan")
        plans[kernel] = tuple(out)
    return plans


def library_fwd_f32_plan(d: int) -> Tuple[int, int, int, int]:
    """(rows, tile, stages, smem) of B1's fp32 instance for head dim d as the
    built library lays it out, to hold `fwd_f32_plan` against."""
    fn = _fwd_lib().rr_flash_attn_fwd_f32_plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    _raise_on(fn(d, out), "flash_attn_fwd_f32_plan")
    return tuple(out)


def _strides(*xs: torch.Tensor):
    """Batch and token strides of each (B, T, H, D) tensor, in order."""
    return [s for x in xs for s in (x.stride(0), x.stride(1))]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor,
           who: str = "flash_attention_fwd") -> None:
    """q (B, Tq, H, D), k and v (B, Tk, H, D), and any further tensors shaped
    like q (dO), all on one CUDA device in one dtype with packed (H, D), each
    one a TMA tensor map takes (every kernel reads its operands through TMA)."""
    if not all(x.is_cuda for x in (q, k, v) + more):
        raise ValueError(f"{who} takes CUDA tensors")
    if not all(x.device == q.device for x in (k, v) + more):
        raise ValueError("q, k, v must share one device")
    if q.dtype not in _DTYPE_CODE or not all(x.dtype == q.dtype for x in (k, v) + more):
        raise TypeError(f"{who} takes bf16 or fp32 q/k/v, got "
                        f"{[str(x.dtype) for x in (q, k, v) + more]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected (B, T, H, D) q and equal k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if any(x.shape != q.shape for x in more):
        raise ValueError(f"dO {[tuple(x.shape) for x in more]} must be shaped like q "
                         f"{tuple(q.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d % 8 or d > _MAX_D:
        raise ValueError(f"head dim {d} not taken (needs D % 8 == 0 and D <= {_MAX_D})")
    for name, x in (("q", q), ("k", k), ("v", v)) + tuple(("dO", x) for x in more):
        if x.stride(3) != 1 or x.stride(2) != d:
            raise ValueError(f"{name} needs packed (H, D) dims, got strides {x.stride()}")
        tma_geometry(tuple(x.shape), x.stride(), 0 if build.is_fake(x) else x.data_ptr(),
                     x.element_size())


def _check_rows(q: torch.Tensor, *rows: torch.Tensor) -> None:
    """lse and delta: contiguous fp32 (B·H, Tq) on q's device."""
    b, tq, h, _ = q.shape
    for x in rows:
        if x.dtype != torch.float32 or x.shape != (b * h, tq) or not x.is_contiguous() \
                or x.device != q.device:
            raise ValueError(f"lse/delta must be contiguous fp32 ({b * h}, {tq}) on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)}")


def _count(wrapper, q: torch.Tensor, k: torch.Tensor) -> None:
    wrapper.launches += 1
    wrapper.launches_by_shape[(tuple(q.shape), str(q.dtype)[6:], k.shape[1])] += 1


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 on (B, T, H, D) CUDA tensors -> (out in q.dtype, lse fp32 (B·H, Tq))."""
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    if build.is_fake(q):
        return out, lse
    err = build.launch(
        _fwd_lib().rr_flash_attn_fwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, tq, tk, d, *_strides(q, k, v, out), 1.0 / math.sqrt(d))
    _raise_on(err, "flash_attn_fwd")
    _count(flash_attention_fwd, q, k)
    return out, lse


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor,
                           delta: torch.Tensor) -> torch.Tensor:
    """Kernel B3 on (B, T, H, D) CUDA tensors -> dq in q.dtype."""
    _check(q, k, v, do, who="flash_attention_bwd_dq")
    _check_rows(q, lse, delta)
    b, tq, h, d = q.shape
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if build.is_fake(q):
        return dq
    err = build.launch(
        _bwd_lib().rr_flash_attn_bwd_dq, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), _DTYPE_CODE[q.dtype], b, h, tq, k.shape[1], d,
        *_strides(q, k, v, do, dq), 1.0 / math.sqrt(d))
    _raise_on(err, "flash_attn_bwd_dq")
    _count(flash_attention_bwd_dq, q, k)
    return dq


def _tma_rows(x: torch.Tensor) -> torch.Tensor:
    """lse or delta (B·H, Tq) as rows a TMA map can read: each row a multiple
    of 16 bytes long from a 16-byte aligned base.  x itself when it is so,
    else a copy with each row padded to a multiple of 4 values."""
    tq = x.shape[1]
    if tq % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    out = x.new_zeros((x.shape[0], -(-tq // 4) * 4))
    out[:, :tq] = x
    return out


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor,
                            delta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B4 on (B, T, H, D) CUDA tensors -> (dk, dv) in q.dtype."""
    _check(q, k, v, do, who="flash_attention_bwd_dkv")
    _check_rows(q, lse, delta)
    b, tq, h, d = q.shape
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    if build.is_fake(q):
        return dk, dv
    lse, delta = _tma_rows(lse), _tma_rows(delta)     # B4 reads them through TMA
    err = build.launch(
        _bwd_lib().rr_flash_attn_bwd_dkv, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], b, h, tq,
        k.shape[1], d, *_strides(q, k, v, do, dk, dv), lse.stride(0), 1.0 / math.sqrt(d))
    _raise_on(err, "flash_attn_bwd_dkv")
    _count(flash_attention_bwd_dkv, q, k)
    return dk, dv


for _wrapper in (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.launches_by_shape = Counter()


def flash_attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO∘O) in fp32, as (B·H, Tq) (XLA in JAX, `_flash_bwd` :231)."""
    b, tq, h, _ = out.shape
    delta = (do.float() * out.float()).sum(-1)                # (B, Tq, H)
    return delta.permute(0, 2, 1).reshape(b * h, tq).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor):
    """The plain version of B3 + B4: p recomputed from lse, in fp32 einsums ->
    (dq, dk, dv) in q.dtype."""
    b, tq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, do))   # (B, H, T, D)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    p = torch.exp(s - lse.reshape(b, h, tq, 1))
    delta = flash_attention_delta(out, do).reshape(b, h, tq, 1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, doh)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", doh, vh) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale
    return tuple(x.permute(0, 2, 1, 3).to(q.dtype) for x in (dq, dk, dv))


def _packed(x: torch.Tensor) -> torch.Tensor:
    """x itself when its (H, D) dims are packed, else a contiguous copy (the
    kernels read batch and token strides, not head or channel strides)."""
    return x if x.stride(3) == 1 and x.stride(2) == x.shape[3] else x.contiguous()


class FlashAttention(torch.autograd.Function):
    """B1 forward, B3 + B4 backward (the JAX package's `_flash` custom VJP)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = _packed(do)
        delta = flash_attention_delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (B, T, H, D): the plain version for CPU tensors; for
    CUDA tensors `FlashAttention` when a gradient is needed, else B1 alone."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return flash_attention_fwd(q, k, v)[0]
