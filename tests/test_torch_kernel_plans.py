"""The CPU-side geometry of the port's Hopper kernels: the GroupNorm (B2)
launch plan and its statistics merge, and the flash-forward (B1) TMA tensor
map.  The kernels run only on the card; what surrounds them is pure Python
and is held here.

- `launch_plan` must cover every (b, group) span exactly once with slices of
  at most `SLICE_MAX` elements that start on 16-byte boundaries, and must put
  every GroupNorm of the main path (the full-width SD-1.5 UNet at CFG batch 2
  and BrushNet at half batch, 512², shapes recorded by chip_smoke.py from a
  forward of the port's own modules on the meta device) in the single-pass
  cluster regime with 1-8 CTAs per cluster.  The VAE's long spans take the
  split regime.
- A numpy emulation of the kernel's statistics (per-slice two-pass mean and
  M2 in fp32, merged by Chan's rule in the kernel's order: rank order in a
  cluster, a warp's lanes and then a shuffle tree in the split regime; the
  affine folded into a per-channel multiply-add) matches `group_norm_plain` and the JAX
  `ops/norms.py` path on the same inputs to 1e-6 of the output's largest
  magnitude (fp32 rounding through a different summation order).
- `tma_geometry` accepts the q/k/v column slices of a fused qkv projection
  and rejects a stride or a base address TMA cannot take.
- `fwd_f32_plan`, the tiling of B1's fp32 (3xTF32) instance at every head
  dim the route sends it (8 to 160 in steps of 8), fits the H100 and its
  fp32 TMA boxes (8 columns) are boxes TMA takes on fused-qkv slices.  A
  numpy emulation of that kernel's arithmetic (TF32 hi/lo split by masking,
  three passes a product, V^T's keys permuted within each
  group of 8 to match the S accumulator's order, the log2-domain online
  softmax over the plan's tiles) matches the JAX Pallas kernel in TPU
  interpret mode to 1e-4 of the output's max and 1e-4 in lse; one TF32
  pass on the same inputs does not, which is why the kernel takes three.
- `bwd_plan`, the tiling of the flash backward kernels B3 (dQ) and B4
  (dK/dV) at each bf16 head-dim instance, fits the H100: wgmma widths that
  are multiples of 8 up to 256, shared memory within a CTA's 232,448 bytes,
  a register split within the SM's 65,536; its TMA boxes (a strided dO
  among the operands) are boxes TMA takes.  A numpy emulation of B4's query
  loop shows that the zero-filled query rows past Tq (lse = delta = 0) add
  exactly nothing to dK and dV, and the lse/delta rows are padded for B4's
  map only where TMA needs it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from reflecting_reality_tpu.ops.norms import group_norm as j_group_norm
from reflecting_reality_tpu.ops.pallas import flash_attention as j_fa
from reflecting_reality_tpu_torch.ops.kernels import groupnorm as gn
from reflecting_reality_tpu_torch.ops.kernels import flash_attention as fa
from reflecting_reality_tpu_torch.ops.kernels.flash_attention import tma_geometry
from tests.test_torch_kernels_cuda import MAIN_PATH_GN_SHAPES
from tests.test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

@functools.lru_cache(maxsize=None)
def main_path_norms():
    """chip_smoke.py's record of the main path's GroupNorms: Counters of
    (shape, SiLU) for one denoise step and for the VAE at 512²."""
    import chip_smoke

    return chip_smoke.main_path_groupnorms(torch)


def assert_covers(plan):
    starts = [s for s, _ in plan.bounds]
    assert plan.bounds[0][0] == 0 and plan.bounds[-1][1] == plan.span
    assert all(a[1] == b[0] for a, b in zip(plan.bounds, plan.bounds[1:]))  # no gap, no overlap
    assert all(0 < e - s <= min(plan.slice_len, gn.SLICE_MAX) for s, e in plan.bounds)
    assert all(s % 8 == 0 for s in starts)
    assert len(plan.bounds) == plan.slices


def test_launch_plan_puts_every_main_path_norm_in_one_cluster():
    step = main_path_norms()[0]
    assert sum(step.values()) == 105          # the launches chip_smoke counts per step
    # the card tests cover exactly these shapes
    assert {shape for shape, _ in step} == set(MAIN_PATH_GN_SHAPES)
    spans = set()
    for shape, _ in step:
        plan = gn.launch_plan(shape, 32)
        assert_covers(plan)
        assert plan.regime == "cluster" and 1 <= plan.slices <= gn.CLUSTER_MAX, (shape, plan)
        assert plan.vec
        spans.add(plan.span)
    # the up-blocks' 960- and 640-channel resnet inputs at 64x64
    assert max(spans) == 122880 and 81920 in spans


def test_launch_plan_splits_the_vae_long_spans():
    vae = main_path_norms()[1]
    regimes = {}
    for shape, _ in vae:
        plan = gn.launch_plan(shape, 32)
        assert_covers(plan)
        regimes[shape] = plan.regime
        assert plan.regime == ("cluster" if plan.span <= gn.CLUSTER_MAX * gn.SLICE_MAX
                               else "split")
    assert regimes[(1, 512, 64, 64)] == "cluster"
    assert regimes[(1, 128, 512, 512)] == "split"


@pytest.mark.parametrize("shape", [(1, 96, 5, 7), (3, 64, 1, 1), (1, 32, 1, 1), (2, 64, 3, 3),
                                   (4, 128, 512, 512), (1, 2560, 8, 8), (1, 32, 3, 4, 5)])
def test_launch_plan_covers_odd_shapes(shape):
    plan = gn.launch_plan(shape, 32)
    assert_covers(plan)
    assert plan.vec == (plan.span % 8 == 0 and plan.hw % 8 == 0)


def chan(a, b):
    """Chan's rule on fp32 (n, mean, M2) partials, as the kernel folds b into a."""
    n, mean, m2 = a
    nb, mb, m2b = b
    if nb == 0:
        return a
    nn = n + nb
    d = mb - mean
    return (nn, np.float32(mean + d * (nb / nn)), np.float32(m2 + m2b + d * d * (n * nb / nn)))


def merge_like_kernel(parts, regime):
    """The kernel's merge order: rank order in a cluster; in the split regime
    lane l of one warp folds slices l, l + 32, ... and a shuffle-down tree
    folds the lanes into lane 0."""
    zero = (np.float32(0), np.float32(0), np.float32(0))
    if regime == "cluster":
        acc = zero
        for p in parts:
            acc = chan(acc, p)
        return acc
    lanes = [zero] * 32
    for k, p in enumerate(parts):
        lanes[k % 32] = chan(lanes[k % 32], p)
    off = 16
    while off:
        lanes = [chan(lanes[i], lanes[i + off]) if i + off < 32 else lanes[i] for i in range(32)]
        off //= 2
    return lanes[0]


def emulate_kernel(x, weight, bias, groups, eps, apply_silu):
    """numpy fp32 emulation of B2: per-slice two-pass (mean, M2), merged by
    Chan's rule in the kernel's order, the per-channel multiply-add."""
    b, c = x.shape[:2]
    plan = gn.launch_plan(x.shape, groups)
    xs = x.reshape(b, groups, -1).astype(np.float32)
    out = np.empty_like(xs)
    cg = c // groups
    one = np.float32(1)
    for i in range(b):
        for g in range(groups):
            span = xs[i, g]
            parts = []
            for s, e in plan.bounds:
                sl = span[s:e]
                nb = np.float32(e - s)
                mb = np.float32(sl.sum(dtype=np.float32) / nb)
                parts.append((nb, mb, np.float32(np.square(sl - mb).sum(dtype=np.float32))))
            n, mean, m2 = merge_like_kernel(parts, plan.regime)
            rstd = one / np.sqrt(np.float32(m2 / n + np.float32(eps)))
            mul = (rstd * weight[g * cg:(g + 1) * cg]).astype(np.float32)
            add = (bias[g * cg:(g + 1) * cg] - mean * mul).astype(np.float32)
            y = span.reshape(cg, -1) * mul[:, None] + add[:, None]
            if apply_silu:
                y = y / (one + np.exp(-y))
            out[i, g] = y.reshape(-1)
    return out.reshape(x.shape)


@pytest.mark.parametrize("shape,silu", [((1, 960, 64, 64), True), ((2, 320, 64, 64), False),
                                        ((1, 2560, 8, 8), True), ((1, 96, 5, 7), False),
                                        ((1, 128, 256, 256), True)])
def test_kernel_statistics_emulation_matches_plain_and_jax(shape, silu):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3.0 + 1.5).astype(np.float32)
    c = shape[1]
    w = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    got = emulate_kernel(x, w, b, 32, 1e-5, silu)
    plain = gn.group_norm_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                32, 1e-5, silu).numpy()
    ref = np.asarray(j_group_norm(jnp.asarray(np.moveaxis(x, 1, -1)), jnp.asarray(w),
                                  jnp.asarray(b), 32, 1e-5, apply_silu=silu))
    ref = np.moveaxis(ref, -1, 1)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)


def fused_qkv(b=2, t=4096, h=8, d=40):
    qkv = torch.zeros(b, t, 3 * h * d, dtype=torch.bfloat16)
    return [x.view(b, t, h, d) for x in qkv.split(h * d, dim=-1)]


def test_tma_geometry_accepts_fused_qkv_slices():
    for x in fused_qkv():
        geo = tma_geometry(tuple(x.shape), x.stride(), x.data_ptr(), x.element_size())
        assert geo["dims"] == (40, 8, 4096, 2)
        # 80 B per head, 1920 B per token (3 * 8 * 40 bf16), a sample per batch
        assert geo["strides_bytes"] == (80, 1920, 4096 * 1920)
        assert geo["box"] == (16, 1, 128, 1)
    for d in (64, 80, 160):
        q = fused_qkv(b=1, t=64, h=2, d=d)[2]
        assert tma_geometry(tuple(q.shape), q.stride(), q.data_ptr(), 2, rows=64)["dims"][0] == d


@pytest.mark.parametrize("case", ["token_stride", "base", "head_dim", "unpacked", "rows"])
def test_tma_geometry_rejects_what_tma_cannot_take(case):
    q = fused_qkv()[0]
    shape, stride, ptr = tuple(q.shape), list(q.stride()), q.data_ptr()
    rows = 128
    if case == "token_stride":     # 964 bf16 = 1928 B per token: not a multiple of 16
        stride[1] = 964
    elif case == "base":           # one element past an aligned base
        ptr += 2
    elif case == "head_dim":       # D = 36: 72 B per head
        shape, stride = (2, 4096, 8, 36), [4096 * 288, 288, 36, 1]
    elif case == "unpacked":
        stride[2] = 48
    else:
        rows = 512
    with pytest.raises(ValueError):
        tma_geometry(shape, tuple(stride), ptr, 2, rows=rows)


@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_bwd_plan_fits_the_card(d):
    plans = fa.bwd_plan(d)
    assert set(plans) == {"dq", "dkv"}
    for kernel, p in plans.items():
        assert p.kernel == kernel and p.dp == fa.padded_dim(d) >= d
        for n in (p.ss_n, p.rs_n):          # wgmma takes M = 64 and N = 8, 16, ..., 256
            assert n % 8 == 0 and 8 <= n <= 256, (kernel, n)
        assert p.dp % 16 == 0               # whole k16 steps over the 16-column slabs
        assert p.tile % 16 == 0 and fa.TMA_ROWS % p.tile == 0
        assert p.smem <= fa.SMEM_MAX, (kernel, p.smem)
        assert all(24 <= r <= 256 and r % 8 == 0 for r in p.regs)  # setmaxnreg's range
        assert p.threads == (128, 256)
        assert sum(t * r for t, r in zip(p.threads, p.regs)) <= 65536
        assert all(0 < rows <= 256 for rows in p.boxes.values())
    dq, dkv = plans["dq"], plans["dkv"]
    assert dq.ss_n == dq.tile and dkv.ss_n == dkv.tile and dq.rs_n == dkv.rs_n == dq.dp
    # fp32 accumulators and bf16 fragments a consumer thread holds at once
    # (64 x N accumulators over 128 threads: N / 2 each), with room for
    # addresses and indices under setmaxnreg 240
    assert dq.ss_n + dq.rs_n // 2 + dq.ss_n // 4 <= 200
    assert dkv.ss_n + dkv.rs_n + dkv.ss_n // 2 <= 216


@pytest.mark.parametrize("d", [0, 36, 168, 256])
def test_bwd_plan_raises_for_a_head_dim_no_instance_takes(d):
    assert fa.padded_dim(d) == 0
    with pytest.raises(ValueError, match="head dim"):
        fa.bwd_plan(d)


@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_tma_geometry_accepts_the_bwd_boxes(d):
    """q/k/v as fused-qkv slices and dO as a column slice of a wider tensor,
    at every box height the backward instance of head dim d loads."""
    b, t, h = 1, 256, 2
    qkv = fused_qkv(b=b, t=t, h=h, d=d)
    do = torch.zeros(b, t, 2 * h * d, dtype=torch.bfloat16)[..., :h * d].unflatten(-1, (h, d))
    assert not do.is_contiguous()
    ops = dict(zip(("q", "k", "v"), qkv), do=do)
    for p in fa.bwd_plan(d).values():
        for name, rows in p.boxes.items():
            if name in ops:
                x = ops[name]
                geo = tma_geometry(tuple(x.shape), x.stride(), x.data_ptr(), 2, rows=rows)
                assert geo["box"] == (16, 1, rows, 1)
    geo = tma_geometry(tuple(do.shape), do.stride(), do.data_ptr(), 2, rows=fa.bwd_plan(d)["dkv"].tile)
    assert geo["strides_bytes"] == (2 * d, 2 * 2 * h * d, 2 * 2 * h * d * t)


@pytest.mark.parametrize("rows", [0, 257, 512])
def test_tma_geometry_rejects_a_box_past_256_rows(rows):
    q = fused_qkv()[0]
    with pytest.raises(ValueError, match="rows"):
        tma_geometry(tuple(q.shape), q.stride(), q.data_ptr(), 2, rows=rows)


@pytest.mark.parametrize("tq", [301, 302, 303, 304, 4096])
def test_lse_rows_padded_only_where_tma_needs_it(tq):
    x = torch.randn(6, tq)
    out = fa._tma_rows(x)
    if tq % 4 == 0:
        assert out is x
    else:
        assert out.shape == (6, -(-tq // 4) * 4) and out.stride(0) % 4 == 0
        assert torch.equal(out[:, :tq], x) and not out[:, tq:].any()


def test_dkv_query_tail_adds_exactly_nothing():
    """B4's tile loop in numpy fp32, query rows past Tq as TMA gives them
    (Q = dO = 0, lse = delta = 0): p = 1 and dS = 0 exactly, so those rows'
    terms of p^T dO and dS^T Q are exactly 0, and the padded loop agrees with
    the loop over the Tq real rows (to fp32 summation order)."""
    rng = np.random.RandomState(0)
    tq, tk, d, bq = 150, 64, 40, 64
    q, do = (rng.randn(tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(tk, d).astype(np.float32) for _ in range(2))
    scale = np.float32(1 / np.sqrt(d))
    s = q @ k.T * scale
    lse = (np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1)).astype(np.float32)
    delta = (do * (np.exp(s - lse[:, None]) @ v)).sum(1).astype(np.float32)
    pad = -(-tq // bq) * bq - tq
    q_p, do_p, lse_p, delta_p = (np.concatenate([x, np.zeros((pad,) + x.shape[1:], np.float32)])
                                 for x in (q, do, lse, delta))

    def dkv(q, do, lse, delta):
        dk, dv = np.zeros((tk, d), np.float32), np.zeros((tk, d), np.float32)
        for j in range(0, len(q), bq):
            qt, ot = q[j:j + bq], do[j:j + bq]
            pt = np.exp(k @ qt.T * scale - lse[j:j + bq])          # p^T, keys x queries
            dst = pt * (v @ ot.T - delta[j:j + bq])
            if j + bq > tq:                                         # the padded rows
                tail = slice(tq - j, None)
                assert (pt[:, tail] == 1).all() and (dst[:, tail] == 0).all()
                assert not (pt[:, tail] @ ot[tail]).any() and not (dst[:, tail] @ qt[tail]).any()
            dv += pt @ ot
            dk += dst @ qt
        return dk * scale, dv

    for a, b in zip(dkv(q_p, do_p, lse_p, delta_p), dkv(q, do, lse, delta)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("d", range(8, 161, 8))
def test_fwd_f32_plan_fits_the_card(d):
    """B1's fp32 instance for every head dim the route sends it: shared memory
    within a CTA's, wgmma widths and TMA boxes the card takes, a register
    split within the SM's, and 8-column fp32 boxes on fused-qkv slices."""
    p = fa.fwd_f32_plan(d)
    assert p.dp == fa.padded_dim(d, fa._F32_DIMS) >= d
    assert p.dp % 8 == 0                        # whole TF32 k8 steps over 8-column slabs
    assert p.smem <= fa.SMEM_MAX, p.smem
    assert p.smem == 2 * p.rows * p.dp * 4 + 5 * p.stages * p.tile * p.dp * 4 + 256 + 1024
    for n in (p.ss_n, p.rs_n):                  # wgmma takes M = 64 and N = 8, 16, ..., 256
        assert n % 8 == 0 and 8 <= n <= 256, n
    assert p.ss_n == p.tile and p.rs_n == p.dp and p.tile % 8 == 0
    assert p.rows == 64 * p.consumers and p.threads == (128, 128 * p.consumers)
    assert p.stages >= 2                        # a tile loads while the last one computes
    if p.regs is None:                          # no setmaxnreg: ptxas's count, <= 255 a thread
        assert sum(p.threads) * 255 <= 65536
    else:                                       # the launch's 168 a thread, redistributed
        assert all(24 <= r <= 256 and r % 8 == 0 for r in p.regs)
        assert sum(t * r for t, r in zip(p.threads, p.regs)) == sum(p.threads) * 168
    # fp32 accumulators a consumer thread holds at once: S, P's hi and lo
    # fragments, O and the tile's P V, with room under setmaxnreg 224
    assert p.tile // 2 + p.tile + p.dp <= 200
    b, t, h = 1, 256, 2
    qkv = torch.zeros(b, t, 3 * h * d, dtype=torch.float32)
    for name, x in zip(("q", "k", "v"), (x.view(b, t, h, d) for x in qkv.split(h * d, -1))):
        geo = tma_geometry(tuple(x.shape), x.stride(), x.data_ptr(), 4, rows=p.boxes[name])
        assert geo["box"] == (8, 1, p.boxes[name], 1)
        assert geo["strides_bytes"] == (4 * d, 4 * 3 * h * d, 4 * 3 * h * d * t)


@pytest.mark.parametrize("d", [0, 36, 168, 256])
def test_fwd_f32_plan_raises_for_a_head_dim_no_instance_takes(d):
    with pytest.raises(ValueError, match="head dim"):
        fa.fwd_f32_plan(d)


def tf32_trunc(x):
    """x with its low 13 mantissa bits cleared (fp32 -> TF32 by truncation)."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)


def tf32_split(x):
    """`hopper::tf32_split`: hi = x truncated to TF32, lo = x - hi (exact in
    fp32) truncated too."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x - hi)


def tf32_mm(a, b, passes):
    """a @ b over the last two dims as the kernel's wgmmas sum it: three
    passes of TF32 products (hi·lo + lo·hi, then hi·hi) in fp32, or one."""
    if passes == 1:
        return np.matmul(tf32_trunc(a), tf32_trunc(b))
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return (np.matmul(ah, bl) + np.matmul(al, bh)) + np.matmul(ah, bh)


def slot_order(n):
    """The rows of a transposed operand (`transpose_tile`) for an n-column
    accumulator: slot s of each group of 8 holds row 2 * (s % 4) + s // 4."""
    return np.concatenate([8 * g + np.array([2 * (s % 4) + s // 4 for s in range(8)])
                           for g in range(n // 8)])


def a_fragment(acc, perm):
    """The TF32 A fragment of a product over an accumulator's columns, built
    from the accumulator's thread map: thread (g, c) holds columns 2c and
    2c + 1 of each group of 8 and hands them to slots c and c + 4.  Checked
    equal to the columns in `slot_order`."""
    frag = np.empty_like(acc)
    for n in range(acc.shape[-1] // 8):
        for c in range(4):
            frag[..., 8 * n + c] = acc[..., 8 * n + 2 * c]
            frag[..., 8 * n + c + 4] = acc[..., 8 * n + 2 * c + 1]
    assert np.array_equal(frag, acc[..., perm])
    return frag


def heads(x, rows, dp):
    """(B, T, H, D) -> (B, H, rows, DP), zero-filled past T and D as TMA
    gives them."""
    b, t, h, d = x.shape
    out = np.zeros((b, h, rows, dp), np.float32)
    out[:, :, :t, :d] = x.transpose(0, 2, 1, 3)
    return out


def emulate_b1_f32(q, k, v, passes=3):
    """B1's fp32 instance in numpy over (B, T, H, D) fp32 -> (out, lse (B·H, Tq))."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    plan = fa.fwd_f32_plan(d)
    bn, dp = plan.tile, plan.dp
    nt = -(-tk // bn)

    qh = heads(q, -(-tq // plan.rows) * plan.rows, dp)
    kh, vh = heads(k, nt * bn, dp), heads(v, nt * bn, dp)
    scale_log2 = np.float32(np.log2(np.e) / np.sqrt(d))
    perm = slot_order(bn)
    m = np.full(qh.shape[:3], -np.inf, np.float32)
    l = np.zeros(qh.shape[:3], np.float32)
    acc = np.zeros(qh.shape, np.float32)
    for j in range(nt):
        kt, vt = kh[:, :, j * bn:(j + 1) * bn], vh[:, :, j * bn:(j + 1) * bn]
        s = tf32_mm(qh, kt.transpose(0, 1, 3, 2), passes)
        masked = j * bn + np.arange(bn) >= tk
        s[..., masked] = -np.inf
        m_new = np.maximum(m, s.max(-1) * scale_log2)
        mu = np.where(m_new == -np.inf, np.float32(0), m_new)
        corr = np.exp2(m - mu)
        p = np.exp2(s * scale_log2 - mu[..., None])
        l = l * corr + p.sum(-1)
        m = m_new
        frag = a_fragment(p, perm)
        vt_perm = vt[:, :, perm]
        # keys past Tk stay masked after the permutation: p = 0, V rows zero
        assert not frag[..., masked[perm]].any() and not vt_perm[:, :, masked[perm]].any()
        acc = acc * corr[..., None] + tf32_mm(frag, vt_perm, passes)
    l_safe = np.where(l == 0, np.float32(1), l)
    out = (acc / l_safe[..., None])[:, :, :tq, :d].transpose(0, 2, 1, 3)
    lse = (m * np.float32(np.log(2)) + np.log(l_safe))[:, :, :tq].reshape(b * h, tq)
    return out, lse


@functools.lru_cache(maxsize=None)
def jax_flash_fwd(b, tq, tk, h, d, seed):
    """Seeded randn q/k/v and the JAX Pallas forward kernel's (out, lse) on
    them, in TPU interpret mode (the path of tests/test_torch_ops.py)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k, v = (rng.randn(b, tk, h, d).astype(np.float32) for _ in range(2))

    def fold(x):
        x = jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(b * h, x.shape[1], d)
        return j_fa._pad_head_dim(x)[0]

    with pltpu.force_tpu_interpret_mode():
        out, lse = j_fa._flash_fwd(fold(q), fold(k), fold(v), float(1 / np.sqrt(d)), 128, 128)
    out = np.asarray(out)[:, :, :d].reshape(b, h, tq, d).transpose(0, 2, 1, 3)
    return q, k, v, out, np.asarray(lse)[:, :, 0]


EMULATION_SHAPES = [(1, 264, 264, 2, 40),     # ragged for the D = 40 instance's 64-key tiles
                    (1, 96, 152, 1, 160)]     # Tq != Tk, ragged 16-key tiles at D = 160


@pytest.mark.parametrize("b,tq,tk,h,d", EMULATION_SHAPES)
def test_f32_kernel_emulation_matches_jax_flash(b, tq, tk, h, d):
    q, k, v, ref, ref_lse = jax_flash_fwd(b, tq, tk, h, d, 0)
    out, lse = emulate_b1_f32(q, k, v)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,tq,tk,h,d", EMULATION_SHAPES)
def test_one_tf32_pass_misses_the_fp32_tolerance(b, tq, tk, h, d):
    """The same inputs with every product one TF32 pass: the output is off by
    more than 1e-4 of its max, so the kernel's three passes are needed."""
    q, k, v, ref, _ = jax_flash_fwd(b, tq, tk, h, d, 0)
    out, _ = emulate_b1_f32(q, k, v, passes=1)
    assert np.abs(out - ref).max() > 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("d", range(8, 161, 8))
def test_bwd_f32_plan_fits_the_card(d):
    """B3's and B4's fp32 instances for every head dim the route sends them:
    shared memory within a CTA's, wgmma widths and TMA boxes the card takes,
    a register split within the SM's, and what a consumer thread holds in
    registers at once (S and dP, the hi/lo fragments, each output's sum and
    the tile's fresh accumulator) within its setmaxnreg."""
    plans = fa.bwd_f32_plan(d)
    for kernel, p in plans.items():
        assert p.kernel == kernel and p.dp == fa.padded_dim(d, fa._F32_DIMS) >= d
        assert p.smem <= fa.SMEM_MAX, (kernel, p.smem)
        for n in (p.ss_n, p.rs_n):                # wgmma takes M = 64 and N = 8, 16, ..., 256
            assert n % 8 == 0 and 8 <= n <= 256, (kernel, n)
        assert p.tile % 8 == 0 and p.ss_n == p.tile and p.rs_n == p.cols
        assert p.dp % p.cols == 0 and p.rows * p.dp // p.cols == 64 * p.consumers
        assert p.threads == (128, 128 * p.consumers)
        if p.regs is None:
            assert sum(p.threads) * 255 <= 65536
        else:
            assert all(24 <= r <= 256 and r % 8 == 0 for r in p.regs)
            assert sum(t * r for t, r in zip(p.threads, p.regs)) == sum(p.threads) * 168
        assert all(0 < rows <= 256 for rows in p.boxes.values())
        assert p.boxes["lse" if kernel == "dkv" else "k"] * 4 % 16 == 0
    dq, dkv = plans["dq"], plans["dkv"]
    # B3 runs tile j - 1's dQ product behind tile j's S and dP, so tile j
    # needs a stage of its own; B4 does the same with two stages or more
    assert dq.stages >= 2 and dq.cols == dq.dp and dkv.stages >= 1
    # registers a consumer thread holds (64 x N fp32 accumulators are N / 2
    # each, hi/lo fragments of 64 x N are N): S, dP and dS's fragments with
    # dQ and its tile sum in B3; S^T, dP^T, two pairs of fragments, dK, dV
    # and their tile sums in B4; with room for addresses and indices
    assert dq.tile + dq.tile + dq.dp <= (200 if dq.regs else 232)
    assert dkv.tile + 2 * dkv.tile + 2 * dkv.cols <= 200
    b, t, h = 1, 256, 2
    qkv = torch.zeros(b, t, 3 * h * d, dtype=torch.float32)
    do = torch.zeros(b, t, 2 * h * d)[..., :h * d].unflatten(-1, (h, d))
    ops = dict(zip(("q", "k", "v"), (x.view(b, t, h, d) for x in qkv.split(h * d, -1))), do=do)
    for p in plans.values():
        for name, x in ops.items():
            geo = tma_geometry(tuple(x.shape), x.stride(), x.data_ptr(), 4, rows=p.boxes[name])
            assert geo["box"] == (8, 1, p.boxes[name], 1)


@pytest.mark.parametrize("d", [0, 36, 168, 256])
def test_bwd_f32_plan_raises_for_a_head_dim_no_instance_takes(d):
    with pytest.raises(ValueError, match="head dim"):
        fa.bwd_f32_plan(d)


def emulate_b3_f32(q, k, v, do, lse, delta, passes=3):
    """B3's fp32 instance in numpy over (B, T, H, D) fp32 with lse and delta
    (B·H, Tq) -> dq: three passes a product, p from lse in the log2 domain,
    keys past Tk masked to p = 0, dS as the A fragment against K^T's
    permuted slots, a fresh accumulator each tile added to dQ."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    plan = fa.bwd_f32_plan(d)["dq"]
    bn, dp = plan.tile, plan.dp
    nt, rows = -(-tk // bn), -(-tq // plan.rows) * plan.rows
    qh, doh = heads(q, rows, dp), heads(do, rows, dp)
    kh, vh = heads(k, nt * bn, dp), heads(v, nt * bn, dp)

    def per_row(x):          # (B·H, Tq) -> (B, H, rows, 1), rows past Tq read 0
        out = np.zeros((b, h, rows, 1), np.float32)
        out[:, :, :tq, 0] = x.reshape(b, h, tq)
        return out

    lse2, dlt = per_row(lse) * np.float32(np.log2(np.e)), per_row(delta)
    scale = np.float32(1 / np.sqrt(d))
    scale_log2 = np.float32(np.log2(np.e)) * scale
    perm = slot_order(bn)
    acc = np.zeros(qh.shape, np.float32)
    for j in range(nt):
        kt, vt = kh[:, :, j * bn:(j + 1) * bn], vh[:, :, j * bn:(j + 1) * bn]
        s = tf32_mm(qh, kt.transpose(0, 1, 3, 2), passes)
        dpm = tf32_mm(doh, vt.transpose(0, 1, 3, 2), passes)
        p = np.exp2(s * scale_log2 - lse2)
        masked = j * bn + np.arange(bn) >= tk
        p[..., masked] = 0
        ds = p * (dpm - dlt)
        kt_perm = kt[:, :, perm]
        frag = a_fragment(ds, perm)
        # keys past Tk stay masked after the permutation: dS = 0, K^T slots zero
        assert not frag[..., masked[perm]].any() and not kt_perm[:, :, masked[perm]].any()
        acc += tf32_mm(frag, kt_perm, passes)
    return (acc * scale)[:, :, :tq, :d].transpose(0, 2, 1, 3)


def emulate_b4_f32(q, k, v, do, lse, delta, passes=3):
    """B4's fp32 instance in numpy -> (dk, dv): S^T and dP^T per query tile,
    queries past Tq as TMA gives them (zeros, lse = delta = 0: p = 1 and dS
    = 0 exactly, adding exactly nothing), p^T and dS^T as A fragments against
    dO^T's and Q^T's permuted slots, each consumer's columns (`cols`) in its
    own fresh accumulator a tile."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    plan = fa.bwd_f32_plan(d)["dkv"]
    bq, dp = plan.tile, plan.dp
    nt, rows = -(-tq // bq), -(-tk // plan.rows) * plan.rows
    kh, vh = heads(k, rows, dp), heads(v, rows, dp)
    qh, doh = heads(q, nt * bq, dp), heads(do, nt * bq, dp)

    def per_col(x):          # (B·H, Tq) -> (B, H, 1, nt·bq), zero past Tq
        out = np.zeros((b, h, 1, nt * bq), np.float32)
        out[:, :, 0, :tq] = x.reshape(b, h, tq)
        return out

    lse2, dlt = per_col(lse) * np.float32(np.log2(np.e)), per_col(delta)
    scale = np.float32(1 / np.sqrt(d))
    scale_log2 = np.float32(np.log2(np.e)) * scale
    perm = slot_order(bq)
    dk, dv = np.zeros(kh.shape, np.float32), np.zeros(kh.shape, np.float32)
    for j in range(nt):
        cols = slice(j * bq, (j + 1) * bq)
        qt, ot = qh[:, :, cols], doh[:, :, cols]
        pt = np.exp2(tf32_mm(kh, qt.transpose(0, 1, 3, 2), passes) * scale_log2 - lse2[..., cols])
        dst = pt * (tf32_mm(vh, ot.transpose(0, 1, 3, 2), passes) - dlt[..., cols])
        tail = j * bq + np.arange(bq) >= tq
        assert (pt[..., tail] == 1).all() and (dst[..., tail] == 0).all()
        qt_perm, ot_perm = qt[:, :, perm], ot[:, :, perm]
        fp, fds = a_fragment(pt, perm), a_fragment(dst, perm)
        assert not qt_perm[:, :, tail[perm]].any() and not ot_perm[:, :, tail[perm]].any()
        for c0 in range(0, dp, plan.cols):
            part = slice(c0, c0 + plan.cols)
            dv[..., part] += tf32_mm(fp, ot_perm[..., part], passes)
            dk[..., part] += tf32_mm(fds, qt_perm[..., part], passes)
    return tuple(x[:, :, :tk, :d].transpose(0, 2, 1, 3) for x in (dk * scale, dv))


@functools.lru_cache(maxsize=None)
def jax_flash_bwd(b, tq, tk, h, d, seed):
    """Seeded randn dO beside `jax_flash_fwd`'s inputs, delta = rowsum(dO∘O),
    and the JAX Pallas backward kernels' (dq, dk, dv) in TPU interpret mode."""
    q, k, v, out, lse = jax_flash_fwd(b, tq, tk, h, d, seed)
    do = np.random.RandomState(seed + 1).randn(b, tq, h, d).astype(np.float32)

    def fold(x):
        x = jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(b * h, x.shape[1], d)
        return j_fa._pad_head_dim(x)[0]

    lse3 = jnp.broadcast_to(jnp.asarray(lse)[:, :, None], (b * h, tq, 128))
    with pltpu.force_tpu_interpret_mode():
        grads = j_fa._flash_bwd(fold(q), fold(k), fold(v), fold(out), lse3, fold(do),
                                float(1 / np.sqrt(d)), 128, 128)
    grads = [np.asarray(g)[:, :, :d].reshape(b, h, -1, d).transpose(0, 2, 1, 3) for g in grads]
    delta = (do * out).sum(-1).transpose(0, 2, 1).reshape(b * h, tq).astype(np.float32)
    return q, k, v, do, lse, delta, grads


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("b,tq,tk,h,d", EMULATION_SHAPES)
def test_bwd_f32_kernel_emulation_matches_jax_flash(b, tq, tk, h, d, passes):
    """Three passes a product meet 1e-4 of each gradient's max against the
    Pallas backward; one TF32 pass on the same inputs does not, which is why
    the kernels take three."""
    q, k, v, do, lse, delta, ref = jax_flash_bwd(b, tq, tk, h, d, 0)
    got = (emulate_b3_f32(q, k, v, do, lse, delta, passes),
           *emulate_b4_f32(q, k, v, do, lse, delta, passes))
    errs = [np.abs(a - r).max() / np.abs(r).max() for a, r in zip(got, ref)]
    if passes == 3:
        assert max(errs) <= 1e-4, errs
    else:
        assert min(errs) > 1e-4, errs
