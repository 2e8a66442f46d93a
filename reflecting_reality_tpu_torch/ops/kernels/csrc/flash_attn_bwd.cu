// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes:
// kernels B3 (dQ) and B4 (dK, dV).
//
// Replaces reflecting_reality_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel
// (pallas_call at :234) and ::_bwd_dkv_kernel (pallas_call at :250).  Both
// recompute the probabilities from the forward's logsumexp instead of storing
// them: p = exp(s - lse) with s = q.k / sqrt(D) (the true head dim D).  With
// dP = dO V^T and the row term delta = rowsum(dO * O) (computed by the
// caller, as XLA does at :231):
//   dS = p * (dP - delta),  dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),
//   dV = p^T dO,
// with p and dS in the input dtype before they multiply dO, K or Q, as the
// Pallas kernels cast them (rounded to bf16 in the bf16 path).  The JAX package's two-kernel
// split is kept: the dQ kernel owns a tile of query rows and walks the keys,
// the dK/dV kernel owns a tile of keys and walks the queries, so every output
// element is written by one CTA after a sum in a fixed order: the result is
// deterministic and needs no atomics.
//
// Layout as the forward: q/k/v/dO/dQ/dK/dV are (B, T, H, D) with (H, D)
// packed and batch/token strides passed in; lse and delta are fp32 rows, one
// per (b, h), of Tq values (B4 takes their row stride, a multiple of 4).
//
// What bounds it.  The two kernels do 7 products of 2*B*H*Tq*Tk*D FLOP (3 in
// B3: S, dP, dQ; 4 in B4: S^T, dP^T, dV, dK) and 2*B*H*Tq*Tk exponentials
// (each kernel recomputes p).  At the training shape (4, 4096, 8, 40) bf16
// that is 3.0e11 FLOP, 0.30 ms at 989 TFLOP/s (0.36 ms with D padded to 48),
// and 1.07e9 exponentials, 0.26 ms at 16 per clock per SM on the
// multi-function unit at 1.98 GHz, against ~75 MB of operands (22 us at
// 3.35 TB/s).  So operations bind, the tensor cores and the exponentials
// about equally at D = 40; bytes do not matter.
//
// bf16 path (every head dim, D % 8 == 0, D <= 160; instances at the padded
// widths 48, 64, 80, 160), the design of the forward (flash_attn_fwd.cu):
// one CTA of three warpgroups owns CTA_BM = 128 rows (query rows in B3, keys
// in B4), 64 per consumer warpgroup, so every tile brought from L2 serves 128
// rows.
//  - Producer warpgroup (setmaxnreg 24): one thread issues TMA loads, the
//    CTA's own operands once (Q and dO in B3, K and V in B4) and the streamed
//    tiles (K and V of BN keys in B3; Q and dO of BQ queries with that tile's
//    lse and delta in B4) into a ring of mbarrier-guarded stages.  One full
//    barrier per stage counts all of its bytes; the empty barrier takes an
//    arrival from each of the 256 consumer threads once the stage's products
//    have completed.
//  - Consumer warpgroups (setmaxnreg 240).  Each tile is two wgmma_ss
//    products with both operands K-major as they lie in shared memory (S and
//    dP in B3; S^T = K Q^T and dP^T = V dO^T in B4, so that p^T and dS^T come
//    out as accumulators), then p and dS in registers, then wgmma_rs products
//    whose A operand is that accumulator rounded to bf16 (the accumulator
//    layout is already the A-register fragment) and whose B operand is read
//    MN-major (transposed) from the same shared tile: dQ += dS K in B3, dV +=
//    p^T dO and dK += dS^T Q in B4.  lse and delta are per row in B3 (held in
//    registers) and per column in B4 (read from the stage).
//  - Overlap: each iteration issues tile j's S and dP, then tile j - 1's
//    accumulating products (dQ, or dV and dK) behind them, waits for S and
//    dP only and computes tile j's p and dS while those products run (the
//    forward's order); the two consumer warpgroups also take turns at the
//    exponentials on named barriers, so one group's exponentials run while
//    the other group's products are in the tensor cores.  No wgmma is in
//    flight across the loop's back edge: with the accumulating products
//    retired only at the next tile's wait, ptxas serialised every wgmma
//    (C7515), and no register an in-flight wgmma reads or writes is
//    touched before its wait.
//  - Reads in place, padding without copies: 4-D tensor maps (D, H, T, B)
//    over the strided q/k/v/dO with boxes of 16 columns (32-byte swizzle);
//    columns past D and rows past T come from TMA's zero fill, so D = 40 pads
//    to 48.  Keys past Tk get p = 0 in B3.  In B4, query rows past Tq read
//    zeros for Q and dO and lse = delta = 0 (the 2-D map's zero fill), so
//    s = 0, p = 1, dP = 0, dS = 1 * (0 - 0) = 0: their p^T dO and dS^T Q
//    terms are exactly 0.
//  - Tiles: B3 streams 128 keys a tile for DP <= 64 and 64 for DP = 80 and
//    160 (registers: S and dP of 64 x BN plus the dQ accumulator and the
//    in-flight dS fragments); B4 streams 64 queries a tile, 32 for DP = 160
//    (the dK and dV accumulators alone take 160 registers there).
//
// fp32 path (every head dim, D % 8 == 0, D <= 160; instances at 40, 64, 80
// and 160, B1's fp32 widths), the training CLI's default `--mixed_precision
// no`: the same split into producer and consumer warpgroups on the TF32
// tensor cores, each product three passes over hi/lo operands (3xTF32, as
// B1's fp32 instance in flash_attn_fwd.cu).
//  - What bounds it.  The 7 products are 3 * 7 * 2*B*H*Tq*Tk*D FLOP as
//    three TF32 passes: 1.82 ms at (4, 4096, 8, 40) at 495 TFLOP/s, against
//    4.49 ms for the same work on the CUDA cores (67 TFLOP/s).  So the tensor
//    cores bind, then the work that feeds them: the splits and transposes
//    of each streamed tile, which share the SM's issue slots and shared
//    memory with the products.
//  - TF32 wgmma takes K-major operands only.  S = Q K^T and dP = dO V^T
//    (B3), S^T = K Q^T and dP^T = V dO^T (B4) have both operands K-major as
//    they lie.  dQ += dS K needs K^T, dK += dS^T Q and dV += p^T dO need Q^T
//    and dO^T: producer warps 1-3 write them from each raw tile that lands
//    (8-row slabs of DP rows, `transpose_tile`), the rows permuted within
//    each group of 8 so that the dS (p^T, dS^T) accumulator already is the
//    A fragment, and split the raw tiles into hi (in place) and lo on the
//    way (3% faster for B4 than a transpose and a split pass apart).  B4
//    transposes two operands a tile, B3 one.
//  - Each tile's dQ, dK and dV products go to fresh accumulators that fp32
//    adds sum: the tensor cores do not round their fp32 sums to nearest,
//    and one accumulator carried over 4096 keys drifted (measured on B1,
//    flash_attn_fwd.cu).
//  - Shared memory, 4 bytes an element, hi and lo of everything and the
//    transposes: B3 keeps Q and dO (hi, lo) of BM rows and per stage K, K
//    lo, V, V lo, K^T hi and lo; B4 keeps K and V (hi, lo) and per stage Q,
//    Q lo, dO, dO lo, Q^T and dO^T (hi, lo), lse and delta.  Tiles and
//    stages per instance are `DqF32Cfg` / `DkvF32Cfg` below (`bwd_f32_plan`
//    in Python): B3 32 keys x 4 stages at DP = 40, B4 32 queries x 3
//    (the fastest of the tilings `chip_variants.py` times).
//  - Registers: a consumer thread holds S and dP (or their transposes), the
//    hi/lo fragments, and for each output its sum and the tile's fresh
//    accumulator.  At DP >= 80 dK and dV of 64 keys would not fit: B4's two
//    consumer warpgroups then share 64 keys and split the columns.  B3 at
//    DP = 160 has one consumer warpgroup.
//  - Masking as the bf16 path: keys past Tk get p = 0 in B3 (their K^T slots
//    are zero in any order); query rows past Tq read zeros in B4 and add
//    exactly nothing.

#include "flash_common.cuh"
#include "launch.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- bf16 path

// B3: CTA_BM query rows; K and V tiles of BN keys through a ring of STAGES.
template <int DP>
struct DqCfg {
  static constexpr int BN = DP <= 64 ? 128 : 64;
  static constexpr int STAGES = DP == 160 ? 3 : 4;
  static constexpr int NSLAB = DP / SLAB;
  static constexpr int Q_BYTES = CTA_BM * DP * 2;  // Q (and dO)
  static constexpr int KV_BYTES = BN * DP * 2;     // one K (or V) tile
  // operands, then the mbarriers; 1 KB of slack to align the base to 1 KB
  static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 256 + 1024;
};

// B4: CTA_BM keys; Q and dO tiles of BQ queries, with their lse and delta,
// through a ring of STAGES.
template <int DP>
struct DkvCfg {
  static constexpr int BQ = DP == 160 ? 32 : 64;
  static constexpr int STAGES = 4;
  static constexpr int NSLAB = DP / SLAB;
  static constexpr int KV_BYTES = CTA_BM * DP * 2;  // K (and V)
  static constexpr int T_BYTES = BQ * DP * 2;       // one Q (or dO) tile
  static constexpr int R_BYTES = BQ * 4;            // one tile's lse (or delta)
  static constexpr int SMEM = 2 * KV_BYTES + STAGES * (2 * T_BYTES + 2 * R_BYTES) + 256 + 1024;
};

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows row0 + g and row0 + g + 8 of a 64 x N accumulator, as columns col0
// to col0 + N - 1 (those below D), scaled, stored in the output's dtype.
template <int N, typename T>
__device__ __forceinline__ void store_rows(T* out, long long st, const float (&acc)[N / 2],
                                           int row0, int nrows, int col0, int D, int g,
                                           int tq4, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= nrows) continue;
    T* orow = out + (long long)row * st + col0;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const int col = n * 8 + tq4 * 2;
      if (col0 + col < D)
        store2(orow + col, acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
    }
  }
}

// ------------------------------------------------------------ B3: dQ, bf16

template <int DP>
__global__ void __launch_bounds__(CTA_THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int H, int Tq, int Tk, int D, long long dq_sb,
                   long long dq_st, float scale, float scale_log2) {
  using C = DqCfg<DP>;
  constexpr int BN = C::BN, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1k(smem_raw);
  unsigned char* dos = qs + C::Q_BYTES;
  unsigned char* ks = dos + C::Q_BYTES;  // stage st at ks + st * KV_BYTES
  unsigned char* vs = ks + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * CTA_BM;
  const int ntiles = (Tk + BN - 1) / BN;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(full + st, 1);
      hopper::mbar_init(empty + st, 2 * WG_THREADS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_desc(&tm_q);
      hopper::tma_prefetch_desc(&tm_k);
      hopper::tma_prefetch_desc(&tm_v);
      hopper::tma_prefetch_desc(&tm_do);
      hopper::mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
      for (int c = 0; c < C::NSLAB; ++c) {
        hopper::tma_load_4d(qs + c * CTA_BM * SLAB_BYTES, &tm_q, q_full, c * SLAB, h, q0, b);
        hopper::tma_load_4d(dos + c * CTA_BM * SLAB_BYTES, &tm_do, q_full, c * SLAB, h, q0, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) hopper::mbar_wait(empty + st, (j / STAGES - 1) & 1);
        hopper::mbar_arrive_expect_tx(full + st, 2 * C::KV_BYTES);
        for (int c = 0; c < C::NSLAB; ++c) {
          const int off = st * C::KV_BYTES + c * BN * SLAB_BYTES;
          hopper::tma_load_4d(ks + off, &tm_k, full + st, c * SLAB, h, j * BN, b);
          hopper::tma_load_4d(vs + off, &tm_v, full + st, c * SLAB, h, j * BN, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int local = threadIdx.x - wg * WG_THREADS;
    const int warp = local >> 5, lane = local & 31;
    const int g = lane >> 2, tq4 = lane & 3;
    const int row0 = q0 + cw * WG_BM + warp * 16;  // this warp's 16 query rows

    // lse (log2 domain) and delta of rows g and g + 8; rows past Tq read 0
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + r * 8;
      const bool ok = row < Tq;
      lse2[r] = ok ? lse[(long long)bh * Tq + row] * LOG2E : 0.f;
      dlt[r] = ok ? delta[(long long)bh * Tq + row] : 0.f;
    }
    float s[BN / 2], dp[BN / 2], acc[DP / 2];
    uint32_t ds[BN / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    const unsigned char* qw = qs + cw * WG_BM * SLAB_BYTES;
    const unsigned char* dow = dos + cw * WG_BM * SLAB_BYTES;

    // The two consumers take turns at the exponentials (named barriers 1, 2;
    // consumer 0 first); consumer 1 skips its last hand-over, so both
    // barriers end with as many arrivals as waits.
    const int me = BAR_PING + cw, other = BAR_PING + (cw ^ 1);
    hopper::mbar_wait(q_full, 0);
    if (cw == 1) hopper::named_arrive<2 * WG_THREADS>(BAR_PING);
    const unsigned char* k_prev = ks;  // the stage of tile j - 1
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES;
      const unsigned char* kt = ks + st * C::KV_BYTES;
      hopper::mbar_wait(full + st, (j / STAGES) & 1);
      // S_j = Q K_j^T and dP_j = dO V_j^T, then dQ += dS_{j-1} K_{j-1}
      // behind them: it runs while this warpgroup computes dS_j
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      issue_abt<DP, BN>(s, qw, kt);
      issue_abt<DP, BN>(dp, dow, vs + st * C::KV_BYTES);
      hopper::wgmma_commit();
      if (j > 0) {
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        issue_ab<DP, BN>(acc, ds, k_prev);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S_j and dP_j done, the dQ product may still run
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // dS = p (dP - delta), p = exp2(s * scale_log2 - lse2); keys past Tk: p = 0
      hopper::named_sync<2 * WG_THREADS>(me);
      const int k0 = j * BN;
      const bool tail = k0 + BN > Tk;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(s[i], scale_log2, -lse2[r]));
        if (tail && k0 + (i / 4) * 8 + tq4 * 2 + (i & 1) >= Tk) p = 0.f;
        s[i] = p * (dp[i] - dlt[r]);
      }
      if (!(cw == 1 && j == ntiles - 1)) hopper::named_arrive<2 * WG_THREADS>(other);
      hopper::wgmma_wait<0>();  // dQ += dS_{j-1} K_{j-1} done: stage j - 1 is free
      hopper::fence_regs(acc);
      if (j > 0) hopper::mbar_arrive(empty + (j - 1) % STAGES);
      to_a_fragments<BN>(ds, s);
      k_prev = kt;
    }
    // the last tile's dQ += dS K
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    issue_ab<DP, BN>(acc, ds, k_prev);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    store_rows<DP>(dq + b * dq_sb + (long long)h * D, dq_st, acc, row0, Tq, 0, D, g, tq4, scale);
  }
}

// ------------------------------------------------------- B4: dK/dV, bf16

template <int DP>
__global__ void __launch_bounds__(CTA_THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_lse,
                    const __grid_constant__ CUtensorMap tm_delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int Tq, int Tk, int D, long long dk_sb,
                    long long dk_st, long long dv_sb, long long dv_st, float scale,
                    float scale_log2) {
  using C = DkvCfg<DP>;
  constexpr int BQ = C::BQ, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align_1k(smem_raw);
  unsigned char* vs = ks + C::KV_BYTES;
  unsigned char* qs = vs + C::KV_BYTES;  // stage st at qs + st * T_BYTES
  unsigned char* dos = qs + STAGES * C::T_BYTES;
  float* ls = reinterpret_cast<float*>(dos + STAGES * C::T_BYTES);  // stage st at ls + st * BQ
  float* dls = ls + STAGES * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dls + STAGES * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * CTA_BM;
  const int ntiles = (Tq + BQ - 1) / BQ;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(full + st, 1);
      hopper::mbar_init(empty + st, 2 * WG_THREADS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_desc(&tm_q);
      hopper::tma_prefetch_desc(&tm_k);
      hopper::tma_prefetch_desc(&tm_v);
      hopper::tma_prefetch_desc(&tm_do);
      hopper::tma_prefetch_desc(&tm_lse);
      hopper::tma_prefetch_desc(&tm_delta);
      hopper::mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int c = 0; c < C::NSLAB; ++c) {
        hopper::tma_load_4d(ks + c * CTA_BM * SLAB_BYTES, &tm_k, kv_full, c * SLAB, h, k0, b);
        hopper::tma_load_4d(vs + c * CTA_BM * SLAB_BYTES, &tm_v, kv_full, c * SLAB, h, k0, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) hopper::mbar_wait(empty + st, (j / STAGES - 1) & 1);
        hopper::mbar_arrive_expect_tx(full + st, 2 * C::T_BYTES + 2 * C::R_BYTES);
        for (int c = 0; c < C::NSLAB; ++c) {
          const int off = st * C::T_BYTES + c * BQ * SLAB_BYTES;
          hopper::tma_load_4d(qs + off, &tm_q, full + st, c * SLAB, h, j * BQ, b);
          hopper::tma_load_4d(dos + off, &tm_do, full + st, c * SLAB, h, j * BQ, b);
        }
        hopper::tma_load_2d(ls + st * BQ, &tm_lse, full + st, j * BQ, bh);
        hopper::tma_load_2d(dls + st * BQ, &tm_delta, full + st, j * BQ, bh);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int local = threadIdx.x - wg * WG_THREADS;
    const int warp = local >> 5, lane = local & 31;
    const int g = lane >> 2, tq4 = lane & 3;

    float s[BQ / 2], dp[BQ / 2], dk_acc[DP / 2], dv_acc[DP / 2];
    uint32_t pf[BQ / 16][4], df[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const unsigned char* kw = ks + cw * WG_BM * SLAB_BYTES;
    const unsigned char* vw = vs + cw * WG_BM * SLAB_BYTES;

    // turns at the exponentials as in B3
    const int me = BAR_PING + cw, other = BAR_PING + (cw ^ 1);
    hopper::mbar_wait(kv_full, 0);
    if (cw == 1) hopper::named_arrive<2 * WG_THREADS>(BAR_PING);
    const unsigned char *q_prev = qs, *o_prev = dos;  // the stage of tile j - 1
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES;
      const unsigned char* qt = qs + st * C::T_BYTES;
      const unsigned char* ot = dos + st * C::T_BYTES;
      hopper::mbar_wait(full + st, (j / STAGES) & 1);
      // S^T = K Q_j^T and dP^T = V dO_j^T, then dV += p^T_{j-1} dO_{j-1} and
      // dK += dS^T_{j-1} Q_{j-1} behind them (dO and Q read MN-major): they
      // run while this warpgroup computes p^T_j and dS^T_j
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      issue_abt<DP, BQ>(s, kw, qt);
      issue_abt<DP, BQ>(dp, vw, ot);
      hopper::wgmma_commit();
      if (j > 0) {
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(dv_acc);
        hopper::wgmma_fence();
        issue_ab<DP, BQ>(dv_acc, pf, o_prev);
        issue_ab<DP, BQ>(dk_acc, df, q_prev);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S^T and dP^T done, the dV/dK products may still run
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // p^T = exp2(s^T * scale_log2 - lse2[query]) and dS^T = p^T (dP^T -
      // delta[query]); element 4n + e is query column 8n + 2 tq4 + (e & 1)
      hopper::named_sync<2 * WG_THREADS>(me);
      const float* lt = ls + st * BQ;
      const float* dt = dls + st * BQ;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(lt + n * 8 + tq4 * 2);
        const float2 dl = *reinterpret_cast<const float2*>(dt + n * 8 + tq4 * 2);
        const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
        const float dc[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * n + e], scale_log2, -l2[e & 1]));
          s[4 * n + e] = p;
          dp[4 * n + e] = p * (dp[4 * n + e] - dc[e & 1]);
        }
      }
      if (!(cw == 1 && j == ntiles - 1)) hopper::named_arrive<2 * WG_THREADS>(other);
      hopper::wgmma_wait<0>();  // the products of tile j - 1 done: its stage is free
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      if (j > 0) hopper::mbar_arrive(empty + (j - 1) % STAGES);
      to_a_fragments<BQ>(pf, s);
      to_a_fragments<BQ>(df, dp);
      q_prev = qt;
      o_prev = ot;
    }
    // the last tile's dV and dK products
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(dv_acc);
    hopper::wgmma_fence();
    issue_ab<DP, BQ>(dv_acc, pf, o_prev);
    issue_ab<DP, BQ>(dk_acc, df, q_prev);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(dv_acc);
    const int row0 = k0 + cw * WG_BM + warp * 16;  // this warp's 16 keys
    store_rows<DP>(dk + b * dk_sb + (long long)h * D, dk_st, dk_acc, row0, Tk, 0, D, g, tq4,
                   scale);
    store_rows<DP>(dv + b * dv_sb + (long long)h * D, dv_st, dv_acc, row0, Tk, 0, D, g, tq4,
                   1.f);
  }
}

template <int DP>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, int B, int H,
                           int Tq, int Tk, int D, const long long* st, float scale,
                           cudaStream_t stream) {
  using C = DqCfg<DP>;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = operand_map(&mq, q, B, Tq, H, D, st[0], st[1], CTA_BM)) != cudaSuccess) return e;
  if ((e = operand_map(&mk, k, B, Tk, H, D, st[2], st[3], C::BN)) != cudaSuccess) return e;
  if ((e = operand_map(&mv, v, B, Tk, H, D, st[4], st[5], C::BN)) != cudaSuccess) return e;
  if ((e = operand_map(&mdo, dout, B, Tq, H, D, st[6], st[7], CTA_BM)) != cudaSuccess) return e;
  static unsigned long long attr_set = 0;
  if ((e = set_max_dynamic_smem(flash_bwd_dq_wgmma<DP>, C::SMEM, &attr_set)) != cudaSuccess)
    return e;
  dim3 grid((Tq + CTA_BM - 1) / CTA_BM, B * H);
  flash_bwd_dq_wgmma<DP><<<grid, CTA_THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, (bf16*)dq, H, Tq, Tk, D, st[8], st[9], scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv, int B,
                            int H, int Tq, int Tk, int D, const long long* st, float scale,
                            cudaStream_t stream) {
  using C = DkvCfg<DP>;
  CUtensorMap mq, mk, mv, mdo, ml, md;
  cudaError_t e;
  if ((e = operand_map(&mq, q, B, Tq, H, D, st[0], st[1], C::BQ)) != cudaSuccess) return e;
  if ((e = operand_map(&mk, k, B, Tk, H, D, st[2], st[3], CTA_BM)) != cudaSuccess) return e;
  if ((e = operand_map(&mv, v, B, Tk, H, D, st[4], st[5], CTA_BM)) != cudaSuccess) return e;
  if ((e = operand_map(&mdo, dout, B, Tq, H, D, st[6], st[7], C::BQ)) != cudaSuccess) return e;
  const uint64_t row_bytes = (uint64_t)st[12] * 4;
  if ((e = hopper_host::encode_f32_2d(&ml, lse, Tq, (uint64_t)B * H, row_bytes, C::BQ)) !=
      cudaSuccess)
    return e;
  if ((e = hopper_host::encode_f32_2d(&md, delta, Tq, (uint64_t)B * H, row_bytes, C::BQ)) !=
      cudaSuccess)
    return e;
  static unsigned long long attr_set = 0;
  if ((e = set_max_dynamic_smem(flash_bwd_dkv_wgmma<DP>, C::SMEM, &attr_set)) != cudaSuccess)
    return e;
  dim3 grid((Tk + CTA_BM - 1) / CTA_BM, B * H);
  flash_bwd_dkv_wgmma<DP><<<grid, CTA_THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, ml, md, (bf16*)dk, (bf16*)dv, H, Tq, Tk, D, st[8], st[9], st[10], st[11],
      scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int DP>
int plan(int kernel, int* out) {
  if (kernel == 0) {
    out[0] = DqCfg<DP>::BN;
    out[1] = DqCfg<DP>::STAGES;
    out[2] = DqCfg<DP>::SMEM;
  } else if (kernel == 1) {
    out[0] = DkvCfg<DP>::BQ;
    out[1] = DkvCfg<DP>::STAGES;
    out[2] = DkvCfg<DP>::SMEM;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// ------------------------------------------------------------- fp32 path

// B3: BM query rows (64 per consumer warpgroup); K and V tiles of BN keys
// through a ring of STAGES.
template <int DP>
struct DqF32Cfg {
  static constexpr int NC = DP == 160 ? 1 : 2;  // consumer warpgroups
  static constexpr int BM = NC * WG_BM;
  static constexpr int BN = DP <= 64 ? 32 : DP == 80 ? 16 : 8;
  static constexpr int STAGES = DP == 40 ? 4 : 2;
  static constexpr int THREADS = (NC + 1) * WG_THREADS;
  static constexpr int NSLAB = DP / F_SLAB;
  static constexpr int R_BYTES = BM * DP * 4;  // Q or dO, hi (split in place) or lo
  static constexpr int T_BYTES = BN * DP * 4;  // one K or V tile in any of its forms
  // Q and dO hi and lo; per stage K (raw, then hi in place), K lo, V (the
  // same), V lo, K^T hi and K^T lo; the mbarriers; 1 KB of slack to align
  // the base to 1 KB
  static constexpr int SMEM = 4 * R_BYTES + 6 * STAGES * T_BYTES + 256 + 1024;
};

// B4: BM keys; Q and dO tiles of BQ queries, with their lse and delta,
// through a ring of STAGES.  Where dK and dV of 64 keys with their per-tile
// sums would not fit a thread's registers (DP >= 80), the two consumer
// warpgroups share 64 keys and split the columns (CS = 2): each computes
// S^T and dP^T whole and DN = DP / 2 columns of dK and dV.
template <int DP>
struct DkvF32Cfg {
  static constexpr int NC = 2;
  static constexpr int CS = DP >= 80 ? 2 : 1;
  static constexpr int BM = NC / CS * WG_BM;
  static constexpr int DN = DP / CS;
  static constexpr int BQ = DP == 40 ? 32 : DP == 160 ? 8 : 16;
  static constexpr int STAGES = DP == 64 ? 2 : DP == 160 ? 1 : 3;
  static constexpr int THREADS = (NC + 1) * WG_THREADS;
  static constexpr int NSLAB = DP / F_SLAB;
  static constexpr int R_BYTES = BM * DP * 4;                 // K or V, hi or lo
  static constexpr int T_BYTES = BQ * DP * 4;                 // one Q or dO tile in any form
  static constexpr int L_BYTES = (BQ * 4 + 127) / 128 * 128;  // one tile's lse (or delta)
  // K and V hi and lo; per stage Q (raw, then hi in place), Q lo, dO (the
  // same), dO lo, Q^T hi and lo, dO^T hi and lo, lse, delta; the mbarriers;
  // 1 KB of slack
  static constexpr int SMEM = 4 * R_BYTES + STAGES * (8 * T_BYTES + 2 * L_BYTES) + 256 + 1024;
};

template <int R>
__device__ __forceinline__ void add_to(float (&o)[R], const float (&t)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] += t[i];
}

// ------------------------------------------------------------ B3: dQ, fp32

template <int DP>
__global__ void __launch_bounds__(DqF32Cfg<DP>::THREADS, 1)
flash_bwd_dq_tf32(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int H, int Tq, int Tk, int D, long long dq_sb,
                  long long dq_st, float scale, float scale_log2) {
  using C = DqF32Cfg<DP>;
  constexpr int BN = C::BN, STAGES = C::STAGES, BM = C::BM, RB = C::R_BYTES, TB = C::T_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qh = align_1k(smem_raw);
  unsigned char* ql = qh + RB;
  unsigned char* oh = ql + RB;  // dO
  unsigned char* ol = oh + RB;
  unsigned char* kh = ol + RB;  // stage st of each ring at + st * TB
  unsigned char* kl = kh + STAGES * TB;
  unsigned char* vh = kl + STAGES * TB;
  unsigned char* vl = vh + STAGES * TB;
  unsigned char* kth = vl + STAGES * TB;  // K^T
  unsigned char* ktl = kth + STAGES * TB;
  uint64_t* r_full = reinterpret_cast<uint64_t*>(ktl + STAGES * TB);
  uint64_t* r_ready = r_full + 1;
  uint64_t* full = r_ready + 1;
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int ntiles = (Tk + BN - 1) / BN;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(r_full, 1);
    hopper::mbar_init(r_ready, XF_THREADS);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(full + st, 1);
      hopper::mbar_init(ready + st, XF_THREADS);
      hopper::mbar_init(empty + st, C::NC * WG_THREADS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ----------------------------------------- producer: TMA, splits, K^T
    if constexpr (C::NC == 2) hopper::setmaxnreg_dec<56>();
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        hopper::tma_prefetch_desc(&tm_q);
        hopper::tma_prefetch_desc(&tm_k);
        hopper::tma_prefetch_desc(&tm_v);
        hopper::tma_prefetch_desc(&tm_do);
        hopper::mbar_arrive_expect_tx(r_full, 2 * RB);
        for (int c = 0; c < C::NSLAB; ++c) {
          hopper::tma_load_4d(qh + c * BM * SLAB_BYTES, &tm_q, r_full, c * F_SLAB, h, q0, b);
          hopper::tma_load_4d(oh + c * BM * SLAB_BYTES, &tm_do, r_full, c * F_SLAB, h, q0, b);
        }
        for (int j = 0; j < ntiles; ++j) {
          const int st = j % STAGES;
          if (j >= STAGES) hopper::mbar_wait(empty + st, (j / STAGES - 1) & 1);
          hopper::mbar_arrive_expect_tx(full + st, 2 * TB);
          for (int c = 0; c < C::NSLAB; ++c) {
            const int off = st * TB + c * BN * SLAB_BYTES;
            hopper::tma_load_4d(kh + off, &tm_k, full + st, c * F_SLAB, h, j * BN, b);
            hopper::tma_load_4d(vh + off, &tm_v, full + st, c * F_SLAB, h, j * BN, b);
          }
        }
      }
    } else {
      // Warps 1-3: Q and dO into hi (in place) and lo once; per tile K^T
      // (hi and lo) with K split in place on the way, and V split in place.
      // Each hand-over is a proxy fence and an arrival.
      const int t = threadIdx.x - 32;
      hopper::mbar_wait(r_full, 0);
      split_tile(qh, ql, BM * DP / 4, t);
      split_tile(oh, ol, BM * DP / 4, t);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(r_ready);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        hopper::mbar_wait(full + st, (j / STAGES) & 1);
        transpose_tile<DP, BN, true>(kh + st * TB, kl + st * TB, kth + st * TB, ktl + st * TB, t);
        split_tile(vh + st * TB, vl + st * TB, BN * DP / 4, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(ready + st);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::NC == 2) hopper::setmaxnreg_inc<224>();
    const int cw = wg - 1;
    const int local = threadIdx.x - wg * WG_THREADS;
    const int warp = local >> 5, lane = local & 31;
    const int g = lane >> 2, tq4 = lane & 3;
    const int row0 = q0 + cw * WG_BM + warp * 16;  // this warp's 16 query rows

    // lse (log2 domain) and delta of rows g and g + 8; rows past Tq read 0
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + r * 8;
      const bool ok = row < Tq;
      lse2[r] = ok ? lse[(long long)bh * Tq + row] * LOG2E : 0.f;
      dlt[r] = ok ? delta[(long long)bh * Tq + row] : 0.f;
    }
    float s[BN / 2], dp[BN / 2], acc[DP / 2], dqt[DP / 2];
    uint32_t ds_hi[BN / 8][4], ds_lo[BN / 8][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    const int roff = cw * WG_BM * SLAB_BYTES;

    hopper::mbar_wait(r_ready, 0);
    int prev = 0;  // the stage of tile j - 1
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES;
      hopper::mbar_wait(ready + st, (j / STAGES) & 1);
      // S_j = Q K_j^T and dP_j = dO V_j^T, then dS_{j-1} K_{j-1} behind
      // them into a fresh accumulator: it runs while this warpgroup
      // computes dS_j
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      issue_abt_tf32<DP, BM, BN>(s, qh + roff, ql + roff, kh + st * TB, kl + st * TB);
      issue_abt_tf32<DP, BM, BN>(dp, oh + roff, ol + roff, vh + st * TB, vl + st * TB);
      hopper::wgmma_commit();
      if (j > 0) {
        hopper::fence_regs(dqt);
        hopper::wgmma_fence();
        issue_ab_tf32<DP, BN>(dqt, ds_hi, ds_lo, kth + prev * TB, ktl + prev * TB,
                              DP * SLAB_BYTES);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S_j and dP_j done, the dQ product may still run
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // dS = p (dP - delta), p = exp2(s * scale_log2 - lse2); keys past Tk: p = 0
      const int k0 = j * BN;
      const bool tail = k0 + BN > Tk;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(s[i], scale_log2, -lse2[r]));
        if (tail && k0 + (i / 4) * 8 + tq4 * 2 + (i & 1) >= Tk) p = 0.f;
        s[i] = p * (dp[i] - dlt[r]);
      }
      hopper::wgmma_wait<0>();  // dS_{j-1} K_{j-1} done: stage j - 1 is free
      hopper::fence_regs(dqt);
      if (j > 0) {
        hopper::mbar_arrive(empty + prev);
        add_to(acc, dqt);
      }
      to_tf32_fragments<BN>(ds_hi, ds_lo, s);
      prev = st;
    }
    // the last tile's dS K
    hopper::fence_regs(dqt);
    hopper::wgmma_fence();
    issue_ab_tf32<DP, BN>(dqt, ds_hi, ds_lo, kth + prev * TB, ktl + prev * TB, DP * SLAB_BYTES);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dqt);
    add_to(acc, dqt);
    store_rows<DP>(dq + b * dq_sb + (long long)h * D, dq_st, acc, row0, Tq, 0, D, g, tq4,
                   scale);
  }
}

// ------------------------------------------------------- B4: dK/dV, fp32

template <int DP>
__global__ void __launch_bounds__(DkvF32Cfg<DP>::THREADS, 1)
flash_bwd_dkv_tf32(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_lse,
                   const __grid_constant__ CUtensorMap tm_delta, float* __restrict__ dk,
                   float* __restrict__ dv, int H, int Tq, int Tk, int D, long long dk_sb,
                   long long dk_st, long long dv_sb, long long dv_st, float scale,
                   float scale_log2) {
  using C = DkvF32Cfg<DP>;
  constexpr int BQ = C::BQ, STAGES = C::STAGES, BM = C::BM, DN = C::DN;
  constexpr int RB = C::R_BYTES, TB = C::T_BYTES, LB = C::L_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kh = align_1k(smem_raw);
  unsigned char* kl = kh + RB;
  unsigned char* vh = kl + RB;
  unsigned char* vl = vh + RB;
  unsigned char* qh = vl + RB;  // stage st of each ring at + st * TB
  unsigned char* ql = qh + STAGES * TB;
  unsigned char* oh = ql + STAGES * TB;  // dO
  unsigned char* ol = oh + STAGES * TB;
  unsigned char* qth = ol + STAGES * TB;  // Q^T
  unsigned char* qtl = qth + STAGES * TB;
  unsigned char* oth = qtl + STAGES * TB;  // dO^T
  unsigned char* otl = oth + STAGES * TB;
  unsigned char* ls = otl + STAGES * TB;  // stage st at + st * LB
  unsigned char* dls = ls + STAGES * LB;
  uint64_t* r_full = reinterpret_cast<uint64_t*>(dls + STAGES * LB);
  uint64_t* r_ready = r_full + 1;
  uint64_t* full = r_ready + 1;
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BM;
  const int ntiles = (Tq + BQ - 1) / BQ;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(r_full, 1);
    hopper::mbar_init(r_ready, XF_THREADS);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(full + st, 1);
      hopper::mbar_init(ready + st, XF_THREADS);
      hopper::mbar_init(empty + st, C::NC * WG_THREADS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------- producer: TMA, splits, Q^T, dO^T
    hopper::setmaxnreg_dec<56>();
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        hopper::tma_prefetch_desc(&tm_q);
        hopper::tma_prefetch_desc(&tm_k);
        hopper::tma_prefetch_desc(&tm_v);
        hopper::tma_prefetch_desc(&tm_do);
        hopper::tma_prefetch_desc(&tm_lse);
        hopper::tma_prefetch_desc(&tm_delta);
        hopper::mbar_arrive_expect_tx(r_full, 2 * RB);
        for (int c = 0; c < C::NSLAB; ++c) {
          hopper::tma_load_4d(kh + c * BM * SLAB_BYTES, &tm_k, r_full, c * F_SLAB, h, k0, b);
          hopper::tma_load_4d(vh + c * BM * SLAB_BYTES, &tm_v, r_full, c * F_SLAB, h, k0, b);
        }
        for (int j = 0; j < ntiles; ++j) {
          const int st = j % STAGES;
          if (j >= STAGES) hopper::mbar_wait(empty + st, (j / STAGES - 1) & 1);
          hopper::mbar_arrive_expect_tx(full + st, 2 * TB + 2 * BQ * 4);
          for (int c = 0; c < C::NSLAB; ++c) {
            const int off = st * TB + c * BQ * SLAB_BYTES;
            hopper::tma_load_4d(qh + off, &tm_q, full + st, c * F_SLAB, h, j * BQ, b);
            hopper::tma_load_4d(oh + off, &tm_do, full + st, c * F_SLAB, h, j * BQ, b);
          }
          hopper::tma_load_2d(ls + st * LB, &tm_lse, full + st, j * BQ, bh);
          hopper::tma_load_2d(dls + st * LB, &tm_delta, full + st, j * BQ, bh);
        }
      }
    } else {
      // Warps 1-3: K and V into hi (in place) and lo once; per tile Q^T and
      // dO^T (hi and lo), with Q and dO split in place on the way.
      const int t = threadIdx.x - 32;
      hopper::mbar_wait(r_full, 0);
      split_tile(kh, kl, BM * DP / 4, t);
      split_tile(vh, vl, BM * DP / 4, t);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(r_ready);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        hopper::mbar_wait(full + st, (j / STAGES) & 1);
        transpose_tile<DP, BQ, true>(qh + st * TB, ql + st * TB, qth + st * TB, qtl + st * TB, t);
        transpose_tile<DP, BQ, true>(oh + st * TB, ol + st * TB, oth + st * TB, otl + st * TB, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(ready + st);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<224>();
    const int cw = wg - 1;
    const int local = threadIdx.x - wg * WG_THREADS;
    const int warp = local >> 5, lane = local & 31;
    const int g = lane >> 2, tq4 = lane & 3;
    const int rw = C::CS == 2 ? 0 : cw;         // which 64 keys of the CTA's
    const int col0 = C::CS == 2 ? cw * DN : 0;  // the first of its DN columns
    const int roff = rw * WG_BM * SLAB_BYTES;

    float s[BQ / 2], dp[BQ / 2], dk_acc[DN / 2], dv_acc[DN / 2], dkt[DN / 2], dvt[DN / 2];
    uint32_t p_hi[BQ / 8][4], p_lo[BQ / 8][4], d_hi[BQ / 8][4], d_lo[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    // dV += p^T dO and dK += dS^T Q of the tile in `stage` (dO^T and Q^T),
    // each into a fresh accumulator; committed, not waited
    auto issue_dkv = [&](int stage) {
      const int off = stage * TB + col0 * SLAB_BYTES;
      hopper::fence_regs(dkt);
      hopper::fence_regs(dvt);
      hopper::wgmma_fence();
      issue_ab_tf32<DN, BQ>(dvt, p_hi, p_lo, oth + off, otl + off, DP * SLAB_BYTES);
      issue_ab_tf32<DN, BQ>(dkt, d_hi, d_lo, qth + off, qtl + off, DP * SLAB_BYTES);
      hopper::wgmma_commit();
    };
    // With two or more stages a tile's dV and dK products run behind the
    // next tile's S^T and dP^T, while this warpgroup computes that tile's
    // p^T and dS^T, and free its stage then.  With one (DP = 160) they run
    // in their own iteration: the stage must be free before the next tile
    // can land.
    constexpr bool LATE = STAGES > 1;
    hopper::mbar_wait(r_ready, 0);
    int prev = 0;  // the stage of tile j - 1
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES;
      hopper::mbar_wait(ready + st, (j / STAGES) & 1);
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      issue_abt_tf32<DP, BM, BQ>(s, kh + roff, kl + roff, qh + st * TB, ql + st * TB);
      issue_abt_tf32<DP, BM, BQ>(dp, vh + roff, vl + roff, oh + st * TB, ol + st * TB);
      hopper::wgmma_commit();
      if (LATE && j > 0) {
        issue_dkv(prev);
        hopper::wgmma_wait<1>();  // S^T and dP^T done, the dV/dK products may still run
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // p^T = exp2(s^T * scale_log2 - lse2[query]) and dS^T = p^T (dP^T -
      // delta[query]); element 4n + e is query column 8n + 2 tq4 + (e & 1).
      // Queries past Tq: Q = dO = 0 and lse = delta = 0, so p = 1 and dS =
      // 0, and their dO^T and Q^T slots are 0: they add exactly nothing.
      const float* lt = reinterpret_cast<const float*>(ls + st * LB);
      const float* dt = reinterpret_cast<const float*>(dls + st * LB);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(lt + n * 8 + tq4 * 2);
        const float2 dl = *reinterpret_cast<const float2*>(dt + n * 8 + tq4 * 2);
        const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
        const float dc[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * n + e], scale_log2, -l2[e & 1]));
          s[4 * n + e] = p;
          dp[4 * n + e] = p * (dp[4 * n + e] - dc[e & 1]);
        }
      }
      if constexpr (!LATE) {
        to_tf32_fragments<BQ>(p_hi, p_lo, s);
        to_tf32_fragments<BQ>(d_hi, d_lo, dp);
        issue_dkv(st);
      }
      hopper::wgmma_wait<0>();  // the dV/dK products of tile j - 1 (j) done: its stage is free
      hopper::fence_regs(dkt);
      hopper::fence_regs(dvt);
      if (!LATE || j > 0) {
        hopper::mbar_arrive(empty + (LATE ? prev : st));
        add_to(dv_acc, dvt);
        add_to(dk_acc, dkt);
      }
      if constexpr (LATE) {
        to_tf32_fragments<BQ>(p_hi, p_lo, s);
        to_tf32_fragments<BQ>(d_hi, d_lo, dp);
      }
      prev = st;
    }
    if constexpr (LATE) {  // the last tile's dV and dK products
      issue_dkv(prev);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dkt);
      hopper::fence_regs(dvt);
      add_to(dv_acc, dvt);
      add_to(dk_acc, dkt);
    }
    const int row0 = k0 + rw * WG_BM + warp * 16;  // this warp's 16 keys
    store_rows<DN>(dk + b * dk_sb + (long long)h * D, dk_st, dk_acc, row0, Tk, col0, D, g, tq4,
                   scale);
    store_rows<DN>(dv + b * dv_sb + (long long)h * D, dv_st, dv_acc, row0, Tk, col0, D, g, tq4,
                   1.f);
  }
}

template <int DP>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int B, int H, int Tq,
                          int Tk, int D, const long long* st, float scale, cudaStream_t stream) {
  using C = DqF32Cfg<DP>;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = operand_map(&mq, q, B, Tq, H, D, st[0], st[1], C::BM, true)) != cudaSuccess) return e;
  if ((e = operand_map(&mk, k, B, Tk, H, D, st[2], st[3], C::BN, true)) != cudaSuccess) return e;
  if ((e = operand_map(&mv, v, B, Tk, H, D, st[4], st[5], C::BN, true)) != cudaSuccess) return e;
  if ((e = operand_map(&mdo, dout, B, Tq, H, D, st[6], st[7], C::BM, true)) != cudaSuccess)
    return e;
  static unsigned long long attr_set = 0;
  if ((e = set_max_dynamic_smem(flash_bwd_dq_tf32<DP>, C::SMEM, &attr_set)) != cudaSuccess)
    return e;
  dim3 grid((Tq + C::BM - 1) / C::BM, B * H);
  flash_bwd_dq_tf32<DP><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, (float*)dq, H, Tq, Tk, D, st[8], st[9], scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv, int B,
                           int H, int Tq, int Tk, int D, const long long* st, float scale,
                           cudaStream_t stream) {
  using C = DkvF32Cfg<DP>;
  CUtensorMap mq, mk, mv, mdo, ml, md;
  cudaError_t e;
  if ((e = operand_map(&mq, q, B, Tq, H, D, st[0], st[1], C::BQ, true)) != cudaSuccess) return e;
  if ((e = operand_map(&mk, k, B, Tk, H, D, st[2], st[3], C::BM, true)) != cudaSuccess) return e;
  if ((e = operand_map(&mv, v, B, Tk, H, D, st[4], st[5], C::BM, true)) != cudaSuccess) return e;
  if ((e = operand_map(&mdo, dout, B, Tq, H, D, st[6], st[7], C::BQ, true)) != cudaSuccess)
    return e;
  const uint64_t row_bytes = (uint64_t)st[12] * 4;
  if ((e = hopper_host::encode_f32_2d(&ml, lse, Tq, (uint64_t)B * H, row_bytes, C::BQ)) !=
      cudaSuccess)
    return e;
  if ((e = hopper_host::encode_f32_2d(&md, delta, Tq, (uint64_t)B * H, row_bytes, C::BQ)) !=
      cudaSuccess)
    return e;
  static unsigned long long attr_set = 0;
  if ((e = set_max_dynamic_smem(flash_bwd_dkv_tf32<DP>, C::SMEM, &attr_set)) != cudaSuccess)
    return e;
  dim3 grid((Tk + C::BM - 1) / C::BM, B * H);
  flash_bwd_dkv_tf32<DP><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, ml, md, (float*)dk, (float*)dv, H, Tq, Tk, D, st[8], st[9], st[10],
      st[11], scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int DP>
int plan_f32(int kernel, int* out) {
  if (kernel == 0) {
    using C = DqF32Cfg<DP>;
    const int p[5] = {C::BM, DP, C::BN, C::STAGES, C::SMEM};
    for (int i = 0; i < 5; ++i) out[i] = p[i];
  } else if (kernel == 1) {
    using C = DkvF32Cfg<DP>;
    const int p[5] = {C::BM, C::DN, C::BQ, C::STAGES, C::SMEM};
    for (int i = 0; i < 5; ++i) out[i] = p[i];
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// B3.  dtype: 0 = bf16, 1 = fp32.  strides (elements): q_sb, q_st, k_sb, k_st,
// v_sb, v_st, do_sb, do_st, dq_sb, dq_st.  lse, delta: fp32 (B*H, Tq).
// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for a head dim
// the kernel does not take.
int rr_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, int dtype, int B,
                         int H, int Tq, int Tk, int D, long long q_sb, long long q_st,
                         long long k_sb, long long k_st, long long v_sb, long long v_st,
                         long long do_sb, long long do_st, long long dq_sb, long long dq_st,
                         float scale, void* stream) {
  const long long st[10] = {q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st, dq_sb, dq_st};
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (dtype == 1) {
    switch (flash::f32_padded_dim(D)) {
      case 40: return (int)launch_dq_f32<40>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st, scale, s);
      case 64: return (int)launch_dq_f32<64>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st, scale, s);
      case 80: return (int)launch_dq_f32<80>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st, scale, s);
      case 160: return (int)launch_dq_f32<160>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (flash::padded_dim(D)) {
    case 48: return (int)launch_dq_bf16<48>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st, scale, s);
    case 64: return (int)launch_dq_bf16<64>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st, scale, s);
    case 80: return (int)launch_dq_bf16<80>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st, scale, s);
    case 160: return (int)launch_dq_bf16<160>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B4.  strides (elements): q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st,
// dk_sb, dk_st, dv_sb, dv_st, and rows_st, the row stride of lse and delta
// (a multiple of 4, for their TMA map).  Otherwise as rr_flash_attn_bwd_dq.
int rr_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int dtype,
                          int B, int H, int Tq, int Tk, int D, long long q_sb, long long q_st,
                          long long k_sb, long long k_st, long long v_sb, long long v_st,
                          long long do_sb, long long do_st, long long dk_sb, long long dk_st,
                          long long dv_sb, long long dv_st, long long rows_st, float scale,
                          void* stream) {
  const long long st[13] = {q_sb,  q_st,  k_sb,  k_st,  v_sb,  v_st,   do_sb,
                            do_st, dk_sb, dk_st, dv_sb, dv_st, rows_st};
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (rows_st < Tq || rows_st % 4) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    switch (flash::f32_padded_dim(D)) {
      case 40: return (int)launch_dkv_f32<40>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st, scale, s);
      case 64: return (int)launch_dkv_f32<64>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st, scale, s);
      case 80: return (int)launch_dkv_f32<80>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st, scale, s);
      case 160: return (int)launch_dkv_f32<160>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (flash::padded_dim(D)) {
    case 48: return (int)launch_dkv_bf16<48>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st, scale, s);
    case 64: return (int)launch_dkv_bf16<64>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st, scale, s);
    case 80: return (int)launch_dkv_bf16<80>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st, scale, s);
    case 160: return (int)launch_dkv_bf16<160>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tiling of the bf16 instance that takes head dim D, for the Python
// mirror (`bwd_plan` in ops/kernels/flash_attention.py): kernel 0 = B3 (keys
// per K/V tile), 1 = B4 (queries per Q/dO tile); out = {tile, stages,
// dynamic shared memory bytes}.  cudaErrorInvalidValue for a head dim no
// instance takes.
int rr_flash_attn_bwd_plan(int kernel, int D, int* out) {
  switch (flash::padded_dim(D)) {
    case 48: return plan<48>(kernel, out);
    case 64: return plan<64>(kernel, out);
    case 80: return plan<80>(kernel, out);
    case 160: return plan<160>(kernel, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same for the fp32 instances (`bwd_f32_plan`): out = {rows a CTA owns
// (query rows in B3, keys in B4), output columns a consumer warpgroup owns,
// streamed tile, stages, dynamic shared memory bytes}.
int rr_flash_attn_bwd_f32_plan(int kernel, int D, int* out) {
  switch (flash::f32_padded_dim(D)) {
    case 40: return plan_f32<40>(kernel, out);
    case 64: return plan_f32<64>(kernel, out);
    case 80: return plan_f32<80>(kernel, out);
    case 160: return plan_f32<160>(kernel, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
