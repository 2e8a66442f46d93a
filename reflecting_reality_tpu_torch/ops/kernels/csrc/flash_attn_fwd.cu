// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces reflecting_reality_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd, pallas_call at :130): blockwise softmax(Q K^T / sqrt(D)) V
// with an online softmax (running max m, running sum l, fp32 accumulator),
// the l == 0 guard, O written in the input dtype and the logsumexp m + log l
// written as fp32 (B*H, Tq) in natural-log units (the backward kernels read it).
//
// Layout: q/k/v/o are (B, T, H, D) with the last two dims packed (stride of H
// is D, stride of D is 1); the batch and token strides are arguments, so the
// q/k/v column slices of a fused qkv projection are read in place.
//
// What bounds it.  At the UNet's level-0 self-attention, (2, 4096, 8, 40)
// bf16, Q K^T and P V are 4*B*H*T^2*D = 4.3e10 FLOP (43 us at 989 TFLOP/s;
// 52 us with D padded to 48), q/k/v/o are 10.5 MB (3 us at 3.35 TB/s), and
// the softmax takes one exp2 per logit: B*H*T^2 = 2.7e8, at 16 per clock per
// SM on the multi-function unit about 64 us at 1.98 GHz.  So the
// exponentials, with the fp32 softmax work around them (~5 FP32 operations
// per logit), set the floor, then the tensor cores; bytes do not matter.
//
// bf16 path (every head dim, D % 8 == 0, D <= 160), a warp-specialised
// wgmma + TMA kernel, one CTA of three warpgroups per (b*h, 128 query rows):
//  - Producer warpgroup (setmaxnreg 24): one thread issues TMA loads, Q once
//    and the K and V tiles of BN keys into a ring of STAGES stages, each
//    stage guarded by a full mbarrier (TMA bytes) and an empty one (all 256
//    consumer threads arrive once the stage's products have completed).
//  - Two consumer warpgroups (setmaxnreg 240), 64 query rows each, so every
//    K/V tile brought from L2 serves 128 rows (the mma.sync kernel it
//    replaces had 64): half the L2 -> shared traffic.  S = Q K^T is wgmma
//    with Q and K in shared memory, both K-major as they lie; O += P V is wgmma with P in registers
//    (the S accumulator converted to bf16 is already the A-register
//    fragment) and V in shared memory as an MN-major (transposed) operand.
//  - Overlap: each iteration issues S_j = Q K_j^T, rescales O, issues
//    O += P_{j-1} V_{j-1}, waits for S_j only and computes the softmax of
//    S_j while P V is still in the tensor cores (the order of
//    FlashAttention-3's intra-warpgroup pipelining, which keeps every
//    register an asynchronous wgmma writes untouched until its wait).  The
//    two consumer warpgroups also take turns at the softmax on named
//    barriers, so one group's exponentials run while the other group's
//    products are in flight.
//  - Head-dim padding without copies: the tensor maps are 4-D (D, H, T, B)
//    over the strided q/k/v with boxes 16 columns wide; columns past D (and
//    rows past T) are out of bounds and TMA writes zeros, so no other
//    head's data is read and D = 40 pads to 48, not 64.
//  - Swizzle: each 16-column slab is 32 bytes wide and loaded with the
//    32-byte swizzle, which wgmma reads directly (K-major for Q and K,
//    MN-major for V).  One 64-column box with the 128-byte swizzle was the
//    other choice; it would pad D = 40 to 64 (4/3 the tensor work of the 48
//    used here) and D = 80 to 128, while 16-column slabs pad 40 -> 48 and
//    keep 80 and 160 exact, at the price of DP/16 TMA issues per tile.
//  - BN = 128 keys per tile for DP <= 80; 64 for DP = 160, where three
//    stages of 128-key tiles would not fit in shared memory beside Q.
//  - The softmax runs in fp32 in the log2 domain (one FFMA + ex2 per
//    logit, the scale log2(e)/sqrt(D) using the true head dim D).  Ragged
//    tails: query rows past Tq are zero-filled and never stored, keys past
//    Tk get -inf.
//
// fp32 path (the parity pipelines): CUDA-core FMAs, one warp per 4 query
// rows, 32-key tiles in shared memory, one key per lane for Q K^T and one
// head-dim column per lane for P V; each K and V element read from shared
// memory serves all 4 rows.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

template <int DP>
struct Cfg {
  static constexpr int BN = DP <= 80 ? 128 : 64;
  static constexpr int STAGES = DP == 160 ? 3 : 4;
  static constexpr int NSLAB = DP / SLAB;
  static constexpr int Q_BYTES = CTA_BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;  // one K (or V) tile
  // operands, then the mbarriers; 1 KB of slack to align the base to 1 KB
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 256 + 1024;
};

// One consumer warpgroup's view of the K/V ring and its softmax state.
template <int DP>
struct Consumer {
  using C = Cfg<DP>;
  static constexpr int BN = C::BN;

  const unsigned char* qs;  // this warpgroup's 64 rows of the first Q slab
  const unsigned char* ks;
  const unsigned char* vs;
  uint64_t* k_full;
  uint64_t* v_full;
  int Tk, tq4;
  float scale_log2;
  float m_run[2], l_run[2];

  // S = Q K_j^T (asynchronous: committed, not waited)
  __device__ __forceinline__ void issue_s(float (&s)[BN / 2], int j) const {
    const int st = j % C::STAGES;
    hopper::mbar_wait(k_full + st, (j / C::STAGES) & 1);
    hopper::fence_regs(s);
    hopper::wgmma_fence();
    issue_abt<DP, BN>(s, qs, ks + st * C::KV_BYTES);
    hopper::wgmma_commit();
  }

  // O += P V_j (asynchronous); V is the MN-major operand
  __device__ __forceinline__ void issue_pv(float (&o)[DP / 2], const uint32_t (&p)[BN / 16][4],
                                           int j) const {
    const int st = j % C::STAGES;
    hopper::mbar_wait(v_full + st, (j / C::STAGES) & 1);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
    issue_ab<DP, BN>(o, p, vs + st * C::KV_BYTES);
    hopper::wgmma_commit();
  }

  // Online softmax of tile j in the log2 domain, in place: mask tail keys
  // (last tile only), row max of the raw logits (scale > 0 commutes with
  // max), then p = exp2(s * scale_log2 - m) as one FFMA + EX2 per logit.
  // Returns the factors that rescale O and l for rows g and g + 8.
  __device__ __forceinline__ void softmax(float (&s)[BN / 2], int j, float (&corr)[2]) {
    const int k0 = j * BN;
    if (k0 + BN > Tk) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        if (k0 + (i / 4) * 8 + tq4 * 2 + (i & 1) >= Tk) s[i] = -INFINITY;
    }
    // row max and row sum over 4 independent partials each: one warp per
    // scheduler runs the softmax at a time, so latency chains, not
    // throughput, would otherwise set its pace
    float mp[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) mp[r][q] = -INFINITY;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 4) {
      const int q = (i / 4) % 4;
      mp[0][q] = fmaxf(mp[0][q], fmaxf(s[i], s[i + 1]));
      mp[1][q] = fmaxf(mp[1][q], fmaxf(s[i + 2], s[i + 3]));
    }
    float mx[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // all keys masked so far: no NaN
      corr[r] = ex2(m_run[r] - mu[r]);
      m_run[r] = m_new;
    }
    float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const float e = ex2(fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]));
      s[i] = e;
      rs[(i >> 1) & 1][(i / 4) % 4] += e;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l_run[r] = l_run[r] * corr[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
  }
};

template <int R>
__device__ __forceinline__ void rescale(float (&o)[R], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] *= corr[(i >> 1) & 1];
}

template <int DP>
__global__ void __launch_bounds__(CTA_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int H, int Tq, int Tk, int D, long long o_sb,
                long long o_st, float scale_log2) {
  using C = Cfg<DP>;
  constexpr int BN = C::BN, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1k(smem_raw);
  unsigned char* ks = qs + C::Q_BYTES;          // stage st at ks + st * KV_BYTES
  unsigned char* vs = ks + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * CTA_BM;
  const int ntiles = (Tk + BN - 1) / BN;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(k_full + st, 1);
      hopper::mbar_init(v_full + st, 1);
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
      hopper::mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::NSLAB; ++c)
        hopper::tma_load_4d(qs + c * CTA_BM * SLAB_BYTES, &tm_q, q_full, c * SLAB, h, q0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) hopper::mbar_wait(empty + st, (j / STAGES - 1) & 1);
        hopper::mbar_arrive_expect_tx(k_full + st, C::KV_BYTES);
        for (int c = 0; c < C::NSLAB; ++c)
          hopper::tma_load_4d(ks + st * C::KV_BYTES + c * BN * SLAB_BYTES, &tm_k, k_full + st,
                              c * SLAB, h, j * BN, b);
        hopper::mbar_arrive_expect_tx(v_full + st, C::KV_BYTES);
        for (int c = 0; c < C::NSLAB; ++c)
          hopper::tma_load_4d(vs + st * C::KV_BYTES + c * BN * SLAB_BYTES, &tm_v, v_full + st,
                              c * SLAB, h, j * BN, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int local = threadIdx.x - wg * WG_THREADS;
    const int warp = local >> 5, lane = local & 31;
    const int g = lane >> 2, tq4 = lane & 3;

    Consumer<DP> c;
    c.qs = qs + cw * WG_BM * SLAB_BYTES;
    c.ks = ks;
    c.vs = vs;
    c.k_full = k_full;
    c.v_full = v_full;
    c.Tk = Tk;
    c.tq4 = tq4;
    c.scale_log2 = scale_log2;
    c.m_run[0] = c.m_run[1] = -INFINITY;
    c.l_run[0] = c.l_run[1] = 0.f;
    float s[BN / 2], acc[DP / 2], corr[2];
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    // The two consumers take turns at the softmax (named barriers 1, 2;
    // consumer 0 first), so one group's exponentials run while the other
    // group's products are in the tensor cores.  Consumer 1 skips its last
    // hand-over, so both barriers end with as many arrivals as waits.
    const int me = BAR_PING + cw, other = BAR_PING + (cw ^ 1);
    hopper::mbar_wait(q_full, 0);
    if (cw == 1) hopper::named_arrive<2 * WG_THREADS>(BAR_PING);
    c.issue_s(s, 0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::named_sync<2 * WG_THREADS>(me);
    c.softmax(s, 0, corr);
    if (!(cw == 1 && ntiles == 1)) hopper::named_arrive<2 * WG_THREADS>(other);
    to_a_fragments<BN>(p, s);
    for (int j = 1; j < ntiles; ++j) {
      // S_j is issued first; P_{j-1} V_{j-1} runs on the tensor cores while
      // this warpgroup computes the softmax of S_j
      c.issue_s(s, j);
      rescale(acc, corr);
      c.issue_pv(acc, p, j - 1);
      hopper::wgmma_wait<1>();  // S_j done, P V may still run
      hopper::fence_regs(s);
      hopper::named_sync<2 * WG_THREADS>(me);
      c.softmax(s, j, corr);
      if (!(cw == 1 && j == ntiles - 1)) hopper::named_arrive<2 * WG_THREADS>(other);
      hopper::wgmma_wait<0>();  // P_{j-1} V_{j-1} done: stage j-1 is free
      hopper::fence_regs(acc);
      hopper::mbar_arrive(empty + (j - 1) % STAGES);
      to_a_fragments<BN>(p, s);
    }
    rescale(acc, corr);
    c.issue_pv(acc, p, ntiles - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = c.l_run[r];
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __nv_bfloat16* og = o + b * o_sb + (long long)h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + cw * WG_BM + warp * 16 + g + r * 8;
      if (row >= Tq) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / l_safe;
      __nv_bfloat16* orow = og + (long long)row * o_st;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + tq4 * 2;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
      }
      if (tq4 == 0) lse[(long long)bh * Tq + row] = c.m_run[r] * LN2 + logf(l_safe);
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int H, int Tq, int Tk, int D, const long long* st,
                        float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = operand_map(&mq, q, B, Tq, H, D, st[0], st[1], CTA_BM)) != cudaSuccess) return e;
  if ((e = operand_map(&mk, k, B, Tk, H, D, st[2], st[3], C::BN)) != cudaSuccess) return e;
  if ((e = operand_map(&mv, v, B, Tk, H, D, st[4], st[5], C::BN)) != cudaSuccess) return e;
  static bool attr_set = false;
  if (!attr_set) {
    e = cudaFuncSetAttribute(flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((Tq + CTA_BM - 1) / CTA_BM, B * H);
  flash_fwd_wgmma<DP><<<grid, CTA_THREADS, C::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, lse, H, Tq, Tk, D, st[6], st[7], scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path

constexpr int F_WARPS = 4;
constexpr int F_ROWS = 4;                 // query rows per warp
constexpr int F_BM = F_WARPS * F_ROWS;    // 16 query rows per CTA
constexpr int F_BN = 32;                  // keys per tile, one per lane
constexpr int F_MAXCH = (MAX_D + 31) / 32;  // head-dim columns per lane

__global__ void __launch_bounds__(F_WARPS * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int H, int Tq, int Tk, int D, long long q_sb, long long q_st, long long k_sb,
              long long k_st, long long v_sb, long long v_st, long long o_sb, long long o_st,
              float scale) {
  extern __shared__ float fsm[];
  const int LDK = D + 1;  // odd stride: lane j reads row j without conflicts
  float* Qs = fsm;                 // [F_BM][D]
  float* Ks = Qs + F_BM * D;       // [F_BN][D + 1]
  float* Vs = Ks + F_BN * LDK;     // [F_BN][D]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * F_BM;
  const float* qg = q + b * q_sb + (long long)h * D;
  const float* kg = k + b * k_sb + (long long)h * D;
  const float* vg = v + b * v_sb + (long long)h * D;
  float* og = o + b * o_sb + (long long)h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = (D + 31) / 32;

  for (int i = threadIdx.x; i < F_BM * D; i += blockDim.x) {
    const int r = i / D, c = i % D, row = q0 + r;
    Qs[i] = row < Tq ? qg[(long long)row * q_st + c] : 0.f;
  }

  float acc[F_ROWS][F_MAXCH];
  float m_run[F_ROWS], l_run[F_ROWS];
#pragma unroll
  for (int r = 0; r < F_ROWS; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < F_MAXCH; ++i) acc[r][i] = 0.f;
  }
  const float* qw = Qs + warp * F_ROWS * D;

  for (int k0 = 0; k0 < Tk; k0 += F_BN) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BN * D; i += blockDim.x) {
      const int r = i / D, c = i % D, row = k0 + r;
      const bool ok = row < Tk;
      Ks[r * LDK + c] = ok ? kg[(long long)row * k_st + c] : 0.f;
      Vs[i] = ok ? vg[(long long)row * v_st + c] : 0.f;
    }
    __syncthreads();
    const bool valid = k0 + lane < Tk;

    float dot[F_ROWS] = {0.f, 0.f, 0.f, 0.f};
    const float* kr = Ks + lane * LDK;
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int rr = 0; rr < F_ROWS; ++rr) dot[rr] = fmaf(qw[rr * D + d], kv, dot[rr]);
    }
    float p[F_ROWS];
#pragma unroll
    for (int rr = 0; rr < F_ROWS; ++rr) {
      const float sv = valid ? dot[rr] * scale : -INFINITY;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[rr], mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      p[rr] = expf(sv - mu);
      const float corr = expf(m_run[rr] - mu);
      m_run[rr] = m_new;
      float ps = p[rr];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run[rr] = l_run[rr] * corr + ps;
#pragma unroll
      for (int i = 0; i < F_MAXCH; ++i) acc[rr][i] *= corr;
    }
    for (int j = 0; j < F_BN; ++j) {
      float pj[F_ROWS];
#pragma unroll
      for (int rr = 0; rr < F_ROWS; ++rr) pj[rr] = __shfl_sync(0xffffffffu, p[rr], j);
      const float* vr = Vs + j * D;
#pragma unroll
      for (int i = 0; i < F_MAXCH; ++i) {
        const int d = lane + 32 * i;
        if (i < nch && d < D) {
          const float vv = vr[d];
#pragma unroll
          for (int rr = 0; rr < F_ROWS; ++rr) acc[rr][i] = fmaf(pj[rr], vv, acc[rr][i]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < F_ROWS; ++rr) {
    const int row = q0 + warp * F_ROWS + rr;
    if (row >= Tq) continue;
    const float l_safe = l_run[rr] == 0.f ? 1.f : l_run[rr];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int i = 0; i < F_MAXCH; ++i) {
      const int d = lane + 32 * i;
      if (i < nch && d < D) og[(long long)row * o_st + d] = acc[rr][i] * inv;
    }
    if (lane == 0) lse[(long long)bh * Tq + row] = m_run[rr] + logf(l_safe);
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int Tq, int Tk, int D, const long long* st, float scale,
                       cudaStream_t stream) {
  const int smem = (F_BM * D + F_BN * (D + 1) + F_BN * D) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + F_BM - 1) / F_BM, B * H);
  flash_fwd_f32<<<grid, F_WARPS * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, H, Tq, Tk, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32.  strides: q_sb, q_st, k_sb, k_st, v_sb, v_st,
// o_sb, o_st in elements.  Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a head dim the kernel does not take.
int rr_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                      int dtype, int B, int H, int Tq, int Tk, int D,
                      long long q_sb, long long q_st, long long k_sb, long long k_st,
                      long long v_sb, long long v_st, long long o_sb, long long o_st,
                      float scale, void* stream) {
  const long long st[8] = {q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st};
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == 1) {
    if (D <= 0 || D > flash::MAX_D) return (int)cudaErrorInvalidValue;
    return (int)launch_f32(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (flash::padded_dim(D)) {
    case 48: return (int)launch_bf16<48>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
    case 64: return (int)launch_bf16<64>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
    case 80: return (int)launch_bf16<80>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
    case 160: return (int)launch_bf16<160>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
