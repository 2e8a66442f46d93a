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
// fp32 path (every head dim, D % 8 == 0, D <= 160; instances at 40, 64, 80
// and 160), the test CLI's default dtype and the parity runs: the same
// warp-specialised shape on the TF32 tensor cores with error-compensated
// products.
//  - What bounds it.  One TF32 pass keeps about three decimal digits, which
//    misses the fp32 tolerances (1e-4 of the output's max) by an order of
//    magnitude.  Each operand x is split into hi = x with its low 13
//    mantissa bits cleared and lo = x - hi with its own cleared (both exact
//    TF32 values, `hopper::tf32_split`), and each product is three
//    passes into one fp32 accumulator, hi*lo + lo*hi + hi*hi (CUTLASS's
//    "3xTF32"; lo*lo is below fp32's last bit): 3 * 4*B*H*T^2*D = 1.3e11
//    FLOP at (2, 4096, 8, 40), 0.26 ms at 495 TFLOP/s, against 0.64 ms for
//    the same work on the CUDA cores (67 TFLOP/s) and 0.064 ms of
//    exponentials.  So the tensor cores bound it, then the work that feeds
//    them: the split and the V transpose below, which share the SM's issue
//    slots and shared memory with the products.
//  - Producer warpgroup (setmaxnreg 56): thread 0 issues the TMA loads (Q
//    once, K and V tiles of BN keys into a ring of STAGES stages, one full
//    mbarrier each); warps 1-3 turn what landed into what the products
//    read: Q and K into hi (in place) and lo, V into V^T hi and lo, and
//    hand each over on its own mbarrier (q_ready, k_ready, v_ready) after a
//    proxy fence.  So S_j may start before V_j is transposed.
//  - TF32 wgmma takes K-major operands only (no transpose for 32-bit
//    types).  Q and K are K-major as they lie, each 8-column slab exactly
//    one k8 step in the 32-byte swizzle (D = 40 is 5 slabs, no padding).
//    V as it lies is MN-major for O += P V, so warps 1-3 write it
//    transposed, 8 keys per slab of DP rows.
//  - Each tile's P V goes to a fresh accumulator that fp32 FMAs add to O:
//    the tensor cores do not round their fp32 sums to nearest, and one
//    accumulator carried over Tk = 4096 keys drifted by 2.2e-5 of the
//    output's max (2.9e-5 relative L2) at (2, 4096, 8, 40), against 2.2e-6
//    (1.3e-6) with a fresh one a tile (H100 runs of chip_smoke.bench_flash).
//  - P stays in registers.  The fp32 accumulator gives thread (g, c) columns
//    2c and 2c+1 of each 8, the TF32 A fragment wants columns c and c+4:
//    instead of shuffling P, V^T's slot s holds key 2*(s%4) + s/4, so the
//    accumulator already is the fragment (keys past Tk have p = 0 and
//    zero-filled V rows in any order).  P's hi/lo split is in registers.
//  - Two consumer warpgroups of 64 query rows (one for DP = 160, where Q hi
//    and lo of 128 rows alone would take 160 KB), the bf16 kernel's overlap
//    order (S_j and P_{j-1} V_{j-1} issued, the softmax of S_j while P V
//    runs), the same log2-domain softmax, masking and l == 0 guard.  Not
//    its turn-taking at the softmax: here the exponentials are a quarter of
//    the products' time, and without the named barriers the kernel ran 9%
//    faster.  At DP = 40 each thread holds Q's hi and lo A fragments in
//    registers (40 of them), so S reads only K from shared memory: 10%.
//  - Shared memory, 4 bytes an element: Q hi and lo, and per stage K (hi in
//    place), K lo, raw V, V^T hi and V^T lo.  BN and STAGES per instance:
//    64 x 3 at DP 40, 64 x 2 at 64, 32 x 2 at 80, 16 x 2 at 160 (186-231 KB).

#include "flash_common.cuh"
#include "hopper.cuh"
#include "launch.cuh"

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

// The online softmax of one consumer warpgroup over N-key tiles (N/2
// accumulators a thread: rows g and g + 8, columns (i / 4) * 8 + 2 * tq4 +
// (i & 1)), with its running max and sum.
template <int N>
struct OnlineSoftmax {
  int Tk, tq4;
  float scale_log2;
  float m_run[2], l_run[2];

  // Online softmax of tile j in the log2 domain, in place: mask tail keys
  // (last tile only), row max of the raw logits (scale > 0 commutes with
  // max), then p = exp2(s * scale_log2 - m) as one FFMA + EX2 per logit.
  // Returns the factors that rescale O and l for rows g and g + 8.
  __device__ __forceinline__ void softmax(float (&s)[N / 2], int j, float (&corr)[2]) {
    const int k0 = j * N;
    if (k0 + N > Tk) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
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
    for (int i = 0; i < N / 2; i += 4) {
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
    for (int i = 0; i < N / 2; ++i) {
      const float e = ex2(fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]));
      s[i] = e;
      rs[(i >> 1) & 1][(i / 4) % 4] += e;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l_run[r] = l_run[r] * corr[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
  }

  __device__ __forceinline__ void init(int tk, int t4, float sl2) {
    Tk = tk;
    tq4 = t4;
    scale_log2 = sl2;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.f;
  }

  // l summed over the row's four threads
  __device__ __forceinline__ float row_sum(int r) const {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    return l;
  }
};

// One consumer warpgroup's view of the K/V ring and its softmax state.
template <int DP>
struct Consumer : OnlineSoftmax<Cfg<DP>::BN> {
  using C = Cfg<DP>;
  static constexpr int BN = C::BN;

  const unsigned char* qs;  // this warpgroup's 64 rows of the first Q slab
  const unsigned char* ks;
  const unsigned char* vs;
  uint64_t* k_full;
  uint64_t* v_full;

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
    c.init(Tk, tq4, scale_log2);
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

    const float l[2] = {c.row_sum(0), c.row_sum(1)};
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
  static unsigned long long attr_set = 0;
  if ((e = set_max_dynamic_smem(flash_fwd_wgmma<DP>, C::SMEM, &attr_set)) != cudaSuccess)
    return e;
  dim3 grid((Tq + CTA_BM - 1) / CTA_BM, B * H);
  flash_fwd_wgmma<DP><<<grid, CTA_THREADS, C::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, lse, H, Tq, Tk, D, st[6], st[7], scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path

template <int DP>
struct F32Cfg {
  static constexpr int NC = DP == 160 ? 1 : 2;  // consumer warpgroups
  static constexpr int BM = NC * WG_BM;         // query rows a CTA owns
  static constexpr int BN = DP == 160 ? 16 : DP == 80 ? 32 : 64;
  static constexpr int STAGES = DP == 40 ? 3 : 2;
  static constexpr int THREADS = (NC + 1) * WG_THREADS;
  static constexpr int NSLAB = DP / F_SLAB;
  // Q hi and lo held as A fragments (DP registers a thread): S then reads
  // only K from shared memory.  Where the registers allow it, at DP = 40.
  static constexpr bool Q_REGS = DP == 40;
  static constexpr int Q_BYTES = BM * DP * 4;  // Q hi (split in place) or Q lo
  static constexpr int T_BYTES = BN * DP * 4;  // one K or V tile in any of its forms
  // Q hi and lo; per stage K (raw, then hi in place), K lo, raw V, V^T hi
  // and V^T lo; the mbarriers; 1 KB of slack to align the base to 1 KB
  static constexpr int SMEM = 2 * Q_BYTES + 5 * STAGES * T_BYTES + 256 + 1024;
};

// One consumer warpgroup of the fp32 kernel: its Q rows, the split K/V ring
// and its softmax state.  Each product is three TF32 wgmma passes into one
// accumulator, the small terms first: hi * lo, lo * hi, then hi * hi.
template <int DP>
struct F32Consumer : OnlineSoftmax<F32Cfg<DP>::BN> {
  using C = F32Cfg<DP>;
  static constexpr int BN = C::BN;

  const unsigned char* qh;  // this warpgroup's 64 rows of the first Q hi / lo slab
  const unsigned char* ql;
  const unsigned char* kh;  // stage 0 of each ring
  const unsigned char* kl;
  const unsigned char* vth;
  const unsigned char* vtl;
  uint64_t* k_ready;
  uint64_t* v_ready;
  uint32_t q_hi[C::Q_REGS ? C::NSLAB : 1][4], q_lo[C::Q_REGS ? C::NSLAB : 1][4];

  // With Q_REGS: this thread's A fragments of Q hi and lo, once Q is split.
  // Slab cs, rows g and g + 8 of this warp's 16, columns c and c + 4 (the
  // 16-byte halves of a 32-byte row, swapped on rows with bit 2 set).
  __device__ __forceinline__ void load_q(int warp, int g, int tq4) {
    if constexpr (C::Q_REGS) {
#pragma unroll
      for (int cs = 0; cs < C::NSLAB; ++cs)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int row = warp * 16 + g + 8 * (a & 1), half = a >> 1;
          const int off = cs * C::BM * SLAB_BYTES + row * SLAB_BYTES +
                          ((half ^ ((row >> 2) & 1)) << 4) + tq4 * 4;
          q_hi[cs][a] = *reinterpret_cast<const uint32_t*>(qh + off);
          q_lo[cs][a] = *reinterpret_cast<const uint32_t*>(ql + off);
        }
    }
  }

  // S = Q K_j^T (asynchronous: committed, not waited)
  __device__ __forceinline__ void issue_s(float (&s)[BN / 2], int j) const {
    const int st = j % C::STAGES;
    hopper::mbar_wait(k_ready + st, (j / C::STAGES) & 1);
    const unsigned char* k_hi = kh + st * C::T_BYTES;
    const unsigned char* k_lo = kl + st * C::T_BYTES;
    hopper::fence_regs(s);
    hopper::wgmma_fence();
    if constexpr (C::Q_REGS) {
#pragma unroll
      for (int c = 0; c < C::NSLAB; ++c)
        hopper::wgmma_rs_tf32<BN>(s, q_hi[c], kmajor(k_lo + c * BN * SLAB_BYTES), c > 0);
#pragma unroll
      for (int c = 0; c < C::NSLAB; ++c)
        hopper::wgmma_rs_tf32<BN>(s, q_lo[c], kmajor(k_hi + c * BN * SLAB_BYTES), 1);
#pragma unroll
      for (int c = 0; c < C::NSLAB; ++c)
        hopper::wgmma_rs_tf32<BN>(s, q_hi[c], kmajor(k_hi + c * BN * SLAB_BYTES), 1);
    } else {
      issue_abt_tf32<DP, C::BM, BN>(s, qh, ql, k_hi, k_lo);
    }
    hopper::wgmma_commit();
  }

  // pv = P V_j (asynchronous), V^T K-major in 8-key slabs of DP rows: a
  // fresh accumulator a tile, which fp32 FMAs add to O.
  __device__ __forceinline__ void issue_pv(float (&pv)[DP / 2], const uint32_t (&p_hi)[BN / 8][4],
                                           const uint32_t (&p_lo)[BN / 8][4], int j) const {
    const int st = j % C::STAGES;
    hopper::mbar_wait(v_ready + st, (j / C::STAGES) & 1);
    const unsigned char* v_hi = vth + st * C::T_BYTES;
    const unsigned char* v_lo = vtl + st * C::T_BYTES;
    hopper::fence_regs(pv);
    hopper::wgmma_fence();
    issue_ab_tf32<DP, BN>(pv, p_hi, p_lo, v_hi, v_lo, DP * SLAB_BYTES);
    hopper::wgmma_commit();
  }
};

// o = o * corr + pv, rows g and g + 8
template <int R>
__device__ __forceinline__ void rescale_add(float (&o)[R], const float (&corr)[2],
                                            const float (&pv)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] = fmaf(o[i], corr[(i >> 1) & 1], pv[i]);
}

template <int DP>
__global__ void __launch_bounds__(F32Cfg<DP>::THREADS, 1)
flash_fwd_tf32(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
               float* __restrict__ lse, int H, int Tq, int Tk, int D, long long o_sb,
               long long o_st, float scale_log2) {
  using C = F32Cfg<DP>;
  constexpr int BN = C::BN, STAGES = C::STAGES, BM = C::BM, TB = C::T_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qh = align_1k(smem_raw);
  unsigned char* ql = qh + C::Q_BYTES;
  unsigned char* kh = ql + C::Q_BYTES;  // stage st of each ring at + st * TB
  unsigned char* kl = kh + STAGES * TB;
  unsigned char* vr = kl + STAGES * TB;
  unsigned char* vth = vr + STAGES * TB;
  unsigned char* vtl = vth + STAGES * TB;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vtl + STAGES * TB);
  uint64_t* q_ready = q_full + 1;
  uint64_t* full = q_ready + 1;
  uint64_t* k_ready = full + STAGES;
  uint64_t* v_ready = k_ready + STAGES;
  uint64_t* empty = v_ready + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int ntiles = (Tk + BN - 1) / BN;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_ready, XF_THREADS);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(full + st, 1);
      hopper::mbar_init(k_ready + st, XF_THREADS);
      hopper::mbar_init(v_ready + st, XF_THREADS);
      hopper::mbar_init(empty + st, C::NC * WG_THREADS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ----------------------------------------- producer: TMA, split, V^T
    if constexpr (C::NC == 2) hopper::setmaxnreg_dec<56>();
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        hopper::tma_prefetch_desc(&tm_q);
        hopper::tma_prefetch_desc(&tm_k);
        hopper::tma_prefetch_desc(&tm_v);
        hopper::mbar_arrive_expect_tx(q_full, C::Q_BYTES);
        for (int c = 0; c < C::NSLAB; ++c)
          hopper::tma_load_4d(qh + c * BM * SLAB_BYTES, &tm_q, q_full, c * F_SLAB, h, q0, b);
        for (int j = 0; j < ntiles; ++j) {
          const int st = j % STAGES;
          if (j >= STAGES) hopper::mbar_wait(empty + st, (j / STAGES - 1) & 1);
          hopper::mbar_arrive_expect_tx(full + st, 2 * TB);
          for (int c = 0; c < C::NSLAB; ++c) {
            hopper::tma_load_4d(kh + st * TB + c * BN * SLAB_BYTES, &tm_k, full + st,
                                c * F_SLAB, h, j * BN, b);
            hopper::tma_load_4d(vr + st * TB + c * BN * SLAB_BYTES, &tm_v, full + st,
                                c * F_SLAB, h, j * BN, b);
          }
        }
      }
    } else {
      // Warps 1-3 turn each landed operand into what the TF32 products read;
      // each hand-over is a proxy fence (generic writes before wgmma's
      // async reads) and an arrival on the barrier the consumers wait for.
      const int t = threadIdx.x - 32;
      hopper::mbar_wait(q_full, 0);
      split_tile(qh, ql, BM * DP / 4, t);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(q_ready);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        hopper::mbar_wait(full + st, (j / STAGES) & 1);
        split_tile(kh + st * TB, kl + st * TB, BN * DP / 4, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(k_ready + st);
        transpose_tile<DP, BN, false>(vr + st * TB, nullptr, vth + st * TB, vtl + st * TB, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(v_ready + st);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::NC == 2) hopper::setmaxnreg_inc<224>();
    const int cw = wg - 1;
    const int local = threadIdx.x - wg * WG_THREADS;
    const int warp = local >> 5, lane = local & 31;
    const int g = lane >> 2, tq4 = lane & 3;

    F32Consumer<DP> c;
    c.qh = qh + cw * WG_BM * SLAB_BYTES;
    c.ql = ql + cw * WG_BM * SLAB_BYTES;
    c.kh = kh;
    c.kl = kl;
    c.vth = vth;
    c.vtl = vtl;
    c.k_ready = k_ready;
    c.v_ready = v_ready;
    c.init(Tk, tq4, scale_log2);
    float s[BN / 2], acc[DP / 2], pv[DP / 2], corr[2], corr_pv[2];
    uint32_t p_hi[BN / 8][4], p_lo[BN / 8][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    hopper::mbar_wait(q_ready, 0);
    c.load_q(warp, g, tq4);
    c.issue_s(s, 0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    c.softmax(s, 0, corr);
    to_tf32_fragments<BN>(p_hi, p_lo, s);
    for (int j = 1; j < ntiles; ++j) {
      // S_j is issued first; P_{j-1} V_{j-1} runs on the tensor cores while
      // this warpgroup computes the softmax of S_j
      c.issue_s(s, j);
      c.issue_pv(pv, p_hi, p_lo, j - 1);
      corr_pv[0] = corr[0];
      corr_pv[1] = corr[1];
      hopper::wgmma_wait<1>();  // S_j done, P V may still run
      hopper::fence_regs(s);
      c.softmax(s, j, corr);
      hopper::wgmma_wait<0>();  // P_{j-1} V_{j-1} done: stage j-1 is free
      hopper::fence_regs(pv);
      hopper::mbar_arrive(empty + (j - 1) % STAGES);
      rescale_add(acc, corr_pv, pv);
      to_tf32_fragments<BN>(p_hi, p_lo, s);
    }
    c.issue_pv(pv, p_hi, p_lo, ntiles - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(pv);
    rescale_add(acc, corr, pv);

    const float l[2] = {c.row_sum(0), c.row_sum(1)};
    float* og = o + b * o_sb + (long long)h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + cw * WG_BM + warp * 16 + g + r * 8;
      if (row >= Tq) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / l_safe;
      float* orow = og + (long long)row * o_st;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + tq4 * 2;
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
      }
      if (tq4 == 0) lse[(long long)bh * Tq + row] = c.m_run[r] * LN2 + logf(l_safe);
    }
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int Tq, int Tk, int D, const long long* st, float scale,
                       cudaStream_t stream) {
  using C = F32Cfg<DP>;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = operand_map(&mq, q, B, Tq, H, D, st[0], st[1], C::BM, true)) != cudaSuccess) return e;
  if ((e = operand_map(&mk, k, B, Tk, H, D, st[2], st[3], C::BN, true)) != cudaSuccess) return e;
  if ((e = operand_map(&mv, v, B, Tk, H, D, st[4], st[5], C::BN, true)) != cudaSuccess) return e;
  static unsigned long long attr_set = 0;
  if ((e = set_max_dynamic_smem(flash_fwd_tf32<DP>, C::SMEM, &attr_set)) != cudaSuccess)
    return e;
  dim3 grid((Tq + C::BM - 1) / C::BM, B * H);
  flash_fwd_tf32<DP><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, (float*)o, lse, H, Tq, Tk, D, st[6], st[7], scale * LOG2E);
  return cudaGetLastError();
}

template <int DP>
int plan_f32(int* out) {
  using C = F32Cfg<DP>;
  out[0] = C::BM;
  out[1] = C::BN;
  out[2] = C::STAGES;
  out[3] = C::SMEM;
  return 0;
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
    switch (flash::f32_padded_dim(D)) {
      case 40: return (int)launch_f32<40>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
      case 64: return (int)launch_f32<64>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
      case 80: return (int)launch_f32<80>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
      case 160: return (int)launch_f32<160>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
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

// The tiling of the fp32 instance that takes head dim D, for the Python
// mirror (`fwd_f32_plan` in ops/kernels/flash_attention.py): out = {query
// rows a CTA owns, keys per K/V tile, stages, dynamic shared memory bytes}.
// cudaErrorInvalidValue for a head dim no instance takes.
int rr_flash_attn_fwd_f32_plan(int D, int* out) {
  switch (flash::f32_padded_dim(D)) {
    case 40: return plan_f32<40>(out);
    case 64: return plan_f32<64>(out);
    case 80: return plan_f32<80>(out);
    case 160: return plan_f32<160>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
