// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes:
// kernels B3 (dQ) and B4 (dK, dV).
//
// Replaces reflecting_reality_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel
// (pallas_call at :234) and ::_bwd_dkv_kernel (pallas_call at :250).  Both
// recompute the probabilities from the forward's logsumexp instead of storing
// them: p = exp(s - lse) with s = q.k / sqrt(D).  With dP = dO V^T and the
// row term delta = rowsum(dO * O) (computed by the caller, as XLA does at
// :231):
//   dS = p * (dP - delta),  dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),
//   dV = p^T dO.
// The JAX package's two-kernel split is kept, so no atomics are needed: the
// dQ kernel owns a tile of query rows and walks the keys, the dK/dV kernel
// owns a tile of keys and walks the queries.
//
// Layout as the forward: q/k/v/dO/dQ/dK/dV are (B, T, H, D) with (H, D)
// packed and batch/token strides passed in; lse and delta are fp32 (B*H, Tq).
//
// bf16 path (training): 4 warps per CTA, 16 rows per warp, every product on
// the tensor cores (mma.sync.m16n8k16, bf16 in, fp32 accumulate), D padded to
// the MMA depth in shared memory with 8 bf16 of row padding (conflict-free
// ldmatrix), double-buffered cp.async tiles, exponentials in the log2 domain
// with the true-D scale.  p and dS are rounded to bf16 before they multiply
// dO, K or Q, as the Pallas kernels cast them to the input dtype.
//   dQ:   S = Q K^T and dP = dO V^T share the Q and dO fragments; dS stays in
//         registers and is re-packed as the A fragment of dS K (K through
//         ldmatrix.trans).  Keys past Tk get p = 0.
//   dK/dV: each warp computes its 16 keys' rows of the transposed products,
//         S^T = K Q^T and dP^T = V dO^T, so that p^T and dS^T are accumulator
//         fragments that re-pack as A fragments of p^T dO and dS^T Q (dO and Q
//         through ldmatrix.trans); lse and delta of the query tile are
//         per-column and come from shared memory.  The dK and dV accumulators
//         both live in registers; for D = 160 the query tile is 32 wide to
//         leave room for them.  Query rows past Tq are zero-filled with
//         lse = delta = 0, which makes their p^T dO and dS^T terms exactly 0.
//
// fp32 path (parity runs): CUDA-core FMAs, one warp per 4 rows, 32-wide tiles
// with one key (dQ) or one query (dK/dV) per lane for the dot products and
// one head-dim column per lane for the accumulations.

#include "flash_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;  // rows per CTA: query rows (dQ) or key rows (dK/dV), 16 per warp
constexpr int BN = 64;  // keys per K/V tile of the dQ kernel

// ldmatrix row offsets inside a [rows][DP + PADH] tile, lane-dependent:
// a B fragment whose n index runs along the tile's rows (K in Q K^T) ...
__device__ __forceinline__ int b_rows_off(int lane, int LD) {
  const int lm = lane >> 3, lr = lane & 7;
  return ((lm >> 1) * 8 + lr) * LD + (lm & 1) * 8;
}
// ... a B fragment whose k index runs along the tile's rows (K in dS K, .trans) ...
__device__ __forceinline__ int b_trans_off(int lane, int LD) {
  const int lm = lane >> 3, lr = lane & 7;
  return ((lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
}
// ... and the A fragment of this warp's 16 rows.
__device__ __forceinline__ int a_off(int warp, int lane, int LD) {
  const int lm = lane >> 3, lr = lane & 7;
  return (warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Rows [row0, row0 + N) of an fp32 (., T) vector into shared memory; zero past n.
template <int N>
__device__ __forceinline__ void load_vec(float* s, const float* g, int row0, int n) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const bool ok = row0 + i < n;
    cp_async4(s + i, ok ? g + row0 + i : g, ok ? 4 : 0);
  }
}

// Rows g and g + 8 of one 16-row accumulator block, scaled, stored as bf16.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, long long st, const float (&acc)[DP / 8][4],
                                           int row_g, int nrows, int D, float mul) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + r * 8;
    if (row >= nrows) continue;
    bf16* orow = out + (long long)row * st;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = i * 8 + tq * 2;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[i][2 * r] * mul, acc[i][2 * r + 1] * mul);
    }
  }
}

// ------------------------------------------------------------ B3: dQ, bf16

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int H, int Tq, int Tk, int D,
                  long long q_sb, long long q_st, long long k_sb, long long k_st,
                  long long v_sb, long long v_st, long long do_sb, long long do_st,
                  long long dq_sb, long long dq_st, float scale, float scale_log2) {
  constexpr int LD = DP + PADH;
  constexpr int BUF = BN * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [Q: BM rows][dO: BM rows][K buffers 0, 1][V buffers 0, 1]
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BM * LD;
  bf16* Ks = dOs + BM * LD;
  bf16* Vs = Ks + 2 * BUF;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const bf16* qg = q + b * q_sb + (long long)h * D;
  const bf16* kg = k + b * k_sb + (long long)h * D;
  const bf16* vg = v + b * v_sb + (long long)h * D;
  const bf16* dog = dout + b * do_sb + (long long)h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  load_tile<DP>(Qs, qg, q_st, q0, Tq, D);
  load_tile<DP>(dOs, dog, do_st, q0, Tq, D);
  load_tile<DP>(Ks, kg, k_st, 0, Tk, D);
  load_tile<DP>(Vs, vg, v_st, 0, Tk, D);
  cp_async_commit();

  // lse (log2 domain) and delta of rows g and g + 8; rows past Tq read 0
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    const bool ok = row < Tq;
    lse2[r] = ok ? lse[(long long)bh * Tq + row] * LOG2E : 0.f;
    dlt[r] = ok ? delta[(long long)bh * Tq + row] : 0.f;
  }

  float acc[DP / 8][4];
  zero(acc);
  const bf16* qa = Qs + a_off(warp, lane, LD);
  const bf16* doa = dOs + a_off(warp, lane, LD);
  const int nb = b_rows_off(lane, LD), tb = b_trans_off(lane, LD);

  const int ntiles = (Tk + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BN, buf = j & 1;
    if (j + 1 < ntiles) {
      load_tile<DP>(Ks + (buf ^ 1) * BUF, kg, k_st, k0 + BN, Tk, D);
      load_tile<DP>(Vs + (buf ^ 1) * BUF, vg, v_st, k0 + BN, Tk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * BUF;
    const bf16* Vt = Vs + buf * BUF;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t a[4], da[4];
      ldsm_x4(a, qa + kc * 16);
      ldsm_x4(da, doa + kc * 16);
#pragma unroll
      for (int n = 0; n < BN / 8; n += 2) {
        uint32_t kb[4], vb[4];  // b0, b1 of key groups n and n + 1
        ldsm_x4(kb, Kt + n * 8 * LD + kc * 16 + nb);
        mma_16816(s[n], a, kb[0], kb[1]);
        mma_16816(s[n + 1], a, kb[2], kb[3]);
        ldsm_x4(vb, Vt + n * 8 * LD + kc * 16 + nb);
        mma_16816(dp[n], da, vb[0], vb[1]);
        mma_16816(dp[n + 1], da, vb[2], vb[3]);
      }
    }

    // dS = p (dP - delta), p = exp2(s * scale_log2 - lse2); keys past Tk: p = 0
    const bool tail = k0 + BN > Tk;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
        if (tail && k0 + n * 8 + tq * 2 + (e & 1) >= Tk) p = 0.f;
        s[n][e] = p * (dp[n][e] - dlt[e >> 1]);
      }
    }

    // dQ += dS K: dS of key groups 2kk, 2kk+1 is the A fragment of key chunk kk
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < DP / 8; i += 2) {
        uint32_t kb[4];  // b0, b1 of head-dim groups i and i + 1
        ldsm_x4_trans(kb, Kt + kk * 16 * LD + i * 8 + tb);
        mma_16816(acc[i], a, kb[0], kb[1]);
        mma_16816(acc[i + 1], a, kb[2], kb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled at iteration j + 1
  }

  bf16* dqg = dq + b * dq_sb + (long long)h * D;
  store_rows<DP>(dqg, dq_st, acc, q0 + warp * 16 + g, Tq, D, scale);
}

// ------------------------------------------------------- B4: dK/dV, bf16

template <int DP, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq, int Tk, int D,
                   long long q_sb, long long q_st, long long k_sb, long long k_st,
                   long long v_sb, long long v_st, long long do_sb, long long do_st,
                   long long dk_sb, long long dk_st, long long dv_sb, long long dv_st,
                   float scale, float scale_log2) {
  constexpr int LD = DP + PADH;
  constexpr int BUF = BQ * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [K: BM rows][V: BM rows][Q buffers 0, 1][dO buffers 0, 1][lse 0, 1][delta 0, 1]
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BM * LD;
  bf16* Qs = Vs + BM * LD;
  bf16* dOs = Qs + 2 * BUF;
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BUF);
  float* Dl = Ls + 2 * BQ;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BM;
  const bf16* qg = q + b * q_sb + (long long)h * D;
  const bf16* kg = k + b * k_sb + (long long)h * D;
  const bf16* vg = v + b * v_sb + (long long)h * D;
  const bf16* dog = dout + b * do_sb + (long long)h * D;
  const float* lg = lse + (long long)bh * Tq;
  const float* dg = delta + (long long)bh * Tq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  load_tile<DP, BM>(Ks, kg, k_st, k0, Tk, D);
  load_tile<DP, BM>(Vs, vg, v_st, k0, Tk, D);
  load_tile<DP, BQ>(Qs, qg, q_st, 0, Tq, D);
  load_tile<DP, BQ>(dOs, dog, do_st, 0, Tq, D);
  load_vec<BQ>(Ls, lg, 0, Tq);
  load_vec<BQ>(Dl, dg, 0, Tq);
  cp_async_commit();

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const bf16* ka = Ks + a_off(warp, lane, LD);
  const bf16* va = Vs + a_off(warp, lane, LD);
  const int nb = b_rows_off(lane, LD), tb = b_trans_off(lane, LD);

  const int ntiles = (Tq + BQ - 1) / BQ;
  for (int j = 0; j < ntiles; ++j) {
    const int qt0 = j * BQ, buf = j & 1;
    if (j + 1 < ntiles) {
      load_tile<DP, BQ>(Qs + (buf ^ 1) * BUF, qg, q_st, qt0 + BQ, Tq, D);
      load_tile<DP, BQ>(dOs + (buf ^ 1) * BUF, dog, do_st, qt0 + BQ, Tq, D);
      load_vec<BQ>(Ls + (buf ^ 1) * BQ, lg, qt0 + BQ, Tq);
      load_vec<BQ>(Dl + (buf ^ 1) * BQ, dg, qt0 + BQ, Tq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + buf * BUF;
    const bf16* Dt = dOs + buf * BUF;
    const float* Lt = Ls + buf * BQ;
    const float* Dlt = Dl + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries
    float s[BQ / 8][4], dp[BQ / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t a[4], av[4];
      ldsm_x4(a, ka + kc * 16);
      ldsm_x4(av, va + kc * 16);
#pragma unroll
      for (int n = 0; n < BQ / 8; n += 2) {
        uint32_t qb[4], ob[4];  // b0, b1 of query groups n and n + 1
        ldsm_x4(qb, Qt + n * 8 * LD + kc * 16 + nb);
        mma_16816(s[n], a, qb[0], qb[1]);
        mma_16816(s[n + 1], a, qb[2], qb[3]);
        ldsm_x4(ob, Dt + n * 8 * LD + kc * 16 + nb);
        mma_16816(dp[n], av, ob[0], ob[1]);
        mma_16816(dp[n + 1], av, ob[2], ob[3]);
      }
    }

    // p^T = exp2(s^T * scale_log2 - lse2[query]) and dS^T = p^T (dP^T - delta[query]);
    // element e of group n is query column n * 8 + tq * 2 + (e & 1)
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(Lt + n * 8 + tq * 2);
      const float2 dl = *reinterpret_cast<const float2*>(Dlt + n * 8 + tq * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lc = (e & 1) ? l.y : l.x;
        const float dc = (e & 1) ? dl.y : dl.x;
        const float p = exp2f(fmaf(s[n][e], scale_log2, -lc * LOG2E));
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dc);
      }
    }

    // dV += p^T dO and dK += dS^T Q over query chunk kk
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int i = 0; i < DP / 8; i += 2) {
        uint32_t ob[4], qb[4];  // b0, b1 of head-dim groups i and i + 1
        ldsm_x4_trans(ob, Dt + kk * 16 * LD + i * 8 + tb);
        mma_16816(dv_acc[i], pa, ob[0], ob[1]);
        mma_16816(dv_acc[i + 1], pa, ob[2], ob[3]);
        ldsm_x4_trans(qb, Qt + kk * 16 * LD + i * 8 + tb);
        mma_16816(dk_acc[i], da, qb[0], qb[1]);
        mma_16816(dk_acc[i + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled at iteration j + 1
  }

  const int row_g = k0 + warp * 16 + g;
  store_rows<DP>(dk + b * dk_sb + (long long)h * D, dk_st, dk_acc, row_g, Tk, D, scale);
  store_rows<DP>(dv + b * dv_sb + (long long)h * D, dv_st, dv_acc, row_g, Tk, D, 1.f);
}

template <typename K>
cudaError_t set_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DP>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, int B, int H,
                           int Tq, int Tk, int D, const long long* st, float scale,
                           cudaStream_t stream) {
  const int smem = (2 * BM + 4 * BN) * (DP + PADH) * (int)sizeof(bf16);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = set_smem(flash_bwd_dq_bf16<DP>, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((Tq + BM - 1) / BM, B * H);
  flash_bwd_dq_bf16<DP><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, (bf16*)dq,
      H, Tq, Tk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv, int B,
                            int H, int Tq, int Tk, int D, const long long* st, float scale,
                            cudaStream_t stream) {
  constexpr int BQ = DP >= 128 ? 32 : 64;
  const int smem = (2 * BM + 4 * BQ) * (DP + PADH) * (int)sizeof(bf16) +
                   4 * BQ * (int)sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = set_smem(flash_bwd_dkv_bf16<DP, BQ>, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((Tk + BM - 1) / BM, B * H);
  flash_bwd_dkv_bf16<DP, BQ><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, (bf16*)dk,
      (bf16*)dv, H, Tq, Tk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, scale * LOG2E);
  return cudaGetLastError();
}

// ------------------------------------------------------------- fp32 path

constexpr int F_WARPS = 4;
constexpr int F_ROWS = 4;                   // rows per warp
constexpr int F_BM = F_WARPS * F_ROWS;      // 16 rows per CTA
constexpr int F_BN = 32;                    // tile width, one key or query per lane
constexpr int F_MAXCH = (MAX_D + 31) / 32;  // head-dim columns per lane

__global__ void __launch_bounds__(F_WARPS * 32)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int H, int Tq, int Tk, int D, long long q_sb,
                 long long q_st, long long k_sb, long long k_st, long long v_sb, long long v_st,
                 long long do_sb, long long do_st, long long dq_sb, long long dq_st,
                 float scale) {
  extern __shared__ float fsm[];
  const int LDK = D + 1;  // odd stride: lane j reads row j without conflicts
  float* Qs = fsm;              // [F_BM][D]
  float* dOs = Qs + F_BM * D;   // [F_BM][D]
  float* Ks = dOs + F_BM * D;   // [F_BN][D + 1]
  float* Vs = Ks + F_BN * LDK;  // [F_BN][D + 1]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * F_BM;
  const float* qg = q + b * q_sb + (long long)h * D;
  const float* kg = k + b * k_sb + (long long)h * D;
  const float* vg = v + b * v_sb + (long long)h * D;
  const float* dog = dout + b * do_sb + (long long)h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = (D + 31) / 32;

  for (int i = threadIdx.x; i < F_BM * D; i += blockDim.x) {
    const int r = i / D, c = i % D, row = q0 + r;
    const bool ok = row < Tq;
    Qs[i] = ok ? qg[(long long)row * q_st + c] : 0.f;
    dOs[i] = ok ? dog[(long long)row * do_st + c] : 0.f;
  }
  float lse_r[F_ROWS], dl_r[F_ROWS], acc[F_ROWS][F_MAXCH];
#pragma unroll
  for (int rr = 0; rr < F_ROWS; ++rr) {
    const int row = q0 + warp * F_ROWS + rr;
    const bool ok = row < Tq;
    lse_r[rr] = ok ? lse[(long long)bh * Tq + row] : 0.f;
    dl_r[rr] = ok ? delta[(long long)bh * Tq + row] : 0.f;
#pragma unroll
    for (int i = 0; i < F_MAXCH; ++i) acc[rr][i] = 0.f;
  }
  const float* qw = Qs + warp * F_ROWS * D;
  const float* dw = dOs + warp * F_ROWS * D;

  for (int k0 = 0; k0 < Tk; k0 += F_BN) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BN * D; i += blockDim.x) {
      const int r = i / D, c = i % D, row = k0 + r;
      const bool ok = row < Tk;
      Ks[r * LDK + c] = ok ? kg[(long long)row * k_st + c] : 0.f;
      Vs[r * LDK + c] = ok ? vg[(long long)row * v_st + c] : 0.f;
    }
    __syncthreads();
    const bool valid = k0 + lane < Tk;

    float dot[F_ROWS] = {0.f, 0.f, 0.f, 0.f}, dpv[F_ROWS] = {0.f, 0.f, 0.f, 0.f};
    const float* kr = Ks + lane * LDK;
    const float* vr = Vs + lane * LDK;
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d], vv = vr[d];
#pragma unroll
      for (int rr = 0; rr < F_ROWS; ++rr) {
        dot[rr] = fmaf(qw[rr * D + d], kv, dot[rr]);
        dpv[rr] = fmaf(dw[rr * D + d], vv, dpv[rr]);
      }
    }
    float ds[F_ROWS];
#pragma unroll
    for (int rr = 0; rr < F_ROWS; ++rr)
      ds[rr] = valid ? expf(dot[rr] * scale - lse_r[rr]) * (dpv[rr] - dl_r[rr]) : 0.f;
    for (int j = 0; j < F_BN; ++j) {
      float dsj[F_ROWS];
#pragma unroll
      for (int rr = 0; rr < F_ROWS; ++rr) dsj[rr] = __shfl_sync(0xffffffffu, ds[rr], j);
      const float* kj = Ks + j * LDK;
#pragma unroll
      for (int i = 0; i < F_MAXCH; ++i) {
        const int d = lane + 32 * i;
        if (i < nch && d < D) {
          const float kv = kj[d];
#pragma unroll
          for (int rr = 0; rr < F_ROWS; ++rr) acc[rr][i] = fmaf(dsj[rr], kv, acc[rr][i]);
        }
      }
    }
  }

  float* dqg = dq + b * dq_sb + (long long)h * D;
#pragma unroll
  for (int rr = 0; rr < F_ROWS; ++rr) {
    const int row = q0 + warp * F_ROWS + rr;
    if (row >= Tq) continue;
#pragma unroll
    for (int i = 0; i < F_MAXCH; ++i) {
      const int d = lane + 32 * i;
      if (i < nch && d < D) dqg[(long long)row * dq_st + d] = acc[rr][i] * scale;
    }
  }
}

__global__ void __launch_bounds__(F_WARPS * 32)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int H, int Tq, int Tk, int D,
                  long long q_sb, long long q_st, long long k_sb, long long k_st,
                  long long v_sb, long long v_st, long long do_sb, long long do_st,
                  long long dk_sb, long long dk_st, long long dv_sb, long long dv_st,
                  float scale) {
  extern __shared__ float fsm[];
  const int LDK = D + 1;
  float* Ks = fsm;               // [F_BM][D]: this CTA's key rows
  float* Vs = Ks + F_BM * D;     // [F_BM][D]
  float* Qs = Vs + F_BM * D;     // [F_BN][D + 1]
  float* dOs = Qs + F_BN * LDK;  // [F_BN][D + 1]
  float* Ls = dOs + F_BN * LDK;  // [F_BN]
  float* Dls = Ls + F_BN;        // [F_BN]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * F_BM;
  const float* qg = q + b * q_sb + (long long)h * D;
  const float* kg = k + b * k_sb + (long long)h * D;
  const float* vg = v + b * v_sb + (long long)h * D;
  const float* dog = dout + b * do_sb + (long long)h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = (D + 31) / 32;

  for (int i = threadIdx.x; i < F_BM * D; i += blockDim.x) {
    const int r = i / D, c = i % D, row = k0 + r;
    const bool ok = row < Tk;
    Ks[i] = ok ? kg[(long long)row * k_st + c] : 0.f;
    Vs[i] = ok ? vg[(long long)row * v_st + c] : 0.f;
  }
  float acc_k[F_ROWS][F_MAXCH], acc_v[F_ROWS][F_MAXCH];
#pragma unroll
  for (int rr = 0; rr < F_ROWS; ++rr) {
#pragma unroll
    for (int i = 0; i < F_MAXCH; ++i) acc_k[rr][i] = acc_v[rr][i] = 0.f;
  }
  const float* kw = Ks + warp * F_ROWS * D;
  const float* vw = Vs + warp * F_ROWS * D;

  for (int q0 = 0; q0 < Tq; q0 += F_BN) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BN * D; i += blockDim.x) {
      const int r = i / D, c = i % D, row = q0 + r;
      const bool ok = row < Tq;
      Qs[r * LDK + c] = ok ? qg[(long long)row * q_st + c] : 0.f;
      dOs[r * LDK + c] = ok ? dog[(long long)row * do_st + c] : 0.f;
    }
    if (threadIdx.x < F_BN) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < Tq;
      Ls[threadIdx.x] = ok ? lse[(long long)bh * Tq + row] : 0.f;
      Dls[threadIdx.x] = ok ? delta[(long long)bh * Tq + row] : 0.f;
    }
    __syncthreads();
    const bool valid = q0 + lane < Tq;

    float dot[F_ROWS] = {0.f, 0.f, 0.f, 0.f}, dpv[F_ROWS] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = Qs + lane * LDK;
    const float* dr = dOs + lane * LDK;
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d], ov = dr[d];
#pragma unroll
      for (int rr = 0; rr < F_ROWS; ++rr) {
        dot[rr] = fmaf(kw[rr * D + d], qv, dot[rr]);
        dpv[rr] = fmaf(vw[rr * D + d], ov, dpv[rr]);
      }
    }
    float p[F_ROWS], ds[F_ROWS];
#pragma unroll
    for (int rr = 0; rr < F_ROWS; ++rr) {
      p[rr] = valid ? expf(dot[rr] * scale - Ls[lane]) : 0.f;
      ds[rr] = p[rr] * (dpv[rr] - Dls[lane]);
    }
    for (int j = 0; j < F_BN; ++j) {
      float pj[F_ROWS], dsj[F_ROWS];
#pragma unroll
      for (int rr = 0; rr < F_ROWS; ++rr) {
        pj[rr] = __shfl_sync(0xffffffffu, p[rr], j);
        dsj[rr] = __shfl_sync(0xffffffffu, ds[rr], j);
      }
      const float* qj = Qs + j * LDK;
      const float* oj = dOs + j * LDK;
#pragma unroll
      for (int i = 0; i < F_MAXCH; ++i) {
        const int d = lane + 32 * i;
        if (i < nch && d < D) {
          const float qv = qj[d], ov = oj[d];
#pragma unroll
          for (int rr = 0; rr < F_ROWS; ++rr) {
            acc_v[rr][i] = fmaf(pj[rr], ov, acc_v[rr][i]);
            acc_k[rr][i] = fmaf(dsj[rr], qv, acc_k[rr][i]);
          }
        }
      }
    }
  }

  float* dkg = dk + b * dk_sb + (long long)h * D;
  float* dvg = dv + b * dv_sb + (long long)h * D;
#pragma unroll
  for (int rr = 0; rr < F_ROWS; ++rr) {
    const int row = k0 + warp * F_ROWS + rr;
    if (row >= Tk) continue;
#pragma unroll
    for (int i = 0; i < F_MAXCH; ++i) {
      const int d = lane + 32 * i;
      if (i < nch && d < D) {
        dkg[(long long)row * dk_st + d] = acc_k[rr][i] * scale;
        dvg[(long long)row * dv_st + d] = acc_v[rr][i];
      }
    }
  }
}

int f32_smem(int D) {
  return (2 * F_BM * D + 2 * F_BN * (D + 1) + 2 * F_BN) * (int)sizeof(float);
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
    if (D <= 0 || D > flash::MAX_D) return (int)cudaErrorInvalidValue;
    const int smem = f32_smem(D);
    cudaError_t e = set_smem(flash_bwd_dq_f32, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Tq + F_BM - 1) / F_BM, B * H);
    flash_bwd_dq_f32<<<grid, F_WARPS * 32, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout, l, dl,
        (float*)dq, H, Tq, Tk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        st[8], st[9], scale);
    return (int)cudaGetLastError();
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
// dk_sb, dk_st, dv_sb, dv_st.  Otherwise as rr_flash_attn_bwd_dq.
int rr_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int dtype,
                          int B, int H, int Tq, int Tk, int D, long long q_sb, long long q_st,
                          long long k_sb, long long k_st, long long v_sb, long long v_st,
                          long long do_sb, long long do_st, long long dk_sb, long long dk_st,
                          long long dv_sb, long long dv_st, float scale, void* stream) {
  const long long st[12] = {q_sb,  q_st,  k_sb,  k_st,  v_sb,  v_st,
                            do_sb, do_st, dk_sb, dk_st, dv_sb, dv_st};
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (dtype == 1) {
    if (D <= 0 || D > flash::MAX_D) return (int)cudaErrorInvalidValue;
    const int smem = f32_smem(D);
    cudaError_t e = set_smem(flash_bwd_dkv_f32, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Tk + F_BM - 1) / F_BM, B * H);
    flash_bwd_dkv_f32<<<grid, F_WARPS * 32, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout, l, dl,
        (float*)dk, (float*)dv, H, Tq, Tk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7], st[8], st[9], st[10], st[11], scale);
    return (int)cudaGetLastError();
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

}  // extern "C"
