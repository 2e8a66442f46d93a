// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces reflecting_reality_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd, pallas_call at :130): blockwise softmax(Q K^T / sqrt(D)) V
// with an online softmax (running max m, running sum l, fp32 accumulator),
// the l == 0 guard, O written in the input dtype and the logsumexp m + log l
// written as fp32 (B*H, Tq).
//
// Layout: q/k/v/o are (B, T, H, D) with the last two dims packed (stride of H
// is D, stride of D is 1); the batch and token strides are arguments, so the
// q/k/v column slices of a fused qkv projection are read in place.
//
// bf16 path (the main path): one CTA of 4 warps per (b*h, 64-row Q tile);
// each warp owns 16 query rows.  K/V tiles of 64 keys are staged in shared
// memory with D zero-padded to DP (48, 64, 80 or 160: multiples of 16, the
// MMA depth, for D <= 160 with D % 8 == 0; other head dims are refused) and 8
// bf16 of row padding, which makes every ldmatrix below free of bank
// conflicts.  The tiles are double-buffered: cp.async brings tile j+1 while
// the warps compute on tile j.  Q K^T and P V run on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), their operands loaded with
// ldmatrix (.trans for V); the S accumulator fragment is re-packed in
// registers as the A fragment of P V, so P never touches shared memory.  The
// softmax runs in fp32 in the log2 domain (one FFMA + exp2 per logit, the
// scale log2(e)/sqrt(D) using the true head dim D).  Ragged tails are masked: Q
// rows past Tq are zero and never stored, keys past Tk get -inf.
//
// fp32 path (the parity pipelines): CUDA-core FMAs, one warp per 4 query
// rows, 32-key tiles in shared memory, one key per lane for Q K^T and one
// head-dim column per lane for P V; each K and V element read from shared
// memory serves all 4 rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // query rows per CTA (16 per warp)
constexpr int BN = 64;    // keys per K/V tile
constexpr int PADH = 8;   // bf16 of row padding in shared memory
constexpr int THREADS = 128;
constexpr int MAX_D = 160;  // the largest head dim taken (SD-1.5's level-2 heads)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lane l gives the address of row (l % 8) of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte global -> shared copy; src_bytes == 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + 64) of one head into shared memory [64][DP + PADH];
// columns >= D and rows >= nrows are zero.  16-byte copies (D % 8 == 0).
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          long long row_stride, int row0, int nrows, int D) {
  constexpr int CPR = DP / 8;
  for (int i = threadIdx.x; i < 64 * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int row = row0 + r;
    const bool ok = row < nrows && c < D;
    cp_async16(s + r * (DP + PADH) + c, ok ? g + (long long)row * row_stride + c : g,
               ok ? 16 : 0);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int H, int Tq, int Tk, int D,
               long long q_sb, long long q_st, long long k_sb, long long k_st,
               long long v_sb, long long v_st, long long o_sb, long long o_st,
               float scale_log2) {
  constexpr int LD = DP + PADH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [Q: BM rows][K buffer 0, 1: BN rows each][V buffer 0, 1: BN rows each].
  // Buffers are addressed by offset, not through a pointer array, which the
  // runtime buffer index would put in local memory.
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * LD;
  __nv_bfloat16* Vs = Ks + 2 * BN * LD;
  constexpr int BUF = BN * LD;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const __nv_bfloat16* qg = q + b * q_sb + (long long)h * D;
  const __nv_bfloat16* kg = k + b * k_sb + (long long)h * D;
  const __nv_bfloat16* vg = v + b * v_sb + (long long)h * D;
  __nv_bfloat16* og = o + b * o_sb + (long long)h * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;     // mma fragment row group / thread-in-group
  const int lm = lane >> 3, lr = lane & 7;    // ldmatrix: matrix index, row in matrix

  load_tile<DP>(Qs, qg, q_st, q0, Tq, D);
  load_tile<DP>(Ks, kg, k_st, 0, Tk, D);
  load_tile<DP>(Vs, vg, v_st, 0, Tk, D);
  cp_async_commit();

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
  // ldmatrix row addresses: Q's A fragment (rows of this warp), K's and V's B fragments
  const __nv_bfloat16* qa = Qs + (warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
  const int k_off = ((lm >> 1) * 8 + lr) * LD + (lm & 1) * 8;
  const int v_off = ((lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;

  const int ntiles = (Tk + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BN, buf = j & 1;
    if (j + 1 < ntiles) {  // prefetch the next tile into the other buffer
      load_tile<DP>(Ks + (buf ^ 1) * BUF, kg, k_st, k0 + BN, Tk, D);
      load_tile<DP>(Vs + (buf ^ 1) * BUF, vg, v_st, k0 + BN, Tk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * BUF;
    const __nv_bfloat16* Vt = Vs + buf * BUF;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t a[4];
      ldsm_x4(a, qa + kc * 16);
#pragma unroll
      for (int n = 0; n < BN / 8; n += 2) {
        uint32_t kb[4];  // b0, b1 of key groups n and n + 1
        ldsm_x4(kb, Kt + n * 8 * LD + kc * 16 + k_off);
        mma_16816(s[n], a, kb[0], kb[1]);
        mma_16816(s[n + 1], a, kb[2], kb[3]);
      }
    }

    // online softmax in the log2 domain: mask tail keys (last tile only),
    // row max of the raw logits (scale > 0 commutes with max), then
    // p = exp2(s * scale_log2 - m) as one FFMA + EX2 per logit
    if (k0 + BN > Tk) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + tq * 2 + (e & 1) >= Tk) s[n][e] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float mu[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // all keys masked so far: no NaN
      corr[r] = exp2f(m_run[r] - mu[r]);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[n][e], scale_log2, -mu[e >> 1]));
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
    l_run[0] = l_run[0] * corr[0] + rs[0];
    l_run[1] = l_run[1] * corr[1] + rs[1];
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V: the S fragments of key groups 2kk and 2kk+1 form P's A fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                             pack_f32(s[2 * kk][2], s[2 * kk][3]),
                             pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int i = 0; i < DP / 8; i += 2) {
        uint32_t vb[4];  // b0, b1 of head-dim groups i and i + 1
        ldsm_x4_trans(vb, Vt + kk * 16 * LD + i * 8 + v_off);
        mma_16816(acc[i], a, vb[0], vb[1]);
        mma_16816(acc[i + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled at iteration j + 1
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Tq) continue;
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    __nv_bfloat16* orow = og + (long long)row * o_st;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = i * 8 + tq * 2;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
    if (tq == 0) lse[(long long)bh * Tq + row] = m_run[r] * LN2 + logf(l_safe);
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int H, int Tq, int Tk, int D, const long long* st,
                        float scale, cudaStream_t stream) {
  const int smem = (BM + 4 * BN) * (DP + PADH) * (int)sizeof(__nv_bfloat16);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((Tq + BM - 1) / BM, B * H);
  flash_fwd_bf16<DP><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, lse, H, Tq, Tk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], scale * LOG2E);
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

// Padded head dim of the bf16 instance that takes D (0 if none does): the
// SD-1.5 head dims 40, 80 and 160 pad to 48, 80 and 160; 64 is its own.
int padded_dim(int D) {
  if (D <= 0 || D > MAX_D || D % 8 != 0) return 0;
  const int choices[] = {48, 64, 80, 160};
  for (int c : choices)
    if (c >= D) return c;
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
    if (D <= 0 || D > MAX_D) return (int)cudaErrorInvalidValue;
    return (int)launch_f32(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (padded_dim(D)) {
    case 48: return (int)launch_bf16<48>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
    case 64: return (int)launch_bf16<64>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
    case 80: return (int)launch_bf16<80>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
    case 160: return (int)launch_bf16<160>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
