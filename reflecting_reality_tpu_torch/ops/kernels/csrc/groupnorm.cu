// GroupNorm(+SiLU) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces reflecting_reality_tpu/ops/pallas/groupnorm.py::_gn_kernel
// (launched by group_norm_silu_pallas, pallas_call at :95): per (sample,
// group) statistics in fp32, the normalisation and the per-channel affine
// folded into one multiply-add, optionally SiLU, output in x's dtype.
//
// Layout: x and y are contiguous (B, C, *spatial), so the span of one
// (b, group) is N = (C / G) * HW contiguous elements, channel after channel.
//
// What bounds it: bytes.  About ten operations per element against one read
// of x and one write of y; the least time is 2 * B * C * HW * itemsize at
// 3.35 TB/s (the UNet's (2, 320, 64, 64) bf16: 5.2 MB, 1.6 us).  The TPU kernel
// reads x once because a whole sample sits in VMEM; the earlier Triton port
// read it twice, ran one program per (b, group) (64 programs on 132 SMs for the
// UNet at CFG batch 2) and paid Triton's launcher on the host at every call.
//
// What the design does about it:
//  - Single-pass regime (spans up to CLUSTER_MAX * SLICE_MAX = 131072
//    elements: every UNet and BrushNet norm at 512^2, the largest being the
//    up-block resnets' 960-channel inputs at 64^2, 122880 elements).  Each
//    (b, group) span is split into `cs` slices (at most 8, sized from the span by
//    groupnorm.py's launch_plan), one CTA each, and the cs CTAs form one
//    thread-block cluster.  A CTA reads its slice once from HBM with 16-byte
//    loads into shared memory (at most SLICE_MAX elements: 32 KB in bf16),
//    summing as it goes, then forms its partial (count, mean, M2) with a
//    second pass over shared memory (M2 about the slice's own mean: exact
//    two-pass numerics inside the slice).  Shared memory, not registers,
//    holds the slice: a register array sized for the largest slice took
//    ~110 registers a thread and cut occupancy to two CTAs per SM, which
//    doubled the time of the small main-path norms.  The partials are
//    exchanged through distributed shared memory (cluster.map_shared_rank
//    after cluster.sync) and merged by Chan's rule in rank order 0..cs-1 on
//    every CTA, so all CTAs hold bit-identical statistics and the result
//    does not depend on scheduling.  Each CTA then folds mean, rstd, weight
//    and bias into a per-channel (mul, add) table in shared memory (once per
//    channel of its slice, not per element; the parameters are loaded while
//    x streams in), applies it (+SiLU) and writes y once with 16-byte
//    stores.  HBM traffic is one read and one write: the bound.
//  - Split regime (longer spans: most of the VAE's groups from 128^2 up,
//    1M elements at 512^2): slices of SLICE_MAX elements as independent
//    CTAs; gn_kernel<STATS> writes each slice's (mean, M2) to global memory and
//    gn_kernel<APPLY> merges a group's partials by Chan's rule (a warp
//    folds them in a fixed order: lanes over slices, then a shuffle tree)
//    and streams x a second time to apply; x is read twice.
//  - Launch: cudaLaunchKernelEx with a cluster-dimension attribute, called
//    through ctypes (a few microseconds on the host).
//  - Spans whose length or spatial size is not a multiple of 8, or whose
//    base is not 16-byte aligned, take the same kernels with scalar loads
//    (VEC = 1); the choice is made by shape in launch_plan.
//  - Statistics in fp32, the variance two-pass-equivalent (M2 by Chan's
//    merge of per-slice two-pass M2), output in x's dtype.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int SLICE_MAX = 16384;  // elements one CTA stages (SLICE_MAX in groupnorm.py)
constexpr int CLUSTER_MAX = 8;    // the portable cluster size
constexpr int SMEM_ATTR = 128 * 1024;  // a slice of SLICE_MAX fp32 and a table of 8192 channels

enum Mode { FUSED = 0, STATS = 1, APPLY = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }

__device__ __forceinline__ float load_param(const void* p, int i, int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// Sum over the CTA, broadcast to every thread.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is reused
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) t += red[w];
  return t;
}

// Chan's rule: fold partial (nb, mb, m2b) into (n, mean, m2).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - mean;
  mean += d * (nb / nn);
  m2 += m2b + d * d * (n * nb / nn);
  n = nn;
}

__device__ __forceinline__ int slice_count(int r, int L, int N) {
  const int s = r * L;
  const int e = min(N, s + L);
  return max(0, e - s);
}

// Shared memory that stages L elements of x, rounded up to 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ size_t stage_bytes(int L) {
  return ((size_t)L * sizeof(T) + 15) & ~size_t(15);
}

// VEC elements of x per 16-byte load (VEC = 1: scalar loads).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Chunk {
  T v[VEC];
};

template <typename T, int VEC, bool SILU, int MODE>
__global__ void __launch_bounds__(THREADS)
gn_kernel(const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ w,
          const void* __restrict__ bias, float2* __restrict__ partials, int w_f32, int b_f32,
          int G, int N, int HW, int L, int nslices, float eps) {
  // [the slice: L elements of x, but for APPLY][(mul, add) per channel of
  // the slice, but for STATS]
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[THREADS / 32];
  __shared__ float2 part;  // this CTA's (mean, M2), read by the cluster
  __shared__ float2 ranks[CLUSTER_MAX];  // every rank's (mean, M2), in rank order

  using Ch = Chunk<T, VEC>;
  const int r = blockIdx.x;   // slice (= rank in the cluster in FUSED mode)
  const int bg = blockIdx.y;  // b * G + g
  const int g = bg % G;
  const int start = r * L;
  const int n = slice_count(r, L, N);
  const int nch = n / VEC;    // whole chunks (n % VEC == 0 when VEC > 1)
  const Ch* xg = reinterpret_cast<const Ch*>(x + (long long)bg * N + start);
  Ch* yg = reinterpret_cast<Ch*>(y + (long long)bg * N + start);
  Ch* xs = reinterpret_cast<Ch*>(smem);
  float* table = reinterpret_cast<float*>(smem + (MODE == APPLY ? 0 : stage_bytes<T>(L)));
  const int c_lo = start / HW;
  const int c_n = (start + n - 1) / HW - c_lo + 1;  // channels the slice touches
  const int c0 = g * (N / HW) + c_lo;

  // this thread's first channel parameters, loaded while x streams in
  float w0 = 0.f, b0 = 0.f;
  if (MODE != STATS && threadIdx.x < c_n) {
    w0 = load_param(w, c0 + threadIdx.x, w_f32);
    b0 = load_param(bias, c0 + threadIdx.x, b_f32);
  }

  float mean = 0.f, m2 = 0.f, cnt = 0.f;
  if constexpr (MODE != APPLY) {
    // read the slice once into shared memory, summing as it goes; each
    // thread later reads back only the chunks it wrote
    float s = 0.f;
#pragma unroll 4
    for (int i = threadIdx.x; i < nch; i += THREADS) {
      const Ch c = xg[i];
      xs[i] = c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += to_f(c.v[e]);
    }
    const float sl_mean = block_sum(s, red) / (float)n;
    float q = 0.f;
#pragma unroll 4
    for (int i = threadIdx.x; i < nch; i += THREADS) {
      const Ch c = xs[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = to_f(c.v[e]) - sl_mean;
        q = fmaf(d, d, q);
      }
    }
    const float sl_m2 = block_sum(q, red);
    if constexpr (MODE == STATS) {
      if (threadIdx.x == 0) partials[(long long)bg * nslices + r] = make_float2(sl_mean, sl_m2);
      return;
    } else {
      // exchange the partials across the cluster; merge in rank order
      // (thread k fetches rank k's partial: one remote read in flight per
      // rank, not a chain of them)
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0) part = make_float2(sl_mean, sl_m2);
      cluster.sync();
      if (threadIdx.x < nslices)
        ranks[threadIdx.x] = *cluster.map_shared_rank(&part, threadIdx.x);
      // done reading the other CTAs' partials; the matching wait is at the
      // end, so no CTA leaves while another may still read its partial
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      __syncthreads();
      for (int k = 0; k < nslices; ++k)
        chan_merge(cnt, mean, m2, (float)slice_count(k, L, N), ranks[k].x, ranks[k].y);
    }
  } else {
    // warp 0 merges the group's partials: lane l folds slices l, l + 32, ...
    // in order, then a shuffle-down tree folds the lanes into lane 0.  The
    // order is fixed, so every CTA of the group gets the same statistics.
    if (threadIdx.x < 32) {
      const float2* pg = partials + (long long)bg * nslices;
      for (int k = threadIdx.x; k < nslices; k += 32)
        chan_merge(cnt, mean, m2, (float)slice_count(k, L, N), pg[k].x, pg[k].y);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float on = __shfl_down_sync(0xffffffffu, cnt, off);
        const float om = __shfl_down_sync(0xffffffffu, mean, off);
        const float oq = __shfl_down_sync(0xffffffffu, m2, off);
        if (threadIdx.x + off < 32) chan_merge(cnt, mean, m2, on, om, oq);
      }
      if (threadIdx.x == 0) {
        red[0] = cnt;
        part = make_float2(mean, m2);
      }
    }
    __syncthreads();
    cnt = red[0];
    mean = part.x;
    m2 = part.y;
  }
  const float rstd = rsqrtf(m2 / cnt + eps);

  // per-channel (mul, add), once per channel of the slice
  for (int i = threadIdx.x; i < c_n; i += THREADS) {
    const float wi = i < THREADS ? w0 : load_param(w, c0 + i, w_f32);
    const float bi = i < THREADS ? b0 : load_param(bias, c0 + i, b_f32);
    table[2 * i] = rstd * wi;
    table[2 * i + 1] = bi - mean * rstd * wi;
  }
  __syncthreads();

  // apply (the split regime's apply streams x from HBM a second time); with
  // VEC > 1 a chunk lies in one channel (HW % VEC == 0, start % VEC == 0)
#pragma unroll 4
  for (int i = threadIdx.x; i < nch; i += THREADS) {
    const Ch c = MODE == APPLY ? xg[i] : xs[i];
    const int ch = (start + i * VEC) / HW - c_lo;
    const float mul = table[2 * ch], add = table[2 * ch + 1];
    Ch o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float t = fmaf(to_f(c.v[e]), mul, add);
      if (SILU) t = __fdividef(t, 1.f + __expf(-t));  // 0 (not NaN) once exp overflows
      from_f(o.v[e], t);
    }
    yg[i] = o;
  }
  if constexpr (MODE == FUSED)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int VEC, bool SILU, int MODE>
cudaError_t launch(const void* x, void* y, const void* w, const void* b, void* partials,
                   int w_f32, int b_f32, int BG, int G, int N, int HW, int L, int nslices,
                   float eps, cudaStream_t stream) {
  auto kernel = gn_kernel<T, VEC, SILU, MODE>;
  static unsigned long long attr_set = 0;
  if (cudaError_t e = set_max_dynamic_smem(kernel, SMEM_ATTR, &attr_set); e != cudaSuccess)
    return e;
  // the slice (but for APPLY, which streams x), then the table (at most a
  // group's channels; but for STATS)
  const size_t smem = (MODE == APPLY ? 0 : stage_bytes<T>(L)) +
                      (MODE == STATS ? 0 : 2 * sizeof(float) * (N / HW));
  if (smem > (size_t)SMEM_ATTR) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nslices, BG, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (MODE == FUSED) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nslices;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (T*)y, w, b, (float2*)partials,
                                     w_f32, b_f32, G, N, HW, L, nslices, eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int VEC, bool SILU>
cudaError_t run(const void* x, void* y, const void* w, const void* b, void* partials, int w_f32,
                int b_f32, int BG, int G, int N, int HW, int regime, int nslices, int L,
                float eps, cudaStream_t s) {
  if (regime == 0)
    return launch<T, VEC, SILU, FUSED>(x, y, w, b, partials, w_f32, b_f32, BG, G, N, HW, L,
                                       nslices, eps, s);
  cudaError_t e = launch<T, VEC, SILU, STATS>(x, y, w, b, partials, w_f32, b_f32, BG, G, N, HW,
                                              L, nslices, eps, s);
  if (e != cudaSuccess) return e;
  return launch<T, VEC, SILU, APPLY>(x, y, w, b, partials, w_f32, b_f32, BG, G, N, HW, L,
                                     nslices, eps, s);
}

template <typename T>
cudaError_t dispatch(int vec, int silu, const void* x, void* y, const void* w, const void* b,
                     void* partials, int w_f32, int b_f32, int BG, int G, int N, int HW,
                     int regime, int nslices, int L, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec && silu)
    return run<T, V, true>(x, y, w, b, partials, w_f32, b_f32, BG, G, N, HW, regime, nslices, L,
                           eps, s);
  if (vec)
    return run<T, V, false>(x, y, w, b, partials, w_f32, b_f32, BG, G, N, HW, regime, nslices,
                            L, eps, s);
  if (silu)
    return run<T, 1, true>(x, y, w, b, partials, w_f32, b_f32, BG, G, N, HW, regime, nslices, L,
                           eps, s);
  return run<T, 1, false>(x, y, w, b, partials, w_f32, b_f32, BG, G, N, HW, regime, nslices, L,
                          eps, s);
}

}  // namespace

extern "C" {

// x, y: contiguous (B, C, *spatial) in dtype (0 = bf16, 1 = fp32); weight
// and bias (C,) in bf16 (0) or fp32 (1) each.  The plan comes from
// groupnorm.py's launch_plan: regime 0 = single-pass cluster of `nslices`
// CTAs, 1 = split (stats + apply, `partials` = B*G*nslices float2 scratch);
// slices of L elements (the last one shorter); vec = 16-byte loads.
// Returns a cudaError_t (0 = launched).
int rr_group_norm_fwd(const void* x, void* y, const void* w, const void* b, void* partials,
                      int dtype, int w_f32, int b_f32, int BG, int G, int N, int HW, int regime,
                      int nslices, int L, int vec, int silu, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 0 || HW <= 0 || N % HW || L <= 0 || L > SLICE_MAX || nslices <= 0 ||
      (long long)nslices * L < N || (long long)(nslices - 1) * L >= N ||
      (regime == 0 && nslices > CLUSTER_MAX) || (regime != 0 && regime != 1) ||
      (vec && (N % 8 || HW % 8 || L % 8)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<__nv_bfloat16>(vec, silu, x, y, w, b, partials, w_f32, b_f32, BG, G, N,
                                        HW, regime, nslices, L, eps, s);
  if (dtype == 1)
    return (int)dispatch<float>(vec, silu, x, y, w, b, partials, w_f32, b_f32, BG, G, N, HW,
                                regime, nslices, L, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
