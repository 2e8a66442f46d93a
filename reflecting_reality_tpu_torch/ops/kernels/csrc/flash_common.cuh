// Shared pieces of the flash-attention kernels: the head-dim padding rule,
// the constants and the bf16 packing both flash_attn_fwd.cu and
// flash_attn_bwd.cu use, and the backward's mma.sync / ldmatrix / cp.async
// wrappers and shared-memory tile loader.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int PADH = 8;     // bf16 of row padding in shared memory (conflict-free ldmatrix)
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

// The A fragment of an m16n8k16 product whose 16-wide k chunk is the two
// 8-column accumulator fragments c0 (k 0..7) and c1 (k 8..15) of an earlier
// product: an S or dS tile re-used as an operand without leaving registers.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// 16-byte global -> shared copy; src_bytes == 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// 4-byte global -> shared copy; src_bytes == 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) of one head into shared memory [ROWS][DP + PADH];
// columns >= D and rows >= nrows are zero.  16-byte copies (D % 8 == 0).
template <int DP, int ROWS = 64>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          long long row_stride, int row0, int nrows, int D) {
  constexpr int CPR = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int row = row0 + r;
    const bool ok = row < nrows && c < D;
    cp_async16(s + r * (DP + PADH) + c, ok ? g + (long long)row * row_stride + c : g,
               ok ? 16 : 0);
  }
}

// Padded head dim of the bf16 instance that takes D (0 if none does): the
// SD-1.5 head dims 40, 80 and 160 pad to 48, 80 and 160; 64 is its own.
inline int padded_dim(int D) {
  if (D <= 0 || D > MAX_D || D % 8 != 0) return 0;
  const int choices[] = {48, 64, 80, 160};
  for (int c : choices)
    if (c >= D) return c;
  return 0;
}

}  // namespace flash
