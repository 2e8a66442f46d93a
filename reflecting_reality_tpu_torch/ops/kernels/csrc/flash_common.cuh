// Shared pieces of the flash-attention kernels (flash_attn_fwd.cu and
// flash_attn_bwd.cu): the head-dim padding rule, the CTA shape of the
// warp-specialised wgmma kernels (one producer and two consumer
// warpgroups), the 16-column swizzled slabs their operands live in with
// the two wgmma products over them, the accumulator -> A-fragment packing,
// the fp32 instances' hi/lo split, transpose and three-pass TF32 products,
// and the host helper that encodes the 4-D tensor map of one (B, T, H, D)
// operand.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

constexpr int MAX_D = 160;  // the largest head dim taken (SD-1.5's level-2 heads)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int CTA_BM = 128;  // rows a CTA owns (64 per consumer warpgroup)
constexpr int WG_BM = 64;
constexpr int WG_THREADS = 128;
constexpr int CTA_THREADS = 3 * WG_THREADS;
constexpr int SLAB = 16;     // head-dim columns per 32-byte swizzled slab
constexpr int SLAB_BYTES = 32;
constexpr int BAR_PING = 1;  // named barriers 1, 2: consumer 0's and 1's turn

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Column groups 2kk and 2kk+1 of a 64 x N wgmma accumulator (this thread's
// rows g and g + 8) form the A-register fragment of k chunk kk of a product
// that takes the accumulator, rounded to bf16, as its A operand.
template <int N>
__device__ __forceinline__ void to_a_fragments(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_f32(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_f32(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_f32(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_f32(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Descriptor of a K-major operand: a 16-column slab, rows 32 bytes apart,
// core matrices of 8 rows 256 bytes apart.
__device__ __forceinline__ uint64_t kmajor(const unsigned char* p) {
  return hopper::make_desc(p, 16, 256, hopper::SWIZZLE_32B);
}

// Descriptor of 16 rows of a `rows`-row tile read MN-major (the rows are the
// product's k, the head-dim columns its n): slabs rows * 32 bytes apart.
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* p, int rows) {
  return hopper::make_desc(p, rows * SLAB_BYTES, 256, hopper::SWIZZLE_32B);
}

// d (64 x N) = A B^T over DP columns: A this warpgroup's 64 rows of a CTA_BM-row
// tile, B an N-row tile, both K-major.  Not committed.
template <int DP, int N>
__device__ __forceinline__ void issue_abt(float (&d)[N / 2], const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int c = 0; c < DP / SLAB; ++c)
    hopper::wgmma_ss<N>(d, kmajor(a + c * CTA_BM * SLAB_BYTES), kmajor(b + c * N * SLAB_BYTES),
                        c > 0);
}

// d (64 x DP) += A B: A in registers (64 x K, bf16 fragments), B a K-row
// tile read MN-major.  Not committed.
template <int DP, int K>
__device__ __forceinline__ void issue_ab(float (&d)[DP / 2], const uint32_t (&a)[K / 16][4],
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    hopper::wgmma_rs<DP>(d, a[kk], mnmajor(b + kk * 16 * SLAB_BYTES, K));
}

// ------------------------------------------------------ fp32 (3xTF32) pieces
//
// The fp32 instances of B1, B3 and B4 run on the TF32 tensor cores with
// error-compensated products: each operand x is split into hi (x with its
// low 13 mantissa bits cleared) and lo (x - hi, its own cleared), and each
// product is three passes into one fp32 accumulator, the small terms first:
// hi * lo, lo * hi, then hi * hi.  TF32 wgmma takes K-major operands only,
// so an operand whose product runs over its rows is written transposed by
// the producer warpgroup's warps 1-3.

constexpr int F_SLAB = 8;                    // fp32 columns per 32-byte slab: one TF32 k step
constexpr int XF_THREADS = WG_THREADS - 32;  // producer warps 1-3: hi/lo splits and transposes

// x (n float4s) -> its TF32 hi in place and its lo into `lo`, one float4 a
// thread at a time: the layout is kept, so TMA's swizzle holds for both.
__device__ __forceinline__ void split_tile(unsigned char* x, unsigned char* lo, int n, int t) {
  for (int i = t; i < n; i += XF_THREADS) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    uint4 h, l;
    hopper::tf32_split(v.x, h.x, l.x);
    hopper::tf32_split(v.y, h.y, l.y);
    hopper::tf32_split(v.z, h.z, l.z);
    hopper::tf32_split(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(x)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// A raw tile (BN rows x DP columns in 8-column slabs, 32-byte swizzle, as
// TMA wrote it) -> its transpose, hi and lo: per group of 8 rows one slab of
// DP rows (head-dim columns) x 8, K-major for a product over the tile's
// rows, 32-byte swizzle.  Slot s of a group holds row 2 * (s % 4) + s / 4:
// the order in which an accumulator hands its columns to the A fragment
// (`to_tf32_fragments`).  A thread writes one 16-byte half (the even rows or
// the odd ones) of one row, so eight neighbouring threads fill four whole
// rows: the stores meet no bank conflicts (the scalar loads two-way, from
// two slabs).  With SPLIT the raw tile is split as well, into hi (in place)
// and lo (`vl`, the same layout): each raw value is read by one thread,
// which writes it back as its hi.
template <int DP, int BN, bool SPLIT>
__device__ __forceinline__ void transpose_tile(unsigned char* v, unsigned char* vl,
                                               unsigned char* th, unsigned char* tl, int t) {
  for (int u = t; u < 2 * DP * (BN / 8); u += XF_THREADS) {
    const int par = u & 1, d = (u >> 1) % DP, kg = (u >> 1) / DP;
    const int col = (d / 8) * BN * SLAB_BYTES + (d % 4) * 4;
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = kg * 8 + 2 * i + par;  // slot 4 * par + i
      const int off = col + j * SLAB_BYTES + ((((d % 8) >> 2) ^ ((j >> 2) & 1)) << 4);
      hopper::tf32_split(*reinterpret_cast<const float*>(v + off), h[i], l[i]);
      if constexpr (SPLIT) {
        *reinterpret_cast<uint32_t*>(v + off) = h[i];
        *reinterpret_cast<uint32_t*>(vl + off) = l[i];
      }
    }
    const int off = kg * DP * SLAB_BYTES + d * SLAB_BYTES + ((par ^ ((d >> 2) & 1)) << 4);
    *reinterpret_cast<uint4*>(th + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(tl + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// A 64 x N fp32 accumulator as TF32 A fragments (hi and lo) of a product
// over its N columns.  K step kk covers columns 8kk..8kk+7; thread (g, c)
// holds columns 2c and 2c+1 of rows g and g + 8, and the fragment wants
// slots c and c + 4 of the same rows: slot c takes column 2c and slot c + 4
// column 2c + 1, so no value moves between threads and the B operand's
// slots are permuted to match (`transpose_tile`).
template <int N>
__device__ __forceinline__ void to_tf32_fragments(uint32_t (&hi)[N / 8][4],
                                                  uint32_t (&lo)[N / 8][4],
                                                  const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    hopper::tf32_split(c[4 * kk + 0], hi[kk][0], lo[kk][0]);  // row g, column 2c
    hopper::tf32_split(c[4 * kk + 2], hi[kk][1], lo[kk][1]);  // row g + 8, column 2c
    hopper::tf32_split(c[4 * kk + 1], hi[kk][2], lo[kk][2]);  // row g, column 2c + 1
    hopper::tf32_split(c[4 * kk + 3], hi[kk][3], lo[kk][3]);  // row g + 8, column 2c + 1
  }
}

// d (64 x N) = A B^T over DP columns in three TF32 passes: A this
// warpgroup's 64 rows of an M-row tile, B an N-row tile, each as hi and lo,
// all K-major in 8-column slabs.  The first pass overwrites d.  Not
// committed.
template <int DP, int M, int N>
__device__ __forceinline__ void issue_abt_tf32(float (&d)[N / 2], const unsigned char* ah,
                                               const unsigned char* al, const unsigned char* bh,
                                               const unsigned char* bl) {
#pragma unroll
  for (int c = 0; c < DP / F_SLAB; ++c)
    hopper::wgmma_ss_tf32<N>(d, kmajor(ah + c * M * SLAB_BYTES), kmajor(bl + c * N * SLAB_BYTES),
                             c > 0);
#pragma unroll
  for (int c = 0; c < DP / F_SLAB; ++c)
    hopper::wgmma_ss_tf32<N>(d, kmajor(al + c * M * SLAB_BYTES), kmajor(bh + c * N * SLAB_BYTES),
                             1);
#pragma unroll
  for (int c = 0; c < DP / F_SLAB; ++c)
    hopper::wgmma_ss_tf32<N>(d, kmajor(ah + c * M * SLAB_BYTES), kmajor(bh + c * N * SLAB_BYTES),
                             1);
}

// d (64 x N) = A B over K in three TF32 passes, a fresh accumulator (the
// first pass overwrites d): A in registers (`to_tf32_fragments` of a 64 x K
// accumulator), B transposed (`transpose_tile`), hi and lo, K / 8 slabs
// `slab_bytes` apart of which the product reads N rows.  Not committed.
template <int N, int K>
__device__ __forceinline__ void issue_ab_tf32(float (&d)[N / 2], const uint32_t (&a_hi)[K / 8][4],
                                              const uint32_t (&a_lo)[K / 8][4],
                                              const unsigned char* bh, const unsigned char* bl,
                                              int slab_bytes) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    hopper::wgmma_rs_tf32<N>(d, a_lo[kk], kmajor(bh + kk * slab_bytes), kk > 0);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    hopper::wgmma_rs_tf32<N>(d, a_hi[kk], kmajor(bl + kk * slab_bytes), 1);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    hopper::wgmma_rs_tf32<N>(d, a_hi[kk], kmajor(bh + kk * slab_bytes), 1);
}

// The dynamic shared memory base rounded up to 1 KB (every operand then
// starts on a whole 32-byte swizzle pattern).
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// The tensor map of one (B, T, H, D) operand, bf16 or (f32) fp32: dims
// (D, H, T, B), byte strides of H, T and B, a box of one 32-byte slab (16
// bf16 or 8 fp32 columns) x `rows` tokens of one head.  Columns past D and
// tokens past T read as zero.
inline cudaError_t operand_map(CUtensorMap* map, const void* base, int B, int T, int H, int D,
                               long long sb, long long st, int rows, bool f32 = false) {
  const uint64_t item = f32 ? 4 : 2;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * item, (uint64_t)st * item, (uint64_t)sb * item};
  const uint32_t box[4] = {(uint32_t)(SLAB_BYTES / item), 1, (uint32_t)rows, 1};
  return hopper_host::encode_4d(map,
                                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                base, dims, strides, box);
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

// Padded head dim of the fp32 (TF32) instance that takes D (0 if none
// does): its slabs are 8 columns wide, so 40 and 80 are their own; 8-32 pad
// to 40, 48-56 to 64, 72 to 80, 88-152 to 160.
inline int f32_padded_dim(int D) {
  if (D <= 0 || D > MAX_D || D % 8 != 0) return 0;
  const int choices[] = {40, 64, 80, 160};
  for (int c : choices)
    if (c >= D) return c;
  return 0;
}

}  // namespace flash
