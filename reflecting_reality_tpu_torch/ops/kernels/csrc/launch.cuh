// Host-side launch helper shared by the port's kernel libraries.
#pragma once

#include <cuda_runtime.h>

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes on the
// current device, once a device: the attribute belongs to each device's
// context, so a process that launches on several cards (data-parallel
// replicas, the sharded decodes) sets it on every one.  `done` holds one bit
// a device; a lost update between two threads only sets it once more.
template <typename K>
inline cudaError_t set_max_dynamic_smem(K kernel, int smem, unsigned long long* done) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (*done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) *done |= bit;
  return e;
}
