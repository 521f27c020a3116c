// Helpers shared by the port's kernels: a warp's deterministic sum (a
// fixed shuffle tree — no atomics, so a result never depends on
// scheduling), an exclusive prefix sum over the block of one int per
// thread, and the next power of two.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kMaxWarps = 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// Exclusive prefix sum over the block of one int per thread, in thread
// order; *total receives the block's sum. scratch: kMaxWarps ints of shared
// memory. Every thread of the block must call it, and blockDim.x must be a
// multiple of 32.
__device__ inline int block_exclusive_scan(int x, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nwarps ? scratch[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    scratch[lane] = t;
  }
  __syncthreads();
  *total = scratch[nwarps - 1];
  return incl - x + (warp > 0 ? scratch[warp - 1] : 0);
}

inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace repro
