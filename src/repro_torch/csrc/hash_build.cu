// Fused sketch-build hashing of 32-bit join keys for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_build.py::
// hash_build: for every key k (one 4-byte block),
//   h    = murmur3-32(k, seed 0x9747B28C)
//   fib  = h * 2654435769 mod 2^32        (Fibonacci hashing, the KMV order)
//   unit = float(fib) * 2^-32            (round to nearest, then an exact
//                                          power-of-two scale)
// h and fib are written as uint32 bit patterns (the int32 tensors of the
// port's planes); the ingest wrapper widens them to int64 values once.
//
// What bounds it on an H100: bytes — 4 bytes in and 12 out per key, a few
// dozen integer operations between. The Pallas kernel's (1, block) tiling
// and m % block == 0 restriction are TPU artifacts: here a grid-stride loop
// takes any m, moving four keys per thread step with 16-byte loads and
// stores when every pointer is 16-byte aligned, one key at a time for the
// ragged tail (and for unaligned pointers).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSeed = 0x9747B28Cu;
constexpr uint32_t kC1 = 0xCC9E2D51u, kC2 = 0x1B873593u;
constexpr uint32_t kN1 = 0xE6546B64u;
constexpr uint32_t kF1 = 0x85EBCA6Bu, kF2 = 0xC2B2AE35u;
constexpr uint32_t kFib = 2654435769u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void hash_one(uint32_t k, uint32_t& h_out, uint32_t& fib_out,
                                         float& unit_out) {
  uint32_t k1 = rotl(k * kC1, 15) * kC2;
  uint32_t h = rotl(kSeed ^ k1, 13) * 5u + kN1;
  h ^= 4u;  // the key length in bytes
  h ^= h >> 16;
  h *= kF1;
  h ^= h >> 13;
  h *= kF2;
  h ^= h >> 16;
  const uint32_t fib = h * kFib;
  h_out = h;
  fib_out = fib;
  unit_out = __uint2float_rn(fib) * 0x1p-32f;
}

__global__ void __launch_bounds__(kThreads)
hash_build_vec4(const uint4* __restrict__ keys, uint4* __restrict__ h, uint4* __restrict__ fib,
                float4* __restrict__ unit, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const uint4 k = keys[i];
    uint4 hv, fv;
    float4 uv;
    hash_one(k.x, hv.x, fv.x, uv.x);
    hash_one(k.y, hv.y, fv.y, uv.y);
    hash_one(k.z, hv.z, fv.z, uv.z);
    hash_one(k.w, hv.w, fv.w, uv.w);
    h[i] = hv;
    fib[i] = fv;
    unit[i] = uv;
  }
}

__global__ void __launch_bounds__(kThreads)
hash_build_scalar(const uint32_t* __restrict__ keys, uint32_t* __restrict__ h,
                  uint32_t* __restrict__ fib, float* __restrict__ unit, long long begin,
                  long long m) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = begin + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride)
    hash_one(keys[i], h[i], fib[i], unit[i]);
}

int grid_for(long long items) {
  // enough blocks to fill the card a few times over; the loop strides past
  const long long want = (items + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// keys, h, fib: m uint32 (int32 tensors); unit: m float. Launches on
// `stream`; returns cudaGetLastError() after the launches.
extern "C" int hash_build_launch(const void* keys, void* h, void* fib, void* unit, long long m,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long done = 0;
  if (aligned16(keys) && aligned16(h) && aligned16(fib) && aligned16(unit)) {
    const long long n4 = m / 4;
    if (n4 > 0) {
      hash_build_vec4<<<grid_for(n4), kThreads, 0, s>>>(
          static_cast<const uint4*>(keys), static_cast<uint4*>(h), static_cast<uint4*>(fib),
          static_cast<float4*>(unit), n4);
      done = n4 * 4;
    }
  }
  if (done < m) {
    hash_build_scalar<<<grid_for(m - done), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(keys), static_cast<uint32_t*>(h),
        static_cast<uint32_t*>(fib), static_cast<float*>(unit), done, m);
  }
  return static_cast<int>(cudaGetLastError());
}
