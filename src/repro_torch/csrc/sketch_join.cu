// Batched sketch join with fused moment accumulation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sketch_join.py::
// sketch_join_moments (and its per-query vmap in src/repro/kernels/ops.py::
// sketch_join_moments_batched): B query sketches are intersected with C
// candidate sketches on equal key hashes, and each (query, candidate) pair
// yields the six join moments (m, Σa, Σb, Σa², Σb², Σab), plus — for the rank
// and Qn estimators — the candidate values aligned to the query slots and the
// hit flags.
//
// What bounds it on an H100: bytes. The candidate planes (12 bytes a slot)
// are read once, and when the aligned/hit outputs are asked for they are
// B·C·nq·8 bytes of writes, the largest traffic of the query path. The
// compare work of a binary search is small beside that.
//
// Design: one block per candidate. The Pallas kernel builds an nq × n
// equality tile per candidate in VMEM; here the block instead sorts the
// candidate's valid keys (invalid slots after them) once in shared memory,
// then loops over the B query rows so the candidate is read from device
// memory once per launch, not once per query. Each thread takes query slots
// and binary-searches the sorted keys; equal keys are summed, so duplicate
// keys behave as in the equality formulation. The six moments are reduced in
// a fixed tree (common.cuh), with no atomics: results are deterministic.
// Key planes arrive as int32 bit patterns and are compared for equality only.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sketch_join_kernel(const int32_t* __restrict__ q_kh, const float* __restrict__ q_val,
                   const float* __restrict__ q_mask, const int32_t* __restrict__ c_kh,
                   const float* __restrict__ c_val, const float* __restrict__ c_mask,
                   int B, int nq, int C, int n, int np2, float* __restrict__ mom,
                   float* __restrict__ aligned, float* __restrict__ hit) {
  extern __shared__ unsigned long long keys[];  // [np2], then float vals[np2]
  float* vals = reinterpret_cast<float*>(keys + np2);
  __shared__ float scratch[6 * repro::kMaxWarps];
  const int c = blockIdx.x;
  const size_t cbase = static_cast<size_t>(c) * n;

  // valid slots keyed by their 32-bit hash; invalid and padding slots get
  // keys above 2^32, so they sort after every valid key and never match
  int nvalid = 0;
  for (int base = 0; base < np2; base += blockDim.x) {
    const int j = base + threadIdx.x;
    int ok = 0;
    if (j < np2) {
      unsigned long long key = ~0ull;
      float v = 0.f;
      if (j < n) {
        ok = c_mask[cbase + j] > 0.f;
        key = ok ? static_cast<unsigned long long>(static_cast<uint32_t>(c_kh[cbase + j]))
                 : ((1ull << 32) | static_cast<unsigned long long>(j));
        v = c_val[cbase + j];
      }
      keys[j] = key;
      vals[j] = v;
    }
    nvalid += __syncthreads_count(ok);
  }
  repro::bitonic_sort(keys, vals, np2);

  for (int b = 0; b < B; ++b) {
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const size_t qbase = static_cast<size_t>(b) * nq;
    const size_t obase = (static_cast<size_t>(b) * C + c) * nq;
    for (int i = threadIdx.x; i < nq; i += blockDim.x) {
      float h = 0.f, al = 0.f;
      if (q_mask[qbase + i] > 0.f) {
        const unsigned long long q =
            static_cast<unsigned long long>(static_cast<uint32_t>(q_kh[qbase + i]));
        int lo = 0, hi = nvalid;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (keys[mid] < q) lo = mid + 1; else hi = mid;
        }
        for (int p = lo; p < nvalid && keys[p] == q; ++p) {
          al += vals[p];
          h = 1.f;
        }
      }
      const float a = q_val[qbase + i] * h;
      s[0] += h;
      s[1] += a;
      s[2] += al;
      s[3] += a * a;
      s[4] += al * al;
      s[5] += a * al;
      if (aligned != nullptr) {
        aligned[obase + i] = al;
        hit[obase + i] = h;
      }
    }
    repro::block_sum(s, scratch);
    if (threadIdx.x == 0) {
      float* out = mom + (static_cast<size_t>(b) * C + c) * 6;
#pragma unroll
      for (int k = 0; k < 6; ++k) out[k] = s[k];
    }
  }
}

}  // namespace

// Launches on `stream`; aligned and hit may both be null (moments only).
// Returns cudaGetLastError() after the launch.
extern "C" int sketch_join_moments_launch(const void* q_kh, const void* q_val,
                                          const void* q_mask, const void* c_kh,
                                          const void* c_val, const void* c_mask,
                                          int B, int nq, int C, int n, void* mom,
                                          void* aligned, void* hit, void* stream) {
  const int np2 = repro::next_pow2(n);
  const size_t smem = static_cast<size_t>(np2) * (sizeof(unsigned long long) + sizeof(float));
  sketch_join_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q_kh), static_cast<const float*>(q_val),
      static_cast<const float*>(q_mask), static_cast<const int32_t*>(c_kh),
      static_cast<const float*>(c_val), static_cast<const float*>(c_mask), B, nq, C, n, np2,
      static_cast<float*>(mom), static_cast<float*>(aligned), static_cast<float*>(hit));
  return static_cast<int>(cudaGetLastError());
}
