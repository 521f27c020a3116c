// Batched containment counts (exact key-intersection sizes) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/containment.py::
// containment_hits (and its per-query vmap in src/repro/kernels/ops.py::
// containment_hits_batched): for every query row b and candidate c,
//   hits[b, c] = |{(i, j) : q_kh[b, i] == c_kh[c, j], both slots valid}|,
// which — keys being distinct within a sketch — is the sketch-join sample
// size m, the count stage 1 of two-stage retrieval filters on.
//
// What bounds it on an H100: bytes. The candidate key and mask planes (8
// bytes a slot) are read once; the query batch is small and stays in L2;
// the output is B·C floats. The compare work of the binary searches is
// small beside the planes.
//
// Design: one block per candidate, as in sketch_join.cu without the value
// planes. The Pallas kernel builds an nq × n equality tile per candidate in
// VMEM; here the block sorts the candidate's valid keys (invalid slots after
// them) once in shared memory, then every thread takes (row, slot) pairs of
// the whole [B, nq] batch, finds the slot's key by binary search and counts
// its equal keys. Counts are integers summed with shared-memory atomics, so
// the result is exact and independent of scheduling. One launch covers all
// C candidates and all B rows: no chunk loop, nothing [B, C, nq]-sized.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
containment_kernel(const int32_t* __restrict__ q_kh, const float* __restrict__ q_mask,
                   const int32_t* __restrict__ c_kh, const float* __restrict__ c_mask,
                   int B, int nq, int C, int n, int np2, float* __restrict__ hits) {
  extern __shared__ unsigned long long keys[];  // [np2], then int counts[B]
  int* counts = reinterpret_cast<int*>(keys + np2);
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
      if (j < n) {
        ok = c_mask[cbase + j] > 0.f;
        key = ok ? static_cast<unsigned long long>(static_cast<uint32_t>(c_kh[cbase + j]))
                 : ((1ull << 32) | static_cast<unsigned long long>(j));
      }
      keys[j] = key;
    }
    nvalid += __syncthreads_count(ok);
  }
  for (int b = threadIdx.x; b < B; b += blockDim.x) counts[b] = 0;
  repro::bitonic_sort(keys, np2);

  const int total = B * nq;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    if (q_mask[t] > 0.f) {
      const unsigned long long q =
          static_cast<unsigned long long>(static_cast<uint32_t>(q_kh[t]));
      int lo = 0, hi = nvalid;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < q) lo = mid + 1; else hi = mid;
      }
      int cnt = 0;
      for (int p = lo; p < nvalid && keys[p] == q; ++p) ++cnt;
      if (cnt) atomicAdd(&counts[t / nq], cnt);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    hits[static_cast<size_t>(b) * C + c] = static_cast<float>(counts[b]);
}

}  // namespace

// Launches on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int containment_hits_launch(const void* q_kh, const void* q_mask, const void* c_kh,
                                       const void* c_mask, int B, int nq, int C, int n,
                                       void* hits, void* stream) {
  const int np2 = repro::next_pow2(n);
  const size_t smem = static_cast<size_t>(np2) * sizeof(unsigned long long) +
                      static_cast<size_t>(B) * sizeof(int);
  containment_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q_kh), static_cast<const float*>(q_mask),
      static_cast<const int32_t*>(c_kh), static_cast<const float*>(c_mask), B, nq, C, n, np2,
      static_cast<float*>(hits));
  return static_cast<int>(cudaGetLastError());
}
