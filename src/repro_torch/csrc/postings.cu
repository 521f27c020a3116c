// Postings merge and survivor select for the inverted candidate source, for
// Hopper (sm_90a).
//
// postings_merge replaces the Pallas TPU kernel src/repro/kernels/
// postings.py::postings_merge: each row of cand i32[B, L] (L = n·W, the
// column ids matched in the gathered postings windows, −1 elsewhere) becomes
// (cols, counts) with every distinct id ≥ 0 once, with its multiplicity —
// the exact key-intersection size of the query and that column. This kernel
// writes the ids ascending and compacted to the front, then (−1, 0): the
// layout of the plain twin (the contract itself is set equality per row).
//
// postings_select replaces src/repro/kernels/postings.py::postings_select:
// over all rows at once, the distinct ids with col ≥ 0 and count ≥ floor
// (a run-time value), ascending, written to the first min(n_surv, M) slots of
// surv i32[M] with zeros beyond, valid = slot < min(n_surv, M), and n_surv
// the number of all such ids — n_surv > M flags an overflowing rung.
//
// What bounds them on an H100: bytes, and at the engine's sizes they are
// latency-bound (a few MB at most). Both Pallas kernels build O(L²) or
// O(N²) pairwise equality tiles in VMEM, which is the wrong shape here.
//
// Merge design: one block per row sorts the row (a bitonic network; −1
// becomes INT32_MAX and sorts last) in dynamic shared memory when it fits
// (the wrapper opts in above 48 KB), else in a global-memory scratch row the
// wrapper allocates — so every L the window ladder can give launches. Each
// thread then owns a contiguous span of the sorted row, counts the run
// heads in it, and a block prefix sum gives every head its compacted slot;
// a head's count is its run length.
//
// Select design: ids are column ids in [0, C), so no sort is needed. One
// kernel marks each eligible id in a bitmap of ⌈C/32⌉ words (atomicOr;
// 16 KB at C = 131072) with coalesced grid-stride reads of the N slots,
// 4 a thread in flight, reading a slot's count only when its id is live.
// The last block to finish (a done-counter after __threadfence) compacts
// the bitmap: tiles of 4096 words, 4 consecutive words a thread read as
// one 16-byte load, __popc counts, one block exclusive scan a tile, and
// each thread writes its set bits (__ffs) ascending from its offset, cut
// at M. What bounds it: the N slots' 8 bytes each (bytes), then one tile
// scan a 131072 columns on a single SM (latency). The bitmap and counter
// are zeroed by one memset before the launch.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMergeThreads = 1024;
constexpr int kSelectThreads = 1024;
constexpr int kSelectPer = 4;  // slots a thread has in flight in the flag pass
// the flag pass's largest grid: two blocks an SM of an H100 (132 SMs), a
// constant so a launch makes no device query on the host
constexpr long long kSelectMaxGrid = 264;

__device__ __forceinline__ bool run_head(const int32_t* s, int i) {
  return s[i] != INT_MAX && (i == 0 || s[i - 1] != s[i]);
}

__global__ void __launch_bounds__(kMergeThreads)
postings_merge_kernel(const int32_t* __restrict__ cand, int L, int np2, int32_t* scratch,
                      int32_t* __restrict__ cols, float* __restrict__ counts) {
  extern __shared__ int32_t smem[];
  __shared__ int scan_scratch[repro::kMaxWarps];
  const size_t row = static_cast<size_t>(blockIdx.x);
  int32_t* s = scratch != nullptr ? scratch + row * np2 : smem;
  const int32_t* in = cand + row * L;
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    const int32_t v = i < L ? in[i] : -1;
    s[i] = v < 0 ? INT_MAX : v;
  }
  repro::bitonic_sort(s, np2);

  const int per = (np2 + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, np2);
  const int hi = min(lo + per, np2);
  int heads = 0;
  for (int i = lo; i < hi; ++i) heads += run_head(s, i);
  int total = 0;
  int pos = repro::block_exclusive_scan(heads, scan_scratch, &total);
  int32_t* out_c = cols + row * L;
  float* out_n = counts + row * L;
  for (int i = lo; i < hi; ++i) {
    if (run_head(s, i)) {
      int e = i + 1;
      while (e < np2 && s[e] == s[i]) ++e;
      out_c[pos] = s[i];
      out_n[pos] = static_cast<float>(e - i);
      ++pos;
    }
  }
  for (int i = total + threadIdx.x; i < L; i += blockDim.x) {
    out_c[i] = -1;
    out_n[i] = 0.f;
  }
}

__global__ void __launch_bounds__(kSelectThreads)
postings_select_kernel(const int32_t* __restrict__ cols, const float* __restrict__ counts,
                       long long N, float min_count, int C, int M, uint32_t* bitmap, int W,
                       int32_t* __restrict__ surv, unsigned char* __restrict__ valid,
                       int32_t* __restrict__ n_surv) {
  // flag pass: slots i0 + k·stride, k < kSelectPer, loaded before any atomic
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i0 < N;
       i0 += stride * kSelectPer) {
    int32_t c[kSelectPer];
#pragma unroll
    for (int k = 0; k < kSelectPer; ++k) {
      const long long i = i0 + k * stride;
      c[k] = i < N ? cols[i] : -1;
    }
#pragma unroll
    for (int k = 0; k < kSelectPer; ++k) {
      if (c[k] >= 0 && c[k] < C && counts[i0 + k * stride] >= min_count)
        atomicOr(&bitmap[c[k] >> 5], 1u << (c[k] & 31));
    }
  }
  __threadfence();
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&bitmap[W], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // compaction by the last block, a tile of 4 words a thread at a time
  __shared__ int scan_scratch[repro::kMaxWarps];
  int done = 0;  // eligible ids in the tiles before this one
  for (int t0 = 0; t0 < W; t0 += 4 * kSelectThreads) {
    const int w0 = t0 + 4 * static_cast<int>(threadIdx.x);
    uint32_t v[4];
    if (w0 + 3 < W) {
      const uint4 q = __ldcg(reinterpret_cast<const uint4*>(bitmap + w0));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = w0 + k < W ? __ldcg(bitmap + w0 + k) : 0u;
    }
    const int mine = __popc(v[0]) + __popc(v[1]) + __popc(v[2]) + __popc(v[3]);
    int total = 0;
    int pos = done + repro::block_exclusive_scan(mine, scan_scratch, &total);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      for (uint32_t word = v[k]; word != 0u && pos < M; word &= word - 1u)
        surv[pos++] = (w0 + k) * 32 + __ffs(word) - 1;
    }
    done += total;
  }
  const int kept = min(done, M);
  for (int i = kept + threadIdx.x; i < M; i += blockDim.x) surv[i] = 0;
  for (int i = threadIdx.x; i < M; i += blockDim.x) valid[i] = i < kept;
  if (threadIdx.x == 0) *n_surv = done;
}

}  // namespace

// Merges B rows of L ids. `scratch` is null to sort in dynamic shared memory
// (np2 ints a block), or B·np2 ints of device memory. Returns
// cudaGetLastError() after the launch.
extern "C" int postings_merge_launch(const void* cand, int B, int L, int np2, void* scratch,
                                     void* cols, void* counts, void* stream) {
  const size_t smem = scratch != nullptr ? 0 : static_cast<size_t>(np2) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        postings_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  postings_merge_kernel<<<B, kMergeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), L, np2, static_cast<int32_t*>(scratch),
      static_cast<int32_t*>(cols), static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Selects from N = B·L merged slots with ids in [0, C); `scratch` is
// ⌈C/32⌉ + 1 words of device memory (the bitmap, then the done-counter).
// Writes surv i32[M], valid u8[M] and n_surv i32[1]. Returns
// cudaGetLastError() after the launch.
extern "C" int postings_select_launch(const void* cols, const void* counts, long long N,
                                      float min_count, int C, int M, void* scratch, void* surv,
                                      void* valid, void* n_surv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = (C + 31) / 32;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(uint32_t) * (static_cast<size_t>(W) + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (N + kSelectThreads * kSelectPer - 1) / (kSelectThreads * kSelectPer);
  const int grid = static_cast<int>(std::max(1LL, std::min(want, kSelectMaxGrid)));
  postings_select_kernel<<<grid, kSelectThreads, 0, st>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(counts), N, min_count, C, M,
      static_cast<uint32_t*>(scratch), W, static_cast<int32_t*>(surv),
      static_cast<unsigned char*>(valid), static_cast<int32_t*>(n_surv));
  return static_cast<int>(cudaGetLastError());
}
