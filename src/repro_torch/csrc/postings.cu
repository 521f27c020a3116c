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
// Design. Merge: one block per row sorts the row (a bitonic network; −1
// becomes INT32_MAX and sorts last) in dynamic shared memory when it fits
// (the wrapper opts in above 48 KB), else in a global-memory scratch row the
// wrapper allocates — so every L the window ladder can give launches. Each
// thread then owns a contiguous span of the sorted row, counts the run
// heads in it, and a block prefix sum gives every head its compacted slot;
// a head's count is its run length. Select: ids are column ids in [0, C),
// so one pass marks eligible ids in a C-byte flag array and one block
// compacts the flags in order with a prefix sum — O(N + C), no sort. The
// C flags cost microseconds on this card; dropping them is later work.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMergeThreads = 1024;
constexpr int kSelectThreads = 1024;

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
  repro::bitonic_sort<int32_t, int32_t>(s, nullptr, np2);

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

__global__ void postings_flag_kernel(const int32_t* __restrict__ cols,
                                     const float* __restrict__ counts, long long N, float min_count,
                                     int C, unsigned char* __restrict__ flags) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < N;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int32_t c = cols[i];
    if (c >= 0 && c < C && counts[i] >= min_count) flags[c] = 1;
  }
}

__global__ void __launch_bounds__(kSelectThreads)
postings_compact_kernel(const unsigned char* __restrict__ flags, int C, int M,
                        int32_t* __restrict__ surv, unsigned char* __restrict__ valid,
                        int32_t* __restrict__ n_surv) {
  __shared__ int scan_scratch[repro::kMaxWarps];
  const int per = (C + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, C);
  const int hi = min(lo + per, C);
  int mine = 0;
  for (int c = lo; c < hi; ++c) mine += flags[c];
  int total = 0;
  int pos = repro::block_exclusive_scan(mine, scan_scratch, &total);
  for (int c = lo; c < hi && pos < M; ++c) {
    if (flags[c]) surv[pos++] = c;
  }
  const int kept = min(total, M);
  for (int i = kept + threadIdx.x; i < M; i += blockDim.x) surv[i] = 0;
  for (int i = threadIdx.x; i < M; i += blockDim.x) valid[i] = i < kept;
  if (threadIdx.x == 0) *n_surv = total;
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

// Selects from N = B·L merged slots with ids in [0, C); `flags` is C bytes
// of device scratch. Writes surv i32[M], valid u8[M] and n_surv i32[1].
// Returns cudaGetLastError() after the launches.
extern "C" int postings_select_launch(const void* cols, const void* counts, long long N,
                                      float min_count, int C, int M, void* flags, void* surv,
                                      void* valid, void* n_surv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, static_cast<size_t>(C), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N > 0) {
    const long long want = (N + 255) / 256;
    const int grid = static_cast<int>(want < 4096 ? want : 4096);
    postings_flag_kernel<<<grid, 256, 0, st>>>(static_cast<const int32_t*>(cols),
                                               static_cast<const float*>(counts), N, min_count, C,
                                               static_cast<unsigned char*>(flags));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  postings_compact_kernel<<<1, kSelectThreads, 0, st>>>(
      static_cast<const unsigned char*>(flags), C, M, static_cast<int32_t*>(surv),
      static_cast<unsigned char*>(valid), static_cast<int32_t*>(n_surv));
  return static_cast<int>(cudaGetLastError());
}
