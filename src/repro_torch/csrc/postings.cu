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
// Ids are column ids in [0, C), so neither kernel sorts: each marks ids in
// a bitmap of ⌈C/32⌉ words (16 KB at C = 131072) and compacts it.
//
// Merge design (two kernels after one memset of the row bitmaps and the
// rows' done-counters; 512 KB at B = 32, C = 131072, which stays in L2):
//  - flag: a block per (row, tile of 4096 slots), 16 coalesced loads a
//    thread in flight; each warp ORs its live ids into the row's bitmap
//    with one atomicOr per distinct word (a query's ids cluster: one table's
//    columns share a word). The last block of a row (a done-counter after
//    __threadfence) compacts the row's bitmap: 4 words a thread, __popc,
//    a block exclusive scan a tile of words, the prefix of every word kept,
//    and the row's distinct ids written ascending (__ffs) with count 0;
//  - count: the same blocks read the row again; a live id's slot is its
//    word's prefix plus the set bits below it in the word, and the lanes of
//    a warp holding one id (__match_any_sync) add their number to its count
//    with one atomicAdd — integer counts below 2^24 are exact in f32 in any
//    order, so the result equals the twin's bit for bit; slots past the
//    row's distinct ids get (−1, 0).
// Ids outside [0, C) are ignored, so no write leaves the scratch. Above
// the bytes bound sit each row's compaction, which one block runs after
// the row's flags are in, and the wrapper's host cost (PERF.md §6).
//
// Select design: one kernel marks each eligible id in a bitmap of ⌈C/32⌉
// words (atomicOr) with coalesced grid-stride reads of the N slots, 4 a
// thread in flight, reading a slot's count only when its id is live.
// The last block to finish (a done-counter after __threadfence) compacts
// the bitmap: tiles of 4096 words, 4 consecutive words a thread read as
// one 16-byte load, __popc counts, one block exclusive scan a tile, and
// each thread writes its set bits (__ffs) ascending from its offset, cut
// at M. What bounds it: the N slots' 8 bytes each (bytes), then one tile
// scan a 131072 columns on a single SM (latency). The bitmap and counter
// are zeroed by one memset before the launch.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMergeThreads = 256;
constexpr int kMergePer = 16;                          // slots a thread has in flight
constexpr int kMergeTile = kMergeThreads * kMergePer;  // slots of a (row, tile) block
constexpr int kSelectThreads = 1024;
constexpr int kSelectPer = 4;  // slots a thread has in flight in the flag pass
// the flag pass's largest grid: two blocks an SM of an H100 (132 SMs), a
// constant so a launch makes no device query on the host
constexpr long long kSelectMaxGrid = 264;
constexpr unsigned kFull = 0xffffffffu;

// The merge's scratch, in words: bitmaps [B][Wp] and done-counters [B]
// (zeroed by the memset), then distinct-id totals [B] and word prefixes
// [B][Wp]; Wp = ⌈C/32⌉ rounded up to 4 words, so a row's words load as uint4.
struct MergeScratch {
  uint32_t* bitmap;
  uint32_t* done;
  int32_t* total;
  int32_t* prefix;
  int Wp;
};

// this thread's kMergePer slots of the block's (row, tile): coalesced, all
// loads issued before any is used; slots past L are −1
__device__ __forceinline__ void merge_slots(const int32_t* __restrict__ row, int L, int base,
                                            int32_t (&id)[kMergePer]) {
#pragma unroll
  for (int k = 0; k < kMergePer; ++k) {
    const int s = base + k * kMergeThreads;
    id[k] = s < L ? row[s] : -1;
  }
}

__global__ void __launch_bounds__(kMergeThreads)
postings_merge_flag(const int32_t* __restrict__ cand, int L, int C, MergeScratch sc,
                    int32_t* __restrict__ cols, float* __restrict__ counts) {
  const size_t row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  uint32_t* bm = sc.bitmap + row * sc.Wp;
  int32_t id[kMergePer];
  merge_slots(cand + row * L, L, blockIdx.x * kMergeTile + threadIdx.x, id);
#pragma unroll
  for (int k = 0; k < kMergePer; ++k) {
    const bool live = id[k] >= 0 && id[k] < C;
    const int w = live ? id[k] >> 5 : -1;
    // one atomicOr per distinct word of the warp's live ids
    for (unsigned todo = __ballot_sync(kFull, live); todo != 0u;) {
      const int src = __ffs(todo) - 1;
      const int ws = __shfl_sync(kFull, w, src);
      const bool mine = live && w == ws;
      const unsigned bits = __reduce_or_sync(kFull, mine ? 1u << (id[k] & 31) : 0u);
      if (lane == src) atomicOr(bm + ws, bits);
      todo &= ~__ballot_sync(kFull, mine);
    }
  }
  __threadfence();
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sc.done + row, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the row's compaction, 4 words a thread a tile
  __shared__ int scan_scratch[repro::kMaxWarps];
  int32_t* pre = sc.prefix + row * sc.Wp;
  int32_t* out_c = cols + row * L;
  float* out_n = counts + row * L;
  int done = 0;  // distinct ids in the tiles before this one
  for (int t0 = 0; t0 < sc.Wp; t0 += 4 * kMergeThreads) {
    const int w0 = t0 + 4 * static_cast<int>(threadIdx.x);
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (w0 < sc.Wp) {
      const uint4 q = __ldcg(reinterpret_cast<const uint4*>(bm + w0));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    }
    const int mine = __popc(v[0]) + __popc(v[1]) + __popc(v[2]) + __popc(v[3]);
    int total = 0;
    int pos = done + repro::block_exclusive_scan(mine, scan_scratch, &total);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (w0 + j >= sc.Wp) break;
      pre[w0 + j] = pos;
      for (uint32_t word = v[j]; word != 0u; word &= word - 1u) {
        out_c[pos] = (w0 + j) * 32 + __ffs(word) - 1;
        out_n[pos++] = 0.f;
      }
    }
    done += total;
  }
  if (threadIdx.x == 0) sc.total[row] = done;
}

__global__ void __launch_bounds__(kMergeThreads)
postings_merge_count(const int32_t* __restrict__ cand, int L, int C, MergeScratch sc,
                     int32_t* __restrict__ cols, float* __restrict__ counts) {
  const size_t row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const uint32_t* bm = sc.bitmap + row * sc.Wp;
  const int32_t* pre = sc.prefix + row * sc.Wp;
  const int n = sc.total[row];
  int32_t* out_c = cols + row * L;
  float* out_n = counts + row * L;
  const int base = blockIdx.x * kMergeTile + threadIdx.x;
  int32_t id[kMergePer];
  merge_slots(cand + row * L, L, base, id);
#pragma unroll
  for (int k = 0; k < kMergePer; ++k) {
    const bool live = id[k] >= 0 && id[k] < C;
    int slot = 0;
    if (live) {
      const int w = id[k] >> 5;
      slot = pre[w] + __popc(bm[w] & ((1u << (id[k] & 31)) - 1u));
    }
    const unsigned peers = __match_any_sync(kFull, live ? id[k] : -1);
    if (live && lane == __ffs(peers) - 1)
      atomicAdd(out_n + slot, static_cast<float>(__popc(peers)));
    const int s = base + k * kMergeThreads;
    if (s < L && s >= n) {
      out_c[s] = -1;
      out_n[s] = 0.f;
    }
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

// Merges B rows of L ids in [0, C) (others are ignored); `scratch` is
// 2·B·Wp + 2·B words of device memory, Wp = ⌈C/32⌉ rounded up to a multiple
// of 4. Returns cudaGetLastError() after the launches.
extern "C" int postings_merge_launch(const void* cand, int B, int L, int C, void* scratch,
                                     void* cols, void* counts, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  MergeScratch sc;
  sc.Wp = ((C + 31) / 32 + 3) & ~3;
  sc.bitmap = static_cast<uint32_t*>(scratch);
  sc.done = sc.bitmap + static_cast<size_t>(B) * sc.Wp;
  sc.total = reinterpret_cast<int32_t*>(sc.done + B);
  sc.prefix = sc.total + B;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(uint32_t) * (static_cast<size_t>(B) * sc.Wp + B), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kMergeTile - 1) / kMergeTile, B);
  postings_merge_flag<<<grid, kMergeThreads, 0, st>>>(static_cast<const int32_t*>(cand), L, C,
                                                      sc, static_cast<int32_t*>(cols),
                                                      static_cast<float*>(counts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  postings_merge_count<<<grid, kMergeThreads, 0, st>>>(static_cast<const int32_t*>(cand), L, C,
                                                       sc, static_cast<int32_t*>(cols),
                                                       static_cast<float*>(counts));
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
