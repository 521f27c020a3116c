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
// bytes a slot, 268 MB at 131072 columns of 256) are read once; the query
// batch is small and the output is B·C floats. The old design (one block a
// candidate, a bitonic sort of its keys, a binary search of every query
// slot) did C·B·nq·log n shared probes and re-read the query batch from L2
// in every block: 146× its bytes.
//
// Design: the roles are inverted, since the query batch is the same for
// every candidate. Each block builds a hash table of the batch's valid
// query keys once, in shared memory: buckets of two 64-bit entries (key,
// and a payload of the query row and how many times that row holds the
// key, placed by atomicCAS with linear probing over buckets, a row's
// repeats counted by atomicAdd), 2–4 entries for each (row, slot). Every
// 32-bit value is a possible key, so an entry is empty when its payload is
// 0 (a count is ≥ 1). Nearly every probe misses (a query joins few
// columns), and random 16-byte loads through the chains of a warp's 256
// keys were what held a first version of this design (as slow at 1 query
// as at 32, whatever the table's size): so a bit filter of 32 bits
// a table entry (one bit per key, other bits of the same hash) sits in
// front of the table, and a probe is one 4-byte shared load; about one key
// in 64 that is not in the table goes on to it. The blocks are persistent,
// one an SM, and walk tiles of candidates: one warp a candidate, 16-byte
// loads of its keys and mask (the next 256 slots in flight while these are
// probed), each valid key probed once — C·n probes in all, and the planes
// read once. A lookup that matches adds the entry's count to a lane-held
// tally of one row, spilled to a shared [rows × tile] array of integer
// counts at a change of row and at the candidate's end (warp-aggregated
// when all its lanes hold one row). After a barrier the tile is stored row
// by row, coalesced over c. A batch whose table would not fit runs in
// passes of rows (grid.y); `repro_torch.kernels.containment.plan` picks
// rows a pass, passes, table size, tile, grid and shared bytes, and the
// launcher takes them as they are. Counts are integers: the result is
// exact and independent of scheduling.
#include "common.cuh"

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kRowShift = 20;  // payload: row << 20 | count (count < 2^20)

// A key's hash: keys are the smallest Fibonacci hashes, so their bits are
// mixed again. Its low bits pick the home bucket, its high bits the filter
// bit.
__device__ __forceinline__ uint32_t mix(uint32_t k) {
  k ^= k >> 16;
  k *= 0x7FEB352Du;
  k ^= k >> 15;
  k *= 0x846CA68Bu;
  k ^= k >> 16;
  return k;
}

// The filter: 2^(tbits + 5) bits, bit h >> (27 − tbits) of a key of hash h.
struct Filter {
  uint32_t* words;
  int shift;  // 27 − tbits
  __device__ __forceinline__ int word(uint32_t h) const { return static_cast<int>(h >> (shift + 5)); }
  __device__ __forceinline__ uint32_t bit(uint32_t h) const { return 1u << ((h >> shift) & 31u); }
};

// Adds one occurrence of `key` in query row `row` (of the pass).
__device__ __forceinline__ void insert(unsigned long long* ent, int bmask, Filter f, uint32_t key,
                                       int row) {
  const unsigned long long e =
      (static_cast<unsigned long long>((static_cast<uint32_t>(row) << kRowShift) | 1u) << 32) | key;
  const uint32_t h = mix(key);
  atomicOr(f.words + f.word(h), f.bit(h));
  for (int bk = static_cast<int>(h) & bmask;; bk = (bk + 1) & bmask) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      unsigned long long* p = ent + 2 * bk + t;
      const unsigned long long old = atomicCAS(p, 0ull, e);
      if (old == 0ull) return;
      if (static_cast<uint32_t>(old) == key && (old >> (32 + kRowShift)) == static_cast<uint32_t>(row)) {
        atomicAdd(p, 1ull << 32);
        return;
      }
    }
  }
}

// A lane's running count of matches in one query row, spilled to the tile
// column when the row changes.
struct Tally {
  int row = -1, count = 0;
};

__device__ __forceinline__ void tally(Tally& t, unsigned long long e, int* col, int tile) {
  const uint32_t pay = static_cast<uint32_t>(e >> 32);
  const int row = static_cast<int>(pay >> kRowShift), cnt = static_cast<int>(pay & ((1u << kRowShift) - 1));
  if (row != t.row) {
    if (t.count) atomicAdd(col + t.row * tile, t.count);
    t.row = row;
    t.count = 0;
  }
  t.count += cnt;
}

// Walks the chain of `key` from bucket bk; a bucket whose second entry is
// empty ends it (inserts fill a bucket's first entry first).
__device__ __forceinline__ void lookup(const ulonglong2* tab, int bmask, uint32_t key, int bk,
                                       Tally& t, int* col, int tile) {
  for (;; bk = (bk + 1) & bmask) {
    const ulonglong2 e = tab[bk];
    if ((e.x >> 32) != 0 && static_cast<uint32_t>(e.x) == key) tally(t, e.x, col, tile);
    if ((e.y >> 32) != 0 && static_cast<uint32_t>(e.y) == key) tally(t, e.y, col, tile);
    if ((e.y >> 32) == 0) return;
  }
}

// A lane's eight slots of a candidate: j0 + 0..3 and j0 + 128 + 0..3, with
// j0 = 256·item + 4·lane (zero masks past n).
struct Item {
  int4 k[2];
  float4 m[2];
};

// Probes a lane's eight slots: their filter words first, all eight loads
// in flight, then the table for the keys whose bit is set.
__device__ __forceinline__ void probe(const ulonglong2* tab, int bmask, Filter f, const Item& x,
                                      Tally& t, int* col, int tile) {
  const uint32_t key[8] = {
      static_cast<uint32_t>(x.k[0].x), static_cast<uint32_t>(x.k[0].y),
      static_cast<uint32_t>(x.k[0].z), static_cast<uint32_t>(x.k[0].w),
      static_cast<uint32_t>(x.k[1].x), static_cast<uint32_t>(x.k[1].y),
      static_cast<uint32_t>(x.k[1].z), static_cast<uint32_t>(x.k[1].w)};
  const bool ok[8] = {x.m[0].x > 0.f, x.m[0].y > 0.f, x.m[0].z > 0.f, x.m[0].w > 0.f,
                      x.m[1].x > 0.f, x.m[1].y > 0.f, x.m[1].z > 0.f, x.m[1].w > 0.f};
  uint32_t h[8], word[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    h[s] = mix(key[s]);
    word[s] = ok[s] ? f.words[f.word(h[s])] : 0u;
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (word[s] & f.bit(h[s])) lookup(tab, bmask, key[s], static_cast<int>(h[s]) & bmask, t, col, tile);
  }
}

__device__ __forceinline__ Item load_item(const int32_t* c_kh, const float* c_mask, size_t cbase,
                                          int n, int j0, bool vec) {
  Item x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + 128 * h;
    x.k[h] = make_int4(0, 0, 0, 0);
    x.m[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec) {  // n % 4 == 0 and 16-byte aligned planes
      if (j < n) {
        x.k[h] = *reinterpret_cast<const int4*>(c_kh + cbase + j);
        x.m[h] = *reinterpret_cast<const float4*>(c_mask + cbase + j);
      }
    } else {
      int kk[4] = {0, 0, 0, 0};
      float mm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j + u < n) {
          kk[u] = c_kh[cbase + j + u];
          mm[u] = c_mask[cbase + j + u];
        }
      }
      x.k[h] = make_int4(kk[0], kk[1], kk[2], kk[3]);
      x.m[h] = make_float4(mm[0], mm[1], mm[2], mm[3]);
    }
  }
  return x;
}

// The warp's place in the block's walk: tile `tile`, candidate `cl` of
// the tile, item `it` of the candidate (256 slots an item).
struct Cursor {
  int tile, cl, it;
};

__device__ __forceinline__ int tile_len(int t, int C, int tile) { return min(tile, C - t * tile); }

__device__ __forceinline__ Cursor next_cursor(Cursor c, int items, int ntiles, int C, int tile,
                                              int warp) {
  if (++c.it < items) return c;
  c.it = 0;
  c.cl += kWarps;
  if (c.cl < tile_len(c.tile, C, tile)) return c;
  c.cl = warp;
  c.tile += gridDim.x;
  if (c.tile < ntiles && c.cl >= tile_len(c.tile, C, tile)) c.tile = ntiles;  // a short last tile
  return c;
}

__global__ void __launch_bounds__(kThreads, 1)  // one block an SM
containment_kernel(const int32_t* __restrict__ q_kh, const float* __restrict__ q_mask,
                   const int32_t* __restrict__ c_kh, const float* __restrict__ c_mask,
                   int B, int nq, int C, int n, int rows, int tbits, int tile, int vec,
                   float* __restrict__ hits) {
  // [2^(tbits-1)] buckets of two entries (payload << 32 | key; 0 = empty),
  // the filter's 2^tbits words, then int counts[rows][tile]
  extern __shared__ ulonglong2 tab[];
  const int NB = 1 << (tbits - 1), bmask = NB - 1;
  const Filter filt{reinterpret_cast<uint32_t*>(tab + NB), 27 - tbits};
  int* counts = reinterpret_cast<int*>(filt.words + (1 << tbits));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * rows, nrows = min(rows, B - row0);
  const int ntiles = (C + tile - 1) / tile;
  const int items = (n + 255) / 256;

  // the first item of this warp's walk, in flight during the build
  Cursor cur{static_cast<int>(blockIdx.x), warp, 0};
  if (cur.cl >= tile_len(cur.tile, C, tile)) cur.tile = ntiles;
  Item x{};
  if (cur.tile < ntiles)
    x = load_item(c_kh, c_mask, static_cast<size_t>(cur.tile * tile + cur.cl) * n, n,
                  4 * lane, vec);

  unsigned long long* ent = reinterpret_cast<unsigned long long*>(tab);
  for (int p = threadIdx.x; p < NB; p += kThreads) tab[p] = make_ulonglong2(0ull, 0ull);
  for (int p = threadIdx.x; p < (1 << tbits); p += kThreads) filt.words[p] = 0u;
  for (int p = threadIdx.x; p < rows * tile; p += kThreads) counts[p] = 0;
  __syncthreads();
  const size_t qbase = static_cast<size_t>(row0) * nq;
  for (int t = threadIdx.x; t < nrows * nq; t += kThreads) {
    if (q_mask[qbase + t] > 0.f) insert(ent, bmask, filt, static_cast<uint32_t>(q_kh[qbase + t]), t / nq);
  }
  __syncthreads();

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    Tally tl;
    while (cur.tile == t) {
      const Cursor nc = next_cursor(cur, items, ntiles, C, tile, warp);
      Item y{};
      if (nc.tile < ntiles)
        y = load_item(c_kh, c_mask, static_cast<size_t>(nc.tile * tile + nc.cl) * n, n,
                      256 * nc.it + 4 * lane, vec);
      int* col = counts + cur.cl;
      probe(tab, bmask, filt, x, tl, col, tile);
      if (cur.it == items - 1) {  // the candidate's end: spill every lane's tally
        const unsigned held = __ballot_sync(kFull, tl.count > 0);
        if (held) {
          const int r0 = __shfl_sync(kFull, tl.row, __ffs(held) - 1);
          if (__all_sync(kFull, tl.count == 0 || tl.row == r0)) {
            const int sum = __reduce_add_sync(kFull, tl.count);
            if (lane == 0) atomicAdd(col + r0 * tile, sum);
          } else if (tl.count) {
            atomicAdd(col + tl.row * tile, tl.count);
          }
        }
        tl = Tally{};
      }
      cur = nc;
      x = y;
    }
    __syncthreads();
    // the tile's counts, row by row, coalesced over c; then cleared
    const int c0 = t * tile, len = tile_len(t, C, tile);
    for (int p = threadIdx.x; p < nrows * len; p += kThreads) {
      const int r = p / len, cl = p - r * len;
      hits[static_cast<size_t>(row0 + r) * C + c0 + cl] = static_cast<float>(counts[r * tile + cl]);
      counts[r * tile + cl] = 0;
    }
    __syncthreads();
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Launches on `stream` with the plan of `repro_torch.kernels.containment.
// plan`: `rows` query rows a pass and `passes` of them (grid.y), a table of
// 2^tbits entries and a filter of 2^(tbits+5) bits, `tile` candidates a
// tile, `grid_x` persistent blocks a pass and `smem` bytes of shared memory
// a block. The kernel opts in to the card's most shared memory once a
// device. Returns cudaGetLastError() after the launch.
extern "C" int containment_hits_launch(const void* q_kh, const void* q_mask, const void* c_kh,
                                       const void* c_mask, int B, int nq, int C, int n, int rows,
                                       int passes, int tbits, int tile, int grid_x, int smem,
                                       void* hits, void* stream) {
  constexpr int kSmemMax = 232448;  // an H100 block's opt-in limit
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024 && !opted[dev]) {
    err = cudaFuncSetAttribute(containment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  const int vec = n % 4 == 0 && aligned16(c_kh) && aligned16(c_mask);
  containment_kernel<<<dim3(grid_x, passes), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q_kh), static_cast<const float*>(q_mask),
      static_cast<const int32_t*>(c_kh), static_cast<const float*>(c_mask), B, nq, C, n, rows,
      tbits, tile, vec, static_cast<float*>(hits));
  return static_cast<int>(cudaGetLastError());
}
