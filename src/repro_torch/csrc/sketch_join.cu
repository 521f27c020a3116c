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
// lookup work is small beside that.
//
// Design: a block is one candidate and up to 8 queries, one warp a query,
// so the scan's chunk (B = 32 queries × 128 candidates) is 512 blocks of 8
// warps; a block has 8 warps for fewer queries too (the one- and 8-query
// buckets' 512-candidate chunks: 512 blocks), as all its warps build the
// candidate's table. The block's threads
// load the candidate's slots and insert its valid keys into a hash table in
// shared memory: buckets of two 64-bit entries (slot index, key), 2 or 4
// entries for each candidate slot, placed by atomicCAS (linear probing over
// buckets), so nearly every lookup is one 16-byte shared load. After one
// barrier each warp looks its query's slots up, four probe chains of a lane
// at a time (16-byte loads of the query row, the next 128 slots in flight
// while one 128 are looked up), writes aligned/hit with 16-byte stores, and
// sums its six moments over the lanes by a fixed shuffle tree: no float
// atomics, and a moments-only launch adds the same numbers in the same
// order as a full one. Equal valid keys of a candidate all match, so
// duplicates sum as in the Pallas kernel's equality formulation; where a
// key has more than two, their values are added in slot order, so the sum
// does not depend on where the racing inserts put them (two add the same
// either way). Key planes arrive as int32 bit patterns and are compared for
// equality only.
#include "common.cuh"

namespace {

constexpr int kQueryWarps = 8;  // queries (warps) of a block at most
constexpr int kLoads = 8;       // candidate slots a thread loads at once
constexpr unsigned long long kEmpty = ~0ull;

// home bucket of a key; a sketch holds the keys of smallest Fibonacci hash,
// so the key's bits are mixed again before they pick a bucket
__device__ __forceinline__ int home(uint32_t k, int bmask) {
  k ^= k >> 16;
  k *= 0x7FEB352Du;
  k ^= k >> 15;
  k *= 0x846CA68Bu;
  k ^= k >> 16;
  return static_cast<int>(k) & bmask;
}

__device__ __forceinline__ bool same_key(unsigned long long e, int key) {
  return static_cast<uint32_t>(e) == static_cast<uint32_t>(key);
}

// The values of `count` (> 2) entries of `key`, added in slot order.
__device__ __forceinline__ float ordered_sum(const ulonglong2* tab, const float* svals, int bmask,
                                             int key, int count) {
  float al = 0.f;
  int last = -1;
  for (int t = 0; t < count; ++t) {
    int next = 0x7fffffff;
    for (int bk = home(static_cast<uint32_t>(key), bmask);; bk = (bk + 1) & bmask) {
      const ulonglong2 e = tab[bk];
      const int j0 = static_cast<int>(e.x >> 32), j1 = static_cast<int>(e.y >> 32);
      if (e.x != kEmpty && same_key(e.x, key) && j0 > last && j0 < next) next = j0;
      if (e.y != kEmpty && same_key(e.y, key) && j1 > last && j1 < next) next = j1;
      if (e.y == kEmpty) break;
    }
    al += svals[next];
    last = next;
  }
  return al;
}

// For four query slots: the sum of the values whose key equals key[i]
// (al) and whether there is one (h); the four probe chains advance
// together. A bucket whose second entry is empty ends a chain (inserts
// fill a bucket's first entry first).
__device__ __forceinline__ void lookup4(const ulonglong2* tab, const float* svals, int bmask,
                                        const int4 key4, const float4 mask4, float (&al)[4],
                                        float (&h)[4]) {
  const int key[4] = {key4.x, key4.y, key4.z, key4.w};
  int bk[4], count[4];
  bool act[4] = {mask4.x > 0.f, mask4.y > 0.f, mask4.z > 0.f, mask4.w > 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    al[i] = 0.f;
    count[i] = 0;
    bk[i] = home(static_cast<uint32_t>(key[i]), bmask);
  }
  while (act[0] || act[1] || act[2] || act[3]) {
    ulonglong2 e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = act[i] ? tab[bk[i]] : make_ulonglong2(kEmpty, kEmpty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!act[i]) continue;
      if (e[i].x != kEmpty && same_key(e[i].x, key[i])) {
        al[i] += svals[e[i].x >> 32];
        ++count[i];
      }
      if (e[i].y != kEmpty && same_key(e[i].y, key[i])) {
        al[i] += svals[e[i].y >> 32];
        ++count[i];
      }
      act[i] = e[i].y != kEmpty;
      bk[i] = (bk[i] + 1) & bmask;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (count[i] > 2) al[i] = ordered_sum(tab, svals, bmask, key[i], count[i]);
    h[i] = count[i] > 0 ? 1.f : 0.f;
  }
}

__device__ __forceinline__ void accumulate(float (&s)[6], float qv, float al, float h) {
  const float a = qv * h;
  s[0] += h;
  s[1] += a;
  s[2] += al;
  s[3] += a * a;
  s[4] += al * al;
  s[5] += a * al;
}

// Four slots of a query row from slot i (zeros past nq).
struct Quad {
  int4 k;
  float4 v, m;
};

__device__ __forceinline__ Quad load_quad(const int32_t* q_kh, const float* q_val,
                                          const float* q_mask, size_t base, int i, int nq) {
  Quad x{make_int4(0, 0, 0, 0), make_float4(0.f, 0.f, 0.f, 0.f),
         make_float4(0.f, 0.f, 0.f, 0.f)};
  if (i < nq) {
    x.k = *reinterpret_cast<const int4*>(q_kh + base + i);
    x.v = *reinterpret_cast<const float4*>(q_val + base + i);
    x.m = *reinterpret_cast<const float4*>(q_mask + base + i);
  }
  return x;
}

__global__ void __launch_bounds__(kQueryWarps * 32, 4)
sketch_join_kernel(const int32_t* __restrict__ q_kh, const float* __restrict__ q_val,
                   const float* __restrict__ q_mask, const int32_t* __restrict__ c_kh,
                   const float* __restrict__ c_val, const float* __restrict__ c_mask,
                   int B, int nq, int C, int n, int bbits, int vec, float* __restrict__ mom,
                   float* __restrict__ aligned, float* __restrict__ hit) {
  // [2^bbits] buckets of two entries (slot index << 32 | key; ~0 = empty),
  // then float svals[n]
  extern __shared__ ulonglong2 tab[];
  const int NB = 1 << bbits, bmask = NB - 1;
  float* svals = reinterpret_cast<float*>(tab + NB);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const size_t cbase = static_cast<size_t>(c) * n;
  const int b = blockIdx.y * (blockDim.x >> 5) + warp;
  const size_t qbase = static_cast<size_t>(b) * nq;

  // this warp's first four slots a lane, in flight during the build
  Quad cur{};
  if (vec && b < B) cur = load_quad(q_kh, q_val, q_mask, qbase, 4 * lane, nq);

  unsigned long long* ent = reinterpret_cast<unsigned long long*>(tab);
  for (int j0 = 0; j0 == 0 || j0 < n; j0 += kLoads * blockDim.x) {
    // every load of the round issued before the first store
    int key[kLoads];
    float val[kLoads];
    bool ok[kLoads];
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int j = j0 + r * blockDim.x + threadIdx.x;
      key[r] = 0;
      val[r] = 0.f;
      ok[r] = false;
      if (j < n) {
        key[r] = c_kh[cbase + j];
        val[r] = c_val[cbase + j];
        ok[r] = c_mask[cbase + j] > 0.f;
      }
    }
    if (j0 == 0) {
      for (int p = threadIdx.x; p < NB; p += blockDim.x) tab[p] = make_ulonglong2(kEmpty, kEmpty);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int j = j0 + r * blockDim.x + threadIdx.x;
      if (j < n) svals[j] = val[r];
      if (!ok[r]) continue;
      const unsigned long long e =
          (static_cast<unsigned long long>(j) << 32) | static_cast<uint32_t>(key[r]);
      for (int bk = home(static_cast<uint32_t>(key[r]), bmask);; bk = (bk + 1) & bmask) {
        if (atomicCAS(ent + 2 * bk, kEmpty, e) == kEmpty) break;
        if (atomicCAS(ent + 2 * bk + 1, kEmpty, e) == kEmpty) break;
      }
    }
  }
  __syncthreads();

  if (b >= B) return;
  const size_t obase = (static_cast<size_t>(b) * C + c) * nq;
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (vec) {  // nq % 4 == 0 and 16-byte aligned rows: four slots a lane
    for (int i = 4 * lane; i < nq; i += 128) {
      const Quad next = load_quad(q_kh, q_val, q_mask, qbase, i + 128, nq);
      float al[4], h[4];
      lookup4(tab, svals, bmask, cur.k, cur.m, al, h);
      accumulate(s, cur.v.x, al[0], h[0]);
      accumulate(s, cur.v.y, al[1], h[1]);
      accumulate(s, cur.v.z, al[2], h[2]);
      accumulate(s, cur.v.w, al[3], h[3]);
      if (aligned != nullptr) {
        *reinterpret_cast<float4*>(aligned + obase + i) = make_float4(al[0], al[1], al[2], al[3]);
        *reinterpret_cast<float4*>(hit + obase + i) = make_float4(h[0], h[1], h[2], h[3]);
      }
      cur = next;
    }
  } else {
    for (int i = lane; i < nq; i += 32) {
      const int4 k4 = make_int4(q_kh[qbase + i], 0, 0, 0);
      const float4 m4 = make_float4(q_mask[qbase + i], 0.f, 0.f, 0.f);
      float al[4], h[4];
      lookup4(tab, svals, bmask, k4, m4, al, h);
      accumulate(s, q_val[qbase + i], al[0], h[0]);
      if (aligned != nullptr) {
        aligned[obase + i] = al[0];
        hit[obase + i] = h[0];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) s[k] = repro::warp_sum(s[k]);
  if (lane == 0) {
    float* out = mom + (static_cast<size_t>(b) * C + c) * 6;
#pragma unroll
    for (int k = 0; k < 6; ++k) out[k] = s[k];
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Launches on `stream`; aligned and hit may both be null (moments only).
// Returns cudaGetLastError() after the launch.
extern "C" int sketch_join_moments_launch(const void* q_kh, const void* q_val,
                                          const void* q_mask, const void* c_kh,
                                          const void* c_val, const void* c_mask,
                                          int B, int nq, int C, int n, void* mom,
                                          void* aligned, void* hit, void* stream) {
  // buckets of two entries: 4 entries a slot of next_pow2(n) up to 1024, 2
  // beyond (48 KB of shared memory at most)
  const int np2 = repro::next_pow2(n);
  int bbits = 4;
  while ((1 << bbits) < (np2 <= 1024 ? 2 * np2 : np2)) ++bbits;
  const size_t smem = (sizeof(ulonglong2) << bbits) + sizeof(float) * static_cast<size_t>(n);
  // the same path with and without aligned/hit, so both add in one order
  const int vec = nq % 4 == 0 && aligned16(q_kh) && aligned16(q_val) && aligned16(q_mask);
  if (vec && aligned != nullptr && !(aligned16(aligned) && aligned16(hit)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  // eight warps a block whatever B: warps past the last query still share
  // the table's build
  const dim3 grid(C, (B + kQueryWarps - 1) / kQueryWarps);
  sketch_join_kernel<<<grid, kQueryWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q_kh), static_cast<const float*>(q_val),
      static_cast<const float*>(q_mask), static_cast<const int32_t*>(c_kh),
      static_cast<const float*>(c_val), static_cast<const float*>(c_mask), B, nq, C, n, bbits,
      vec, static_cast<float*>(mom), static_cast<float*>(aligned), static_cast<float*>(hit));
  return static_cast<int>(cudaGetLastError());
}
