// Causal / sliding-window GQA attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention. q [B, Hq, Lq, D], k and v [B, Hkv, Lk, D] → o in q's
// layout: query head h reads KV head h / (Hq / Hkv), logits scale 1/sqrt(D),
// positions right-aligned (query i sits at Lk - Lq + i), so `causal` keeps
// keys at or before it and `window > 0` the last `window` of those. A row
// with no key left gives 0 (the Pallas kernel's guarded division).
//
// What bounds it on an H100: at prefill, operations — 4·D multiply-adds a
// (query, key) pair, half the pairs under the causal mask; at decode
// (Lq = 1 over a long cache), bytes — every K and V element read once.
//
// Two kernels; the caller's split count picks one (kernels/flash_attention.py
// asks for splits when a (batch, KV head) has at most kDecRows query rows).
//
// flash_fwd, for many rows (simple and right first; tensor cores, TMA and
// warp specialisation are later work):
//  - one block of 256 threads per (batch, KV head, 64-row tile), where a
//    row is a (query position, query head of the group) pair: the group's
//    query heads share every K/V tile the block stages;
//  - a loop over 64-key tiles: K (transposed) and V staged through shared
//    memory in f32, whatever their storage type (bf16 → f32 is exact), the
//    loop bounded to the keys the causal and window masks leave to the
//    tile's rows, and the ragged tails (any Lq, any Lk) masked;
//  - each thread owns 4 rows × 4 keys of the logits and 4 rows × D/16
//    dims of the accumulator, all f32 in registers, with the online
//    softmax (running max, sum and accumulator) reduced across the 16
//    threads of a row by shuffles; P goes through shared memory (over the
//    K tile) into the P·V product;
//  - strided [B, H, L, D] views with a contiguous last dimension, so the
//    caller's [B, L, H, D] projections need no transposed copy.
//
// flash_fwd_split, for few rows (decode: Lq = 1, a group of 8 heads), where
// flash_fwd's grid is B·Hkv blocks that each walk the whole cache:
//  - the visible keys are cut into `splits` runs of `split_keys` (a multiple
//    of the 64-key tile); the grid is (split, KV head, batch), so a decode
//    step over a 2048-key cache with B·Hkv = 16 is 512 blocks, not 16;
//  - a block of 128 threads stages each K and V tile raw (bf16 or f32) in
//    shared memory with 16-byte loads (Q's and the first tile's loads
//    issued together, the next tile's in flight while one is computed) and
//    widens to f32 when it reads; two threads a key compute the logits of
//    half the rows each, so only the R = Lq·group live rows cost work; the
//    P·V product gives each thread a 4-dim quad of a row;
//  - each split writes its partial (running max, sum, f32 accumulator) to
//    the caller's workspace; the last block of a (batch, KV head) — a
//    done-counter after __threadfence, which that block sets back to 0,
//    so no call needs a memset — combines the partials in split order, so
//    the result does not depend on which block finishes last.
// Products are explicit fmaf: the library is built with -fmad=false, which
// bars only the compiler's own contraction of a multiply and an add.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kRows = 64;      // query rows of a block
constexpr int kKeys = 64;      // keys of a tile
constexpr int kThreads = 256;  // 16 row groups × 16 column groups
constexpr int kPad = 4;        // floats after each shared row (keeps 16 B alignment)
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, l;  // elements; the last dimension is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr int smem_floats() {
  return D * (kRows + kPad)                             // Q, transposed
         + (D > kKeys ? D : kKeys) * (kKeys + kPad)     // K transposed, then P transposed
         + kKeys * (D + kPad);                          // V
}

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
          TQ* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int group, int Lq,
          int Lk, int causal, int window, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int DPT = D / 16;  // accumulator dims of a thread
  constexpr int QS = kRows + kPad, KS = kKeys + kPad, VS = D + kPad;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);      // [D][QS]
  float* Kt = Qt + D * QS;                          // [D][KS]; P as [kKeys][QS]
  float* Pt = Kt;
  float* Vs = Kt + (D > kKeys ? D : kKeys) * KS;    // [kKeys][VS]

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int R = Lq * group, row0 = blockIdx.x * kRows;
  const int off = Lk - Lq;

  // the Q tile, transposed: rows are (position, head of the group) pairs
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, rho = row0 + r;
    float x = 0.f;
    if (rho < R) {
      const int i = rho / group, h = hkv * group + rho % group;
      x = to_f32(q[b * sq.b + h * sq.h + i * sq.l + d]);
    }
    Qt[d * QS + r] = x;
  }

  // the keys any row of the tile may see
  const int last = (row0 + kRows < R ? row0 + kRows : R) - 1;
  const int qpos_lo = row0 / group + off, qpos_hi = last / group + off;
  int kbeg = 0, kend = Lk;
  if (causal && qpos_hi + 1 < kend) kend = qpos_hi + 1;
  if (window > 0 && qpos_lo - window + 1 > kbeg) kbeg = qpos_lo - window + 1;

  // this thread's rows and their positions
  int qpos[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rho = row0 + rg * 4 + i;
    live[i] = rho < R;
    qpos[i] = rho / group + off;
  }
  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const TKV* kb = k + b * sk.b + hkv * sk.h;
  const TKV* vb = v + b * sv.b + hkv * sv.h;
  for (int k0 = kbeg; k0 < kend; k0 += kKeys) {
    __syncthreads();  // the previous tile's P and V are read; Q is written
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int c = idx / D, d = idx % D, kp = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kp < Lk) {
        kx = to_f32(kb[kp * sk.l + d]);
        vx = to_f32(vb[kp * sv.l + d]);
      }
      Kt[d * KS + c] = kx;
      Vs[c * VS + d] = vx;
    }
    __syncthreads();

    // logits of 4 rows × 4 keys
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * QS + rg * 4);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + d * KS + cg * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w}, kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // masks, then the online softmax over the 16 threads of each row
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool keep[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg * 4 + j;
        keep[j] = live[i] && kp < kend && (!causal || kp <= qpos[i]) &&
                  (window <= 0 || kp > qpos[i] - window);
        s[i][j] = keep[j] ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float mnew = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = keep[j] ? __expf(s[i][j] - mnew) : 0.f;
        rs += p[i][j];
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      const float alpha = __expf(m[i] - mnew);
      l[i] = l[i] * alpha + rs;
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done with the K tile: P goes over it
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (cg * 4 + j) * QS + rg * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc += P · V: 4 rows × DPT dims of this thread
#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + c * QS + rg * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float* vr = Vs + c * VS + cg * DPT;
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vr[j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int rho = row0 + rg * 4 + i;
    const int pos = rho / group, h = hkv * group + rho % group;
    TQ* out = o + b * so.b + h * so.h + pos * so.l + cg * DPT;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) store(out + j, acc[i][j] * inv);
  }
}

// ---------------------------------------------------------------------------
// the split-key path
// ---------------------------------------------------------------------------

constexpr int kDecRows = 16;                // query rows of a (batch, KV head) at most
constexpr int kDecKeys = 64;                // keys of a tile
constexpr int kDecThreads = 2 * kDecKeys;   // two threads a key in the logits

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// 16 bytes of a staged row → f32
__device__ __forceinline__ void widen16(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  x[0] = bf_lo(u.x);
  x[1] = bf_hi(u.x);
  x[2] = bf_lo(u.y);
  x[3] = bf_hi(u.y);
  x[4] = bf_lo(u.z);
  x[5] = bf_hi(u.z);
  x[6] = bf_lo(u.w);
  x[7] = bf_hi(u.w);
}
// four elements of a staged row → f32
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}

template <int D, typename TKV>
__host__ __device__ constexpr int row_bytes() {  // a staged K or V row; 16 more bytes keep rows off one bank
  return D * static_cast<int>(sizeof(TKV)) + 16;
}

template <int D, typename TKV>
__host__ __device__ constexpr int split_smem_bytes() {
  return 2 * kDecKeys * row_bytes<D, TKV>()                                // K, V
         + static_cast<int>(sizeof(float)) * (kDecRows * D                 // Q
                                              + kDecRows * (kDecKeys + 4)  // P
                                              + 3 * kDecRows);             // tile maxima, running max
}

// One 64-key tile of K and V of a (batch, KV head): with `vec`, 16-byte
// loads into registers (load), then into shared memory raw (store), so the
// next tile's loads are in flight while a tile is computed; without, the
// store copies element by element. Keys past kend are 0.
template <int D, typename TKV>
struct TileLoader {
  static constexpr int VEC = 16 / sizeof(TKV), VPR = D / VEC, RSB = row_bytes<D, TKV>();
  static constexpr int TOTAL = kDecKeys * VPR, N = (TOTAL + kDecThreads - 1) / kDecThreads;
  uint4 ku[N], vu[N];

  __device__ __forceinline__ void load(const TKV* kb, const TKV* vb, long long kld,
                                       long long vld, int k0, int kend, int vec) {
    if (!vec) return;
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int e = threadIdx.x + it * kDecThreads, c = e / VPR, x = e - c * VPR, kp = k0 + c;
      ku[it] = vu[it] = make_uint4(0u, 0u, 0u, 0u);
      if (e < TOTAL && kp < kend) {
        ku[it] = *reinterpret_cast<const uint4*>(kb + kp * kld + x * VEC);
        vu[it] = *reinterpret_cast<const uint4*>(vb + kp * vld + x * VEC);
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* Ks, unsigned char* Vs, const TKV* kb,
                                        const TKV* vb, long long kld, long long vld, int k0,
                                        int kend, int vec) const {
    if (vec) {
#pragma unroll
      for (int it = 0; it < N; ++it) {
        const int e = threadIdx.x + it * kDecThreads, c = e / VPR, x = e - c * VPR;
        if (e < TOTAL) {
          *reinterpret_cast<uint4*>(Ks + c * RSB + x * 16) = ku[it];
          *reinterpret_cast<uint4*>(Vs + c * RSB + x * 16) = vu[it];
        }
      }
      return;
    }
    for (int e = threadIdx.x; e < kDecKeys * D; e += kDecThreads) {
      const int c = e / D, d = e - c * D, kp = k0 + c;
      TKV* krow = reinterpret_cast<TKV*>(Ks + c * RSB);
      TKV* vrow = reinterpret_cast<TKV*>(Vs + c * RSB);
      if (kp < kend) {
        krow[d] = kb[kp * kld + d];
        vrow[d] = vb[kp * vld + d];
      } else {
        ::store(krow + d, 0.f);
        ::store(vrow + d, 0.f);
      }
    }
  }
};

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(kDecThreads)
flash_fwd_split(const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
                TQ* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int group,
                int Lq, int Lk, int causal, int window, float scale, int key0, int split_keys,
                int vec, int* __restrict__ done, float* __restrict__ part) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int VEC = 16 / sizeof(TKV), VPR = D / VEC, RSB = row_bytes<D, TKV>();
  constexpr int RH = kDecRows / 2;               // logits rows of a thread
  constexpr int DQ = D / 4, RG = kDecThreads / DQ;  // P·V: dim quads of a row, row groups
  constexpr int RPT = (kDecRows + RG - 1) / RG;  // P·V rows of a thread
  constexpr int PS = kDecKeys + 4;               // floats of a P row
  extern __shared__ float4 smem4[];
  unsigned char* Ks = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* Vs = Ks + kDecKeys * RSB;
  float* Qs = reinterpret_cast<float*>(Vs + kDecKeys * RSB);  // [kDecRows][D]
  float* Ps = Qs + kDecRows * D;                              // [kDecRows][PS]
  float* Mx = Ps + kDecRows * PS;   // [2][kDecRows]: the tile's maxima over keys 0-31, 32-63
  float* Ms = Mx + 2 * kDecRows;    // [kDecRows]: the running maxima
  __shared__ int last_block;

  const int tid = threadIdx.x, lane = tid & 31;
  const int split = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x, Hkv = gridDim.y;
  const int R = Lq * group, off = Lk - Lq;
  const int kbeg = key0 + split * split_keys;
  const int kend = min(Lk, kbeg + split_keys);

  // Q and the first K/V tile in flight together
  constexpr int QPT = kDecRows * D / kDecThreads;
  float qval[QPT];
#pragma unroll
  for (int it = 0; it < QPT; ++it) {
    const int idx = tid + it * kDecThreads, r = idx / D, d = idx - r * D;
    qval[it] = 0.f;
    if (r < R) {
      const int i = r / group, h = hkv * group + r % group;
      qval[it] = to_f32(q[b * sq.b + h * sq.h + i * sq.l + d]);
    }
  }
  const TKV* kb = k + b * sk.b + hkv * sk.h;
  const TKV* vb = v + b * sv.b + hkv * sv.h;
  TileLoader<D, TKV> tile;
  if (kbeg < kend) tile.load(kb, vb, sk.l, sv.l, kbeg, kend, vec);
#pragma unroll
  for (int it = 0; it < QPT; ++it) Qs[tid + it * kDecThreads] = qval[it];
  if (tid < kDecRows) Ms[tid] = kNegInf;

  // logits: key c, rows half, half + 2, ...; P·V: dims 4·dq.., rows rg, rg + RG, ...
  const int c = tid % kDecKeys, half = tid / kDecKeys;
  const int dq = tid % DQ, rg = tid / DQ;
  const bool pv = rg < RG;
  float l[RPT];
  float4 acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    l[j] = 0.f;
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = kbeg; k0 < kend; k0 += kDecKeys) {
    __syncthreads();  // the previous tile's K, V and P are read; Q and Ms are written
    tile.store(Ks, Vs, kb, vb, sk.l, sv.l, k0, kend, vec);
    __syncthreads();
    if (k0 + kDecKeys < kend) tile.load(kb, vb, sk.l, sv.l, k0 + kDecKeys, kend, vec);

    float s[RH];
#pragma unroll
    for (int j = 0; j < RH; ++j) s[j] = 0.f;
    const unsigned char* krow = Ks + c * RSB;
#pragma unroll 2
    for (int x = 0; x < VPR; ++x) {
      float kf[VEC];
      widen16(reinterpret_cast<const TKV*>(krow + x * 16), kf);
#pragma unroll
      for (int j = 0; j < RH; ++j) {
        const int r = half + 2 * j;
        if (r < R) {
          const float* qr = Qs + r * D + x * VEC;
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qa = *reinterpret_cast<const float4*>(qr + e);
            s[j] = fmaf(qa.x, kf[e], s[j]);
            s[j] = fmaf(qa.y, kf[e + 1], s[j]);
            s[j] = fmaf(qa.z, kf[e + 2], s[j]);
            s[j] = fmaf(qa.w, kf[e + 3], s[j]);
          }
        }
      }
    }
    const int kp = k0 + c;
    unsigned keep = 0;
#pragma unroll
    for (int j = 0; j < RH; ++j) {
      const int r = half + 2 * j;
      if (r < R) {  // uniform over the warp
        const int qpos = r / group + off;
        const bool kj = kp < kend && (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window);
        s[j] = kj ? s[j] * scale : kNegInf;
        keep |= static_cast<unsigned>(kj) << j;
        float mt = s[j];
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
        if (lane == 0) Mx[(c >> 5) * kDecRows + r] = mt;
      }
    }
    __syncthreads();

    // P of this thread's logits rows, against the new running maxima
#pragma unroll
    for (int j = 0; j < RH; ++j) {
      const int r = half + 2 * j;
      if (r < R) {
        const float mn = fmaxf(Ms[r], fmaxf(Mx[r], Mx[kDecRows + r]));
        Ps[r * PS + c] = (keep >> j) & 1u ? __expf(s[j] - mn) : 0.f;
      }
    }
    float alpha[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = rg + RG * j;
      alpha[j] = 1.f;
      if (pv && r < R) {
        const float mo = Ms[r];
        alpha[j] = __expf(mo - fmaxf(mo, fmaxf(Mx[r], Mx[kDecRows + r])));
      }
    }
    __syncthreads();  // P is written; the old running maxima are read
    if (tid < R) Ms[tid] = fmaxf(Ms[tid], fmaxf(Mx[tid], Mx[kDecRows + tid]));

    if (pv) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        l[j] *= alpha[j];
        acc[j].x *= alpha[j];
        acc[j].y *= alpha[j];
        acc[j].z *= alpha[j];
        acc[j].w *= alpha[j];
      }
      const int nk = (min(kDecKeys, kend - k0) + 3) & ~3;
      for (int c0 = 0; c0 < nk; c0 += 4) {
        float4 vv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vv[e] = widen4(reinterpret_cast<const TKV*>(Vs + (c0 + e) * RSB) + 4 * dq);
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int r = rg + RG * j;
          if (r < R) {
            const float4 p = *reinterpret_cast<const float4*>(Ps + r * PS + c0);
            const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              l[j] += pe[e];
              acc[j].x = fmaf(pe[e], vv[e].x, acc[j].x);
              acc[j].y = fmaf(pe[e], vv[e].y, acc[j].y);
              acc[j].z = fmaf(pe[e], vv[e].z, acc[j].z);
              acc[j].w = fmaf(pe[e], vv[e].w, acc[j].w);
            }
          }
        }
      }
    }
  }
  __syncthreads();  // the running maxima are final

  // this split's partial: accumulators [B·Hkv][nsplit][R][D], then (max, sum) pairs
  const int bh = b * Hkv + hkv;
  const size_t rows = static_cast<size_t>(gridDim.z) * Hkv * nsplit * R;
  float* ml = part + rows * D;
  const size_t row0 = (static_cast<size_t>(bh) * nsplit + split) * R;
  if (pv) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = rg + RG * j;
      if (r < R) {
        *reinterpret_cast<float4*>(part + (row0 + r) * D + 4 * dq) = acc[j];
        if (dq == 0) *reinterpret_cast<float2*>(ml + (row0 + r) * 2) = make_float2(Ms[r], l[j]);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(done + bh, 1) == nsplit - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // the last block of (b, hkv): every split's partial, in split order
  if (pv) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = rg + RG * j;
      if (r >= R) continue;
      const size_t first = static_cast<size_t>(bh) * nsplit * R + r;
      float M = kNegInf, L = 0.f;
      float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int sp = 0; sp < nsplit; ++sp) {  // one pass, rescaled as the max grows
        const size_t row = first + static_cast<size_t>(sp) * R;
        const float2 pm = __ldcg(reinterpret_cast<const float2*>(ml + row * 2));
        const float4 pa = __ldcg(reinterpret_cast<const float4*>(part + row * D + 4 * dq));
        const float Mn = fmaxf(M, pm.x);
        const float a = __expf(M - Mn), w = __expf(pm.x - Mn);
        M = Mn;
        L = L * a + pm.y * w;
        O.x = O.x * a + pa.x * w;
        O.y = O.y * a + pa.y * w;
        O.z = O.z * a + pa.z * w;
        O.w = O.w * a + pa.w * w;
      }
      const float inv = 1.f / fmaxf(L, 1e-30f);
      const int i = r / group, h = hkv * group + r % group;
      TQ* out = o + b * so.b + h * so.h + i * so.l + 4 * dq;
      store(out, O.x * inv);
      store(out + 1, O.y * inv);
      store(out + 2, O.z * inv);
      store(out + 3, O.w * inv);
    }
  }
  if (tid == 0) done[bh] = 0;  // ready for the next launch on the stream
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

struct Split {
  int splits, split_keys, key0;  // splits = 0: flash_fwd
  int* done;
  float* part;
};

template <int D, typename TQ, typename TKV>
int launch_typed(const void* q, const void* k, const void* v, void* o, const long long* st,
                 int B, int Hq, int Hkv, int Lq, int Lk, int causal, int window, Split sp,
                 cudaStream_t stream) {
  const int group = Hq / Hkv;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  if (sp.splits > 0) {
    if (Lq * group > kDecRows || sp.split_keys % kDecKeys || sp.done == nullptr ||
        sp.part == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    auto kern = flash_fwd_split<D, TQ, TKV>;
    constexpr int bytes = split_smem_bytes<D, TKV>();
    if (bytes > 48 * 1024) {
      cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    bool vec = aligned16(k) && aligned16(v);
    for (int j = 3; j < 9; ++j) vec = vec && (st[j] * static_cast<long long>(sizeof(TKV))) % 16 == 0;
    const dim3 grid(sp.splits, Hkv, B);
    kern<<<grid, kDecThreads, bytes, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
        static_cast<TQ*>(o), sq, sk, sv, so, group, Lq, Lk, causal, window, scale, sp.key0,
        sp.split_keys, vec, sp.done, sp.part);
    return static_cast<int>(cudaGetLastError());
  }
  auto kern = flash_fwd<D, TQ, TKV>;
  const size_t bytes = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(Lq) * group;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), Hkv, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(o), sq, sk, sv, so, group, Lq, Lk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dim(int q_dtype, int kv_dtype, const void* q, const void* k, const void* v, void* o,
               const long long* st, int B, int Hq, int Hkv, int Lq, int Lk, int causal,
               int window, Split sp, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_typed<D, float, float>(q, k, v, o, st, B, Hq, Hkv, Lq, Lk, causal, window, sp, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_typed<D, float, bf16>(q, k, v, o, st, B, Hq, Hkv, Lq, Lk, causal, window, sp, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_typed<D, bf16, float>(q, k, v, o, st, B, Hq, Hkv, Lq, Lk, causal, window, sp, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_typed<D, bf16, bf16>(q, k, v, o, st, B, Hq, Hkv, Lq, Lk, causal, window, sp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: device pointers; strides: 12 element strides (batch, head,
// position) of q, k, v and o in that order, each last dimension
// contiguous; dtype codes 0 = float32, 1 = bfloat16 (o has q's); D one of
// 32, 64, 96, 128; Hq a multiple of Hkv. splits = 0 launches flash_fwd;
// splits > 0 (Lq · Hq / Hkv ≤ 16 rows) launches flash_fwd_split over the
// keys [key0, key0 + splits · split_keys) ∩ [0, Lk), split_keys a multiple
// of 64, with `done` B·Hkv ints that are 0 (and are 0 again when the kernel
// ends) and `part` B·Hkv·splits·(Lq·Hq/Hkv)·(D + 2) floats of workspace.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const long long* strides, int B, int Hq, int Hkv, int Lq,
                                      int Lk, int D, int causal, int window, int q_dtype,
                                      int kv_dtype, int splits, int split_keys, int key0,
                                      void* done, void* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp{splits, split_keys, key0, static_cast<int*>(done), static_cast<float*>(part)};
  switch (D) {
    case 32:
      return launch_dim<32>(q_dtype, kv_dtype, q, k, v, o, strides, B, Hq, Hkv, Lq, Lk, causal,
                            window, sp, s);
    case 64:
      return launch_dim<64>(q_dtype, kv_dtype, q, k, v, o, strides, B, Hq, Hkv, Lq, Lk, causal,
                            window, sp, s);
    case 96:
      return launch_dim<96>(q_dtype, kv_dtype, q, k, v, o, strides, B, Hq, Hkv, Lq, Lk, causal,
                            window, sp, s);
    case 128:
      return launch_dim<128>(q_dtype, kv_dtype, q, k, v, o, strides, B, Hq, Hkv, Lq, Lk, causal,
                             window, sp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
