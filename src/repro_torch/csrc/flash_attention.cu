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
// flash_fwd, for many rows: both products on the tensor cores, at float32
// accuracy. The path is float32 end to end, and one TF32 product (10
// mantissa bits) misses the float32 reference by ~2e-3, so every product
// is split TF32 ("3xTF32"): x = hi + lo with hi x rounded to TF32 and lo
// the remainder, and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, three
// mma.sync.m16n8k8 TF32 products accumulated in f32 (~1e-6 from a float64
// computation). A bf16 operand is a TF32 value, so its low part is 0 and
// its terms are skipped: one product a step in Q·Kᵀ when q and k/v are
// both bf16. Its bound is then the TF32 tensor rate over three times the
// products' operations. The design:
//  - one block of 8 warps per (batch, KV head, 128-row tile), where a row
//    is a (query position, query head of the group) pair, so one staged
//    K/V tile serves every query head of the group; a warp owns 16 rows;
//  - a flat grid that issues the row tiles last in the sequence first, so
//    the heaviest causal tiles start first and the light ones fill the tail;
//  - K and V in a two-stage ring of 64-key f32 tiles, the next tile's
//    16-byte cp.async copies in flight while one is computed (bf16 or
//    unaligned K/V are widened by the threads instead); K rows padded to
//    D + 16 floats and V rows to D + 4, so every fragment read is free of
//    bank conflicts; keys past Lk are zero-filled;
//  - Q's fragments in registers for the whole key loop, read as 16-byte
//    rows with the k index t ↔ dim 4t mapping (both operands permuted
//    alike), split as they are used; K's and V's split as they are read;
//  - the online softmax on the accumulator fragments: a row's max over the
//    4 lanes of a quad, ex2.approx with log2(e) folded into the scale, the
//    sum kept per lane until the end; masks only on the tiles that cut a row
//    (the diagonal, the window's edge, a ragged tail), and only the tiles
//    some row of the block sees are visited;
//  - P stays in registers between the products: its accumulator fragment
//    is the A fragment of P·V once the keys of a k-step are taken in the
//    order 2t, 2t + 1, which V's fragment reads follow.
// What holds it at the LM prefill shape is the rate of mma.sync's TF32
// products, about a third of the dense TF32 peak: splitting K and V once a
// block instead of once a warp, or twice the resident warps, did not move
// it (PERF.md §6). wgmma (TF32 wants both operands K-major in shared
// memory, so V transposed) is the step past it.
//
// flash_fwd_split, for few rows (decode: Lq = 1, a group of 8 heads), where
// flash_fwd's grid is a few blocks that each walk the whole cache:
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
// Its products are explicit fmaf: the library is built with -fmad=false,
// which bars only the compiler's own contraction of a multiply and an add.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, l;  // elements; the last dimension is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// four elements of a staged row → f32
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}
// four consecutive elements in device memory → f32; `vec`: 16-byte aligned
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, bool vec) {
  if (vec) return widen4(p);
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
}

// ---------------------------------------------------------------------------
// flash_fwd: tensor cores, split TF32
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;              // warps of a block, 16 rows each
constexpr int kRows = 16 * kWarps;     // query rows of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;              // keys of a tile

template <int D>
struct FwdSmem {
  static constexpr int KS = D + 16;                  // floats of a staged K row
  static constexpr int VS = D + 4;                   // of a staged V row
  static constexpr int STAGE = kKeys * (KS + VS);    // floats of a ring stage
  static constexpr int BYTES = 2 * STAGE * static_cast<int>(sizeof(float));
};

template <typename T>
constexpr bool kTf32Exact = std::is_same<T, __nv_bfloat16>::value;  // 8-bit mantissa

// x ≈ hi + lo, both TF32 values (lo is 0 for a TF32 type). The tensor
// cores read a TF32 operand's top 19 bits and drop the low 13, so hi is
// x + half a TF32 ulp (an integer add: round to nearest, ties away) and lo
// the exact float32 remainder x − tf32(hi), truncated by the tensor cores
// (the split of CUTLASS's 3xTF32, OpMultiplyAddFastF32)
template <bool EXACT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = __float_as_uint(x) + 0x1000u;
    lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
  }
}

// 2^x by the special-function unit (relative error below 2^-22; −inf → 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b over one k-step, split TF32: the small terms first, those whose
// low part is 0 by type skipped
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  if constexpr (!A_EXACT) mma_tf32(d, al, bh0, bh1);
  if constexpr (!B_EXACT) mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Keys k0 .. k0 + 63 of K and V into a ring stage, as f32 rows of KS and VS
// floats; keys past Lk are 0. `vec`: both tensors 16-byte aligned with
// 16-byte row strides — f32 then goes by cp.async (in flight until the
// caller waits), bf16 by 8-byte loads widened in registers.
template <int D, typename TKV>
__device__ __forceinline__ void stage_kv(float* Ks, float* Vs, const TKV* kb, const TKV* vb,
                                         long long kld, long long vld, int k0, int Lk,
                                         bool vec) {
  constexpr int KS = FwdSmem<D>::KS, VS = FwdSmem<D>::VS, CPR = D / 4;
  for (int e = threadIdx.x; e < kKeys * CPR; e += kThreads) {
    const int c = e / CPR, x = e - c * CPR, kp = k0 + c;
    float* kd = Ks + c * KS + 4 * x;
    float* vd = Vs + c * VS + 4 * x;
    const bool in = kp < Lk;
    if constexpr (std::is_same<TKV, float>::value) {
      if (vec) {
        cp_async16(kd, in ? kb + kp * kld + 4 * x : kb, in ? 16 : 0);
        cp_async16(vd, in ? vb + kp * vld + 4 * x : vb, in ? 16 : 0);
        continue;
      }
    }
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (in) {
      kx = load4(kb + kp * kld + 4 * x, vec);
      vx = load4(vb + kp * vld + 4 * x, vec);
    }
    *reinterpret_cast<float4*>(kd) = kx;
    *reinterpret_cast<float4*>(vd) = vx;
  }
}

// Fragment layouts of mma.m16n8k8 (g = lane / 4, t = lane % 4): A a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1
// (k t + 4, n g); C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
// 2t + 1). In Q·Kᵀ the k index t of k-step 2i (2i + 1) is dim 16i + 4t (+ 2)
// and t + 4 the next dim, so a lane reads 4 dims of a Q or K row at once.
// In P·V the k index t of k-step j is key 8j + 2t and t + 4 key 8j + 2t + 1:
// the keys of Q·Kᵀ's C fragment c0, c1 (c2, c3), so a = (c0, c2, c1, c3).
template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
          TQ* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int Hkv, int group,
          int Lq, int Lk, int causal, int window, float scale_log2, int ntiles, int qvec,
          int kvvec) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int KS = FwdSmem<D>::KS, VS = FwdSmem<D>::VS, STAGE = FwdSmem<D>::STAGE;
  constexpr int DI = D / 16, DN = D / 8;
  constexpr bool QX = kTf32Exact<TQ>, KX = kTf32Exact<TKV>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nbh = gridDim.x / ntiles;
  const int tile = ntiles - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int bh = static_cast<int>(blockIdx.x) - (ntiles - 1 - tile) * nbh;
  const int hkv = bh % Hkv, b = bh / Hkv;
  const int R = Lq * group, off = Lk - Lq, row0 = tile * kRows;

  // the keys any row of the tile may see
  const int last = min(row0 + kRows, R) - 1;
  const int qpos_lo = row0 / group + off, qpos_hi = last / group + off;
  int kbeg = 0, kend = Lk;
  if (causal && qpos_hi + 1 < kend) kend = qpos_hi + 1;
  if (window > 0 && qpos_lo - window + 1 > kbeg) kbeg = qpos_lo - window + 1;
  const int nt = kend > kbeg ? (kend - kbeg + kKeys - 1) / kKeys : 0;

  const TKV* kb = k + b * sk.b + hkv * sk.h;
  const TKV* vb = v + b * sv.b + hkv * sv.h;
  if (nt > 0) stage_kv<D>(ring, ring + kKeys * KS, kb, vb, sk.l, sv.l, kbeg, Lk, kvvec);
  cp_async_commit();

  // this lane's rows g and g + 8 of the warp's 16: positions and Q
  int qpos[2];
  float4 qf[DI][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = row0 + warp * 16 + g + 8 * h;
    qpos[h] = rho / group + off;
    const TQ* qr = q + b * sq.b + (hkv * group + rho % group) * sq.h + (rho / group) * sq.l + 4 * t;
#pragma unroll
    for (int i = 0; i < DI; ++i)
      qf[i][h] = rho < R ? load4(qr + 16 * i, qvec) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float acc[DN][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int k0 = kbeg + it * kKeys;
    const float* Ks = ring + (it & 1) * STAGE;
    const float* Vs = Ks + kKeys * KS;
    if (it + 1 < nt) {
      float* Kn = ring + ((it + 1) & 1) * STAGE;
      stage_kv<D>(Kn, Kn + kKeys * KS, kb, vb, sk.l, sv.l, k0 + kKeys, Lk, kvvec);
    }
    cp_async_commit();
    cp_async_wait1();  // this tile's copies have landed
    __syncthreads();

    // S = Q·Kᵀ: 16 rows × 64 keys a warp, 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      uint32_t ah[2][4], al[2][4];
      split_tf32<QX>(qf[i][0].x, ah[0][0], al[0][0]);
      split_tf32<QX>(qf[i][1].x, ah[0][1], al[0][1]);
      split_tf32<QX>(qf[i][0].y, ah[0][2], al[0][2]);
      split_tf32<QX>(qf[i][1].y, ah[0][3], al[0][3]);
      split_tf32<QX>(qf[i][0].z, ah[1][0], al[1][0]);
      split_tf32<QX>(qf[i][1].z, ah[1][1], al[1][1]);
      split_tf32<QX>(qf[i][0].w, ah[1][2], al[1][2]);
      split_tf32<QX>(qf[i][1].w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kx = *reinterpret_cast<const float4*>(Ks + (8 * j + g) * KS + 16 * i + 4 * t);
        uint32_t bh[4], bl[4];
        split_tf32<KX>(kx.x, bh[0], bl[0]);
        split_tf32<KX>(kx.y, bh[1], bl[1]);
        split_tf32<KX>(kx.z, bh[2], bl[2]);
        split_tf32<KX>(kx.w, bh[3], bl[3]);
        mma3<QX, KX>(s[j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
        mma3<QX, KX>(s[j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
      }
    }

    // the online softmax in base 2; masks only where a key is cut from a row
    const bool whole = k0 + kKeys <= Lk && (!causal || k0 + kKeys - 1 <= qpos_lo) &&
                       (window <= 0 || k0 > qpos_hi - window);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!whole) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1), qp = qpos[e >> 1];
          const bool keep =
              kp < Lk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
          x = keep ? x : -INFINITY;
        }
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float base[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float mn = fmaxf(m[h], mt[h]);
      base[h] = mn == -INFINITY ? 0.f : mn;  // a row with no key yet: every p is 0
      alpha[h] = exp2_approx(m[h] - base[h]);
      m[h] = mn;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(s[j][e] - base[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P·V: k-step j is S's column tile j
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32<false>(s[j][0], ph[0], pl[0]);
      split_tf32<false>(s[j][2], ph[1], pl[1]);
      split_tf32<false>(s[j][1], ph[2], pl[2]);
      split_tf32<false>(s[j][3], ph[3], pl[3]);
      const float* v0 = Vs + (8 * j + 2 * t) * VS + g;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        uint32_t bh0, bh1, bl0, bl1;
        split_tf32<KX>(v0[8 * n], bh0, bl0);
        split_tf32<KX>(v0[VS + 8 * n], bh1, bl1);
        mma3<false, KX>(acc[n], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();  // every warp is done with this stage: the next copy may reuse it
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = row0 + warp * 16 + g + 8 * h;
    if (rho >= R) continue;
    TQ* out = o + b * so.b + (hkv * group + rho % group) * so.h + (rho / group) * so.l + 2 * t;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      store(out + 8 * n, acc[n][2 * h] * inv);
      store(out + 8 * n + 1, acc[n][2 * h + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// the split-key path
// ---------------------------------------------------------------------------

constexpr int kDecRows = 16;                // query rows of a (batch, KV head) at most
constexpr int kDecKeys = 64;                // keys of a tile
constexpr int kDecThreads = 2 * kDecKeys;   // two threads a key in the logits


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
  constexpr int bytes = FwdSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ntiles = (static_cast<long long>(Lq) * group + kRows - 1) / kRows;
  if (ntiles * Hkv * B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bool qvec = aligned16(q), kvvec = aligned16(k) && aligned16(v);
  for (int j = 0; j < 3; ++j) qvec = qvec && (st[j] * static_cast<long long>(sizeof(TQ))) % 16 == 0;
  for (int j = 3; j < 9; ++j)
    kvvec = kvvec && (st[j] * static_cast<long long>(sizeof(TKV))) % 16 == 0;
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  kern<<<static_cast<unsigned>(ntiles * Hkv * B), kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(o), sq, sk, sv, so, Hkv, group, Lq, Lk, causal, window, scale_log2,
      static_cast<int>(ntiles), qvec, kvvec);
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
