// The gradient of causal / sliding-window GQA attention for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference trains through XLA's autodiff of
// its plain attention (src/repro/models/layers.py::attend), and its Pallas
// forward (src/repro/kernels/flash_attention.py) has no backward. The port
// trains through its forward kernel (csrc/flash_attention.cu), so the
// gradient needs a kernel of its own. Given q [B, Hq, Lq, D], k and v
// [B, Hkv, Lk, D], the forward's output o and the loss's gradient dO with
// respect to it, it computes, with the forward's masks (query i
// right-aligned at Lk - Lq + i; `causal` keeps keys at or before it,
// `window > 0` the last `window` of those; scale 1/sqrt(D)):
//   P = softmax(scale · Q·Kᵀ) recomputed from each row's log-sum-exp,
//   D_i = rowsum(dO ∘ O), dS = P ∘ (dO·Vᵀ − D),
//   dQ = scale · dS·K, dK = scale · Σ_group dSᵀ·Q, dV = Σ_group Pᵀ·dO.
// A row with no key left has P = 0: it gets zero gradients and gives none.
//
// What bounds it on an H100: operations — five products of 2·D multiply-
// adds over each (query, key) pair the masks keep (QKᵀ, dO·Vᵀ, dS·K, dSᵀ·Q,
// Pᵀ·dO), at the tensor-core rate of the inputs' type (BF16 at the training
// launch), against the bytes of q, k, v, o, dO in and dq, dk, dv out once.
// The bf16 design below runs eight products a pair (QKᵀ in each of its
// three kernels, dO·Vᵀ in two) and three exp2.
//
// Routes, by dtype (launch_dim): q, k and v all bf16 — the training launch —
// take the tensor-core kernels; float32 and mixed launches take the CUDA-
// core kernels (fmaf in float32; the library is built with -fmad=false).
// No launch falls back from one route to the other.
//
// The bf16 route: three kernels in order on one stream, blocks of 4 warps,
// a warp owning 16 rows (queries, or keys) of a 64-row tile:
//  - flash_bwd_stats, one block per (64-query tile, query head, batch):
//    S = Q·Kᵀ over the keys its rows see with an online max and sum in base
//    2, then each row's log-sum-exp in log2 units (+inf for a row with no
//    key, and past Lq) and D_i, to an f32 workspace [2, B, Hq, Lq rounded
//    up to 64]: a query tile's 64 entries are a 256-byte aligned run that
//    flash_bwd_dkdv copies whole. The forward saves no statistics; this
//    kernel stands apart so that its share shows in a profile.
//  - flash_bwd_dq_tc, one block per (64-query tile, query head, batch):
//    S = Q·Kᵀ and dP = dO·Vᵀ into accumulator fragments, P = exp2(S · scale
//    · log2 e − lse₂) and dS = P ∘ (dP − D) in registers, dQ += dS·K.
//  - flash_bwd_dkdv_tc, one block per (64-key tile, KV head, batch, split
//    of the group), looping over its query heads and the query tiles that
//    see its keys: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so Pᵀ and dSᵀ come out as
//    accumulator fragments; dV += Pᵀ·dO and dK += dSᵀ·Q in f32 registers,
//    written once. Under the causal mask key tile 0 walks every query tile
//    of every head of the group and the last key tile one, so the caller
//    cuts the group among `splits` blocks (kernels/flash_attention.py::
//    dkdv_splits, from the shape alone) when the heaviest walk would be
//    long; each split then writes f32 partials that flash_bwd_dkdv_sum adds
//    in split order.
// Products: mma.sync.m16n8k16, bf16 operands, f32 accumulators. Operand
// fragments come from staged bf16 tiles by ldmatrix.x4, its .trans form
// where the contraction runs along the stored rows (K in dS·K, dO in Pᵀ·dO,
// Q in dSᵀ·Q). Fragment reuse: the accumulators of two 8-column tiles,
// packed to bf16, are the A fragment of one 16-deep k-step of the next
// product (row g: columns 2t, 2t + 1 of the first, then of the second), so
// P and dS never leave registers. They are rounded to bf16 for the products
// that take them, as SDPA's backward does; every sum is f32, and dq, dk, dv
// are rounded to bf16 once.
// Tiles: bf16 rows padded to D + 8 elements (a 16-byte shift a row, so the
// 8 rows of an ldmatrix 8×8 matrix fall in distinct banks), filled by
// 16-byte cp.async, rows past L zero-filled. The streamed operand goes
// through a two-stage ring, the next tile in flight while one is computed:
// K in flash_bwd_stats, K and V in flash_bwd_dq_tc, Q, dO, lse and D in
// flash_bwd_dkdv_tc. Every row of q, k, v, o and dO must be 16-byte aligned
// (the wrapper checks). Masks only on a tile that cuts a row (the diagonal,
// the window's edge, a ragged tail); tiles no row sees are not visited
// (key_span, query_span). The flat grids issue the heavy tiles first: the
// last query tiles in _stats and _dq, the first key tiles in _dkdv. Two
// blocks (8 warps) an SM at least; three of flash_bwd_dq_tc up to D = 96
// and four of flash_bwd_stats, which fit their registers without spilling.
//
// The float32 route: two kernels of 256 threads, float32 tiles in shared
// memory as rows padded to D + 1 floats; a thread owns a 4×4 block of each
// 64×64 product (rows ty + 16i, columns tx + 16j) and 4 rows × D/16 columns
// of each D-wide accumulator.
//  - flash_bwd_dq: one block per (64-query tile, query head, batch). It
//    first walks the keys its rows see and keeps each row's running max and
//    sum, reduced over the 16 threads of a row in a fixed butterfly, writes
//    each row's natural log-sum-exp and D_i to the workspace [B, Hq, Lq],
//    then walks the keys again, stages dS in shared memory and accumulates
//    dQ in registers.
//  - flash_bwd_dkdv: one block per (64-key tile, KV head, batch), over the
//    group's query heads and the query tiles that see its keys, P and dS
//    staged in shared memory, dK and dV in registers.
//
// Determinism, both routes: every output element has one writer that sums
// in a fixed order (shuffle trees of a fixed shape, tiles in order); no
// atomics, so a launch's result is bit-identical from launch to launch
// whatever the SM count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kTile = 64;              // query rows or keys of a tile
constexpr int kThreads = 256;          // 16 × 16
constexpr int kSS = kTile + 1;         // floats of a staged row of a 64×64 tile

struct Strides {
  long long b, h, l;  // elements; the last dimension is contiguous
};

struct Shape {
  int Hq, Hkv, Lq, Lk, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// query row i sees key j
__device__ __forceinline__ bool sees(const Shape& s, int i, int j) {
  const int pos = s.Lk - s.Lq + i;
  return i < s.Lq && j < s.Lk && (!s.causal || j <= pos) && (s.window <= 0 || j > pos - s.window);
}

// the keys [lo, hi) that some row of the query rows [q0, q1) sees
__device__ __forceinline__ void key_span(const Shape& s, int q0, int q1, int& lo, int& hi) {
  const int off = s.Lk - s.Lq;
  hi = s.causal ? min(s.Lk, max(0, off + q1)) : s.Lk;
  lo = s.window > 0 ? min(s.Lk, max(0, off + q0 - s.window + 1)) : 0;
}

// the query rows [lo, hi) that see some key of the keys [k0, k1)
__device__ __forceinline__ void query_span(const Shape& s, int k0, int k1, int& lo, int& hi) {
  const int off = s.Lk - s.Lq;
  lo = s.causal ? min(s.Lq, max(0, k0 - off)) : 0;
  hi = s.window > 0 ? min(s.Lq, max(0, k1 - 1 + s.window - off)) : s.Lq;
}

// rows [r0, r0 + 64) of a [L, D] slab (row stride ls) → a float32 tile of
// rows padded to D + 1; rows at or past L are 0
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ls, int r0, int L) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D, row = r0 + r;
    dst[r * (D + 1) + d] = row < L ? to_f32(src[row * ls + d]) : 0.f;
  }
}

// acc[i][j] += A[ty + 16i] · B[tx + 16j] over D, for 64-row tiles A and B
// staged with rows of D + 1
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* Bt,
                                         int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bt[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += Σ_r S[r][rows ty + 16i] · X[r][tx + 16c] (transposed = true) or
// Σ_r S[rows ty + 16i][r] · X[r][tx + 16c] (false): a 64×64 staged tile
// times a 64×D staged tile
template <int D, bool TRANSPOSED>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16], const float* S, const float* X,
                                         int ty, int tx) {
#pragma unroll 2
  for (int r = 0; r < kTile; ++r) {
    float a[4], x[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = TRANSPOSED ? S[r * kSS + ty + 16 * i] : S[(ty + 16 * i) * kSS + r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = X[r * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(a[i], x[c], acc[i][c]);
  }
}

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * (4 * kTile * (D + 1) + kTile * kSS + 2 * kTile);
}

template <int D, typename TQ, typename TK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(const TQ* __restrict__ q, const TK* __restrict__ k, const TK* __restrict__ v,
                 const TQ* __restrict__ o, const TQ* __restrict__ dO, TQ* __restrict__ dq,
                 float* __restrict__ lse_out, float* __restrict__ delta_out, Strides sq,
                 Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq, Shape s) {
  extern __shared__ float smem[];
  constexpr int P = D + 1;
  float* Qs = smem;
  float* dOs = Qs + kTile * P;
  float* Ks = dOs + kTile * P;
  float* Vs = Ks + kTile * P;
  float* Ss = Vs + kTile * P;
  float* lse_s = Ss + kTile * kSS;
  float* del_s = lse_s + kTile;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.Hq / s.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const TQ* qb = q + b * sq.b + h * sq.h;
  const TQ* ob = o + b * so.b + h * so.h;
  const TQ* dob = dO + b * sdo.b + h * sdo.h;
  const TK* kb = k + b * sk.b + hk * sk.h;
  const TK* vb = v + b * sv.b + hk * sv.h;
  load_tile<D>(Qs, qb, sq.l, q0, s.Lq);
  load_tile<D>(dOs, dob, sdo.l, q0, s.Lq);
  __syncthreads();  // D_i below reads rows other threads loaded
  int lo, hi;
  key_span(s, q0, min(q0 + kTile, s.Lq), lo, hi);

  // pass 1: each row's max and sum over the keys it sees
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    __syncthreads();  // the last tile's reads are done
    load_tile<D>(Ks, kb, sk.l, k0, s.Lk);
    __syncthreads();
    float acc[4][4] = {};
    tile_dot<D>(acc, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!sees(s, q0 + ty + 16 * i, k0 + tx + 16 * j)) continue;
        const float x = acc[i][j] * s.scale;
        if (x > m[i]) {
          l[i] = fmaf(l[i], expf(m[i] - x), 1.f);
          m[i] = x;
        } else {
          l[i] += expf(x - m[i]);
        }
      }
  }
  // over the 16 threads of a row (a half-warp), a fixed butterfly: both
  // lanes of a pair form the same sum, so every lane ends with the same
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      l[i] = l[i] * (m[i] == mn ? 1.f : expf(m[i] - mn)) + lo_ * (mo == mn ? 1.f : expf(mo - mn));
      m[i] = mn;
    }
  const size_t row0 = (static_cast<size_t>(b) * s.Hq + h) * s.Lq;
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float lse = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
      lse_s[r] = lse;
      if (q0 + r < s.Lq) lse_out[row0 + q0 + r] = lse;
    }
  }
  // D_i = Σ_d dO ∘ O: four threads a row, each a fixed quarter of the dims
  {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3, row = q0 + r;
    float acc = 0.f;
    if (row < s.Lq)
      for (int d = part; d < D; d += 4) acc = fmaf(dOs[r * P + d], to_f32(ob[row * so.l + d]), acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      del_s[r] = acc;
      if (row < s.Lq) delta_out[row0 + row] = acc;
    }
  }
  __syncthreads();
  float lse_r[4], del_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lse_r[i] = lse_s[ty + 16 * i], del_r[i] = del_s[ty + 16 * i];

  // pass 2: dS a tile at a time, dQ += dS · K
  float acc_dq[4][D / 16] = {};
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    __syncthreads();
    load_tile<D>(Ks, kb, sk.l, k0, s.Lk);
    load_tile<D>(Vs, vb, sv.l, k0, s.Lk);
    __syncthreads();
    float sc[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(sc, Qs, Ks, ty, tx);
    tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = sees(s, q0 + ty + 16 * i, k0 + tx + 16 * j);
        const float p = in ? expf(fmaf(sc[i][j], s.scale, -lse_r[i])) : 0.f;
        Ss[(ty + 16 * i) * kSS + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    __syncthreads();
    tile_acc<D, false>(acc_dq, Ss, Ks, ty, tx);
  }
  TQ* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s.Lq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) store(dqb + row * sdq.l + tx + 16 * c, acc_dq[i][c] * s.scale);
  }
}

template <int D, typename TQ, typename TK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv(const TQ* __restrict__ q, const TK* __restrict__ k, const TK* __restrict__ v,
                   const TQ* __restrict__ dO, const float* __restrict__ lse,
                   const float* __restrict__ delta, TK* __restrict__ dk, TK* __restrict__ dv,
                   Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                   Shape s) {
  extern __shared__ float smem[];
  constexpr int P = D + 1;
  float* Ks = smem;
  float* Vs = Ks + kTile * P;
  float* Qs = Vs + kTile * P;
  float* dOs = Qs + kTile * P;
  float* Ss = dOs + kTile * P;
  float* lse_s = Ss + kTile * kSS;
  float* del_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = s.Hq / s.Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<D>(Ks, k + b * sk.b + hk * sk.h, sk.l, k0, s.Lk);
  load_tile<D>(Vs, v + b * sv.b + hk * sv.h, sv.l, k0, s.Lk);
  int lo, hi;
  query_span(s, k0, min(k0 + kTile, s.Lk), lo, hi);

  float acc_dk[4][D / 16] = {}, acc_dv[4][D / 16] = {};
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const TQ* qb = q + b * sq.b + h * sq.h;
    const TQ* dob = dO + b * sdo.b + h * sdo.h;
    const size_t row0 = (static_cast<size_t>(b) * s.Hq + h) * s.Lq;
    for (int q0 = lo; q0 < hi; q0 += kTile) {
      __syncthreads();  // the last tile's reads are done
      load_tile<D>(Qs, qb, sq.l, q0, s.Lq);
      load_tile<D>(dOs, dob, sdo.l, q0, s.Lq);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < s.Lq ? lse[row0 + row] : INFINITY;
        del_s[threadIdx.x] = row < s.Lq ? delta[row0 + row] : 0.f;
      }
      __syncthreads();
      // rows: queries ty + 16i; columns: keys tx + 16j
      float p[4][4] = {}, dp[4][4] = {};
      tile_dot<D>(p, Qs, Ks, ty, tx);
      tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i;
          const bool in = sees(s, q0 + r, k0 + tx + 16 * j);
          p[i][j] = in ? expf(fmaf(p[i][j], s.scale, -lse_s[r])) : 0.f;
          Ss[r * kSS + tx + 16 * j] = p[i][j];
        }
      __syncthreads();
      tile_acc<D, true>(acc_dv, Ss, dOs, ty, tx);  // dV += Pᵀ · dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i;
          Ss[r * kSS + tx + 16 * j] = p[i][j] * (dp[i][j] - del_s[r]);
        }
      __syncthreads();
      tile_acc<D, true>(acc_dk, Ss, Qs, ty, tx);  // dK += dSᵀ · Q
    }
  }
  TK* dkb = dk + b * sdk.b + hk * sdk.h;
  TK* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= s.Lk) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      store(dkb + key * sdk.l + tx + 16 * c, acc_dk[i][c] * s.scale);
      store(dvb + key * sdv.l + tx + 16 * c, acc_dv[i][c]);
    }
  }
}

template <int D, typename TQ, typename TK>
int launch_typed(const void* q, const void* k, const void* v, const void* o, const void* dO,
                 void* dq, void* dk, void* dv, float* lse, float* delta, const long long* st,
                 int B, const Shape& s, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]}, sdo{st[12], st[13], st[14]}, sdq{st[15], st[16], st[17]},
      sdk{st[18], st[19], st[20]}, sdv{st[21], st[22], st[23]};
  constexpr int bytes = smem_bytes<D>();
  auto kq = flash_bwd_dq<D, TQ, TK>;
  auto kkv = flash_bwd_dkdv<D, TQ, TK>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gq((s.Lq + kTile - 1) / kTile, s.Hq, B), gkv((s.Lk + kTile - 1) / kTile, s.Hkv, B);
  kq<<<gq, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v),
      static_cast<const TQ*>(o), static_cast<const TQ*>(dO), static_cast<TQ*>(dq), lse, delta,
      sq, sk, sv, so, sdo, sdq, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kkv<<<gkv, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v),
      static_cast<const TQ*>(dO), lse, delta, static_cast<TK*>(dk), static_cast<TK*>(dv), sq, sk,
      sv, sdo, sdk, sdv, s);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the bf16 route: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;        // 4 warps, 16 rows of a 64-row tile each

template <int D>
struct TcTile {
  static constexpr int PS = D + 8;         // bf16 of a staged row
  static constexpr int ELEMS = kTile * PS; // bf16 of a staged 64-row tile
};

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four 8×8 bf16 matrices of shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands each lane its elements transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// 2^x by the special-function unit (relative error below 2^-22; −inf → 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// every row of the query rows [q0, q1) sees every key of [k0, k1)
__device__ __forceinline__ bool sees_all(const Shape& s, int q0, int q1, int k0, int k1) {
  const int off = s.Lk - s.Lq;
  return k1 <= s.Lk && (!s.causal || k1 - 1 <= off + q0) &&
         (s.window <= 0 || k0 > off + q1 - 1 - s.window);
}

// rows r0 .. r0 + 63 of a [L, D] bf16 slab (row stride ld) into a staged
// tile by 16-byte cp.async; rows at or past L are zero-filled
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long ld, int r0,
                                           int L) {
  constexpr int PS = TcTile<D>::PS, CPR = D / 8;
  for (int e = threadIdx.x; e < kTile * CPR; e += kTcThreads) {
    const int r = e / CPR, c = e - r * CPR, row = r0 + r;
    const bool in = row < L;
    cp_async16(dst + r * PS + 8 * c, in ? src + row * ld + 8 * c : src, in ? 16 : 0);
  }
}

// c[j] (16 rows × columns 8j .. 8j + 7) += A·Bᵀ over D: A the warp's 16
// staged rows, B a staged 64-row tile (its rows are the columns)
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const bf16* A, const bf16* Bm,
                                        int lane) {
  constexpr int PS = TcTile<D>::PS;
  const bf16* a_at = A + (lane & 15) * PS + ((lane >> 4) << 3);
  const bf16* b_at = Bm + ((lane & 7) + ((lane >> 4) << 3)) * PS + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_at + 16 * kk);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, b_at + 16 * jj * PS + 16 * kk);
      mma_bf16(c[2 * jj], a, b[0], b[1]);
      mma_bf16(c[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// c[n] (16 rows × dims 8n .. 8n + 7) += P·X: P the 16 × 64 accumulator
// fragments p (rounded to bf16 here), X a staged 64-row tile of D dims
template <int D>
__device__ __forceinline__ void mma_px(float (&c)[D / 8][4], const float (&p)[8][4],
                                       const bf16* X, int lane) {
  constexpr int PS = TcTile<D>::PS;
  const bf16* x_at = X + (lane & 15) * PS + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t b[4];
      ldsm_x4_trans(b, x_at + 16 * kk * PS + 16 * dd);
      mma_bf16(c[2 * dd], a, b[0], b[1]);
      mma_bf16(c[2 * dd + 1], a, b[2], b[3]);
    }
  }
}

// A warp's fragments (g = lane / 4, t = lane % 4): c[j][e] is row g + 8·(e / 2)
// of the warp's 16, column 8j + 2t + e % 2 of the tile's 64.

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_bwd_stats(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ o, const bf16* __restrict__ dO,
                    float* __restrict__ lse, float* __restrict__ delta, Strides sq, Strides sk,
                    Strides so, Strides sdo, Shape s, int nqt, float scale_log2) {
  constexpr int PS = TcTile<D>::PS, TILE = TcTile<D>::ELEMS;
  extern __shared__ uint4 tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* ring = Qs + TILE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nbh = static_cast<int>(gridDim.x) / nqt, bx = static_cast<int>(blockIdx.x);
  const int tile = nqt - 1 - bx / nbh, bh = bx % nbh;  // the last query tiles first
  const int h = bh % s.Hq, b = bh / s.Hq, hk = h / (s.Hq / s.Hkv);
  const int q0 = tile * kTile, q1 = min(q0 + kTile, s.Lq);
  const bf16* kb = k + b * sk.b + hk * sk.h;
  int lo, hi;
  key_span(s, q0, q1, lo, hi);
  const int nt = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  stage_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, s.Lq);
  if (nt > 0) stage_tile<D>(ring, kb, sk.l, lo, s.Lk);
  cp_async_commit();

  const size_t row0 = (static_cast<size_t>(b) * s.Hq + h) * (nqt * kTile) + q0;
  // D_i = Σ_d dO ∘ O: two threads a row, each a fixed half of the dims
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float acc = 0.f;
    if (row < s.Lq) {
      const bf16* orow = o + b * so.b + h * so.h + row * so.l + half * (D / 2);
      const bf16* drow = dO + b * sdo.b + h * sdo.h + row * sdo.l + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 y = *reinterpret_cast<const uint4*>(drow + c);
        acc = fmaf(bf_lo(x.x), bf_lo(y.x), acc);
        acc = fmaf(bf_hi(x.x), bf_hi(y.x), acc);
        acc = fmaf(bf_lo(x.y), bf_lo(y.y), acc);
        acc = fmaf(bf_hi(x.y), bf_hi(y.y), acc);
        acc = fmaf(bf_lo(x.z), bf_lo(y.z), acc);
        acc = fmaf(bf_hi(x.z), bf_hi(y.z), acc);
        acc = fmaf(bf_lo(x.w), bf_lo(y.w), acc);
        acc = fmaf(bf_hi(x.w), bf_hi(y.w), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) delta[row0 + r] = acc;
  }

  // each row's max and sum in base 2 over the keys it sees
  const int off = s.Lk - s.Lq;
  int qpos[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qpos[hh] = off + q0 + warp * 16 + g + 8 * hh;
    m[hh] = -INFINITY;
    l[hh] = 0.f;
  }
  for (int it = 0; it < nt; ++it) {
    const int k0 = lo + it * kTile;
    const bf16* Ks = ring + (it & 1) * TILE;
    if (it + 1 < nt) stage_tile<D>(ring + ((it + 1) & 1) * TILE, kb, sk.l, k0 + kTile, s.Lk);
    cp_async_commit();
    cp_async_wait1();  // this tile's copies (and Q's) have landed
    __syncthreads();
    float c[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    mma_abt<D>(c, Qs + warp * 16 * PS, Ks, lane);
    const bool whole = sees_all(s, q0, q1, k0, k0 + kTile);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = c[j][e] * scale_log2;
        if (!whole) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1), qp = qpos[e >> 1];
          const bool keep =
              kp < s.Lk && (!s.causal || kp <= qp) && (s.window <= 0 || kp > qp - s.window);
          x = keep ? x : -INFINITY;
        }
        c[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float base[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
      const float mn = fmaxf(m[hh], mt[hh]);
      base[hh] = mn == -INFINITY ? 0.f : mn;  // no key yet: every term is 0
      l[hh] *= exp2_approx(m[hh] - base[hh]);
      m[hh] = mn;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += exp2_approx(c[j][e] - base[e >> 1]);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait_all();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    // over the quad that shares the row, in a fixed tree
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int r = warp * 16 + g + 8 * hh;
    if (t == 0)
      lse[row0 + r] = q0 + r < s.Lq && l[hh] > 0.f ? m[hh] + log2f(l[hh]) : INFINITY;
  }
}

// three blocks an SM where the registers allow it without spilling (D ≤ 96)
template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 96 ? 3 : 2)
    flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                    Strides sdq, Shape s, int nqt, float scale_log2) {
  constexpr int PS = TcTile<D>::PS, TILE = TcTile<D>::ELEMS;
  extern __shared__ uint4 tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dOs = Qs + TILE;
  bf16* ring = dOs + TILE;  // two stages of K, V

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nbh = static_cast<int>(gridDim.x) / nqt, bx = static_cast<int>(blockIdx.x);
  const int tile = nqt - 1 - bx / nbh, bh = bx % nbh;  // the last query tiles first
  const int h = bh % s.Hq, b = bh / s.Hq, hk = h / (s.Hq / s.Hkv);
  const int q0 = tile * kTile, q1 = min(q0 + kTile, s.Lq);
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;
  int lo, hi;
  key_span(s, q0, q1, lo, hi);
  const int nt = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  stage_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, s.Lq);
  stage_tile<D>(dOs, dO + b * sdo.b + h * sdo.h, sdo.l, q0, s.Lq);
  if (nt > 0) {
    stage_tile<D>(ring, kb, sk.l, lo, s.Lk);
    stage_tile<D>(ring + TILE, vb, sv.l, lo, s.Lk);
  }
  cp_async_commit();

  const int off = s.Lk - s.Lq;
  const size_t row0 = (static_cast<size_t>(b) * s.Hq + h) * (nqt * kTile) + q0;
  int qpos[2];
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    qpos[hh] = off + q0 + r;
    lse_r[hh] = lse[row0 + r];
    del_r[hh] = delta[row0 + r];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int k0 = lo + it * kTile;
    const bf16* Ks = ring + (it & 1) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    if (it + 1 < nt) {
      bf16* nxt = ring + ((it + 1) & 1) * 2 * TILE;
      stage_tile<D>(nxt, kb, sk.l, k0 + kTile, s.Lk);
      stage_tile<D>(nxt + TILE, vb, sv.l, k0 + kTile, s.Lk);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    mma_abt<D>(sc, Qs + warp * 16 * PS, Ks, lane);
    mma_abt<D>(dp, dOs + warp * 16 * PS, Vs, lane);
    const bool whole = sees_all(s, q0, q1, k0, k0 + kTile);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool keep = true;
        if (!whole) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1), qp = qpos[e >> 1];
          keep = kp < s.Lk && (!s.causal || kp <= qp) && (s.window <= 0 || kp > qp - s.window);
        }
        const float p = keep ? exp2_approx(fmaf(sc[j][e], scale_log2, -lse_r[e >> 1])) : 0.f;
        sc[j][e] = p * (dp[j][e] - del_r[e >> 1]);  // dS
      }
    mma_px<D>(acc, sc, Ks, lane);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait_all();

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row >= s.Lq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(dqb + row * sdq.l + 8 * n + 2 * t, acc[n][2 * hh] * s.scale,
             acc[n][2 * hh + 1] * s.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                      Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                      Shape s, int nkt, int splits, float scale_log2) {
  constexpr int PS = TcTile<D>::PS, TILE = TcTile<D>::ELEMS;
  constexpr int STAGE = 2 * TILE + 4 * kTile;  // Q, dO, then 64 floats of lse and of D
  extern __shared__ uint4 tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* Vs = Ks + TILE;
  bf16* ring = Vs + TILE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nbh = static_cast<int>(gridDim.x) / (nkt * splits), bx = static_cast<int>(blockIdx.x);
  const int tile = bx / (nbh * splits);  // the first key tiles first
  const int split = bx / nbh % splits, bh = bx % nbh;
  const int hk = bh % s.Hkv, b = bh / s.Hkv, heads = s.Hq / s.Hkv / splits;
  const int h0 = (hk * splits + split) * heads;  // the split's first query head
  const int k0 = tile * kTile, k1 = min(k0 + kTile, s.Lk);
  const int nqt = (s.Lq + kTile - 1) / kTile;
  int lo, hi;
  query_span(s, k0, k1, lo, hi);
  const int t0 = lo / kTile, nq = hi > lo ? (hi + kTile - 1) / kTile - t0 : 0;
  const int n = heads * nq;

  // step i: query head h0 + i / nq, query tile t0 + i % nq
  auto stage = [&](int i, bf16* slot) {
    const int h = h0 + i / nq, q0 = (t0 + i % nq) * kTile;
    stage_tile<D>(slot, q + b * sq.b + h * sq.h, sq.l, q0, s.Lq);
    stage_tile<D>(slot + TILE, dO + b * sdo.b + h * sdo.h, sdo.l, q0, s.Lq);
    if (threadIdx.x < 2 * kTile / 4) {
      const int w = threadIdx.x, part = w / (kTile / 4), c = w % (kTile / 4);
      const size_t r0 = (static_cast<size_t>(b) * s.Hq + h) * (nqt * kTile) + q0;
      float* st = reinterpret_cast<float*>(slot + 2 * TILE) + part * kTile + 4 * c;
      cp_async16(st, (part ? delta : lse) + r0 + 4 * c, 16);
    }
  };
  stage_tile<D>(Ks, k + b * sk.b + hk * sk.h, sk.l, k0, s.Lk);
  stage_tile<D>(Vs, v + b * sv.b + hk * sv.h, sv.l, k0, s.Lk);
  if (n > 0) stage(0, ring);
  cp_async_commit();

  const int off = s.Lk - s.Lq;
  int kpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) kpos[hh] = k0 + warp * 16 + g + 8 * hh;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int q0 = (t0 + i % nq) * kTile;
    const bf16* Qs = ring + (i & 1) * STAGE;
    const bf16* dOs = Qs + TILE;
    const float* lse_s = reinterpret_cast<const float*>(dOs + TILE);
    const float* del_s = lse_s + kTile;
    if (i + 1 < n) stage(i + 1, ring + ((i + 1) & 1) * STAGE);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    // rows: the warp's 16 keys; columns: the tile's 64 queries
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    mma_abt<D>(st, Ks + warp * 16 * PS, Qs, lane);
    mma_abt<D>(dpt, Vs + warp * 16 * PS, dOs, lane);
    const bool whole = sees_all(s, q0, min(q0 + kTile, s.Lq), k0, k1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
      const float2 ds = *reinterpret_cast<const float2*>(del_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool keep = true;
        if (!whole) {
          const int kp = kpos[e >> 1], qp = off + q0 + 8 * j + 2 * t + (e & 1);
          keep = (!s.causal || kp <= qp) && (s.window <= 0 || kp > qp - s.window);
        }
        const float p = keep ? exp2_approx(fmaf(st[j][e], scale_log2, -(e & 1 ? ls.y : ls.x)))
                             : 0.f;
        st[j][e] = p;                                    // Pᵀ
        dpt[j][e] = p * (dpt[j][e] - (e & 1 ? ds.y : ds.x));  // dSᵀ
      }
    }
    mma_px<D>(dva, st, dOs, lane);
    mma_px<D>(dka, dpt, Qs, lane);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait_all();

  if (splits == 1) {
    bf16* dkb = dk + b * sdk.b + hk * sdk.h;
    bf16* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = kpos[hh];
      if (key >= s.Lk) continue;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        store2(dkb + key * sdk.l + 8 * c + 2 * t, dka[c][2 * hh] * s.scale,
               dka[c][2 * hh + 1] * s.scale);
        store2(dvb + key * sdv.l + 8 * c + 2 * t, dva[c][2 * hh], dva[c][2 * hh + 1]);
      }
    }
    return;
  }
  // the split's partial sums, unscaled, to part [2 (dK, dV), splits, B, Hkv, Lk, D]
  const size_t plane = static_cast<size_t>(nbh) * s.Lk * D;
  float* pk = part + (split * static_cast<size_t>(nbh) + bh) * s.Lk * D;
  float* pv = pk + splits * plane;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kpos[hh];
    if (key >= s.Lk) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const size_t at = static_cast<size_t>(key) * D + 8 * c + 2 * t;
      *reinterpret_cast<float2*>(pk + at) = make_float2(dka[c][2 * hh], dka[c][2 * hh + 1]);
      *reinterpret_cast<float2*>(pv + at) = make_float2(dva[c][2 * hh], dva[c][2 * hh + 1]);
    }
  }
}

// dK = scale · Σ_split, dV = Σ_split of flash_bwd_dkdv_tc's partials, summed
// in split order: one thread a 4-dim run of a key row
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dkdv_sum(const float* __restrict__ part, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, Strides sdk, Strides sdv, int nbh, int Hkv, int Lk,
                       int splits, float scale) {
  const size_t runs = static_cast<size_t>(nbh) * Lk * (D / 4);
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= runs) return;
  const size_t row = i / (D / 4), plane = static_cast<size_t>(nbh) * Lk * D;
  const int c = static_cast<int>(i % (D / 4)), key = static_cast<int>(row % Lk);
  const int bh = static_cast<int>(row / Lk), hk = bh % Hkv, b = bh / Hkv;
  const float* pk = part + row * D + 4 * c;
  const float* pv = pk + splits * plane;
  float4 sk = *reinterpret_cast<const float4*>(pk), sv = *reinterpret_cast<const float4*>(pv);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(pk + sp * plane);
    const float4 y = *reinterpret_cast<const float4*>(pv + sp * plane);
    sk.x += x.x, sk.y += x.y, sk.z += x.z, sk.w += x.w;
    sv.x += y.x, sv.y += y.y, sv.z += y.z, sv.w += y.w;
  }
  bf16* dkr = dk + b * sdk.b + hk * sdk.h + key * sdk.l + 4 * c;
  bf16* dvr = dv + b * sdv.b + hk * sdv.h + key * sdv.l + 4 * c;
  store2(dkr, sk.x * scale, sk.y * scale);
  store2(dkr + 2, sk.z * scale, sk.w * scale);
  store2(dvr, sv.x, sv.y);
  store2(dvr + 2, sv.z, sv.w);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dO,
              void* dq, void* dk, void* dv, float* lse, float* delta, const long long* st, int B,
              const Shape& s, int splits, float* part, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]}, sdo{st[12], st[13], st[14]}, sdq{st[15], st[16], st[17]},
      sdk{st[18], st[19], st[20]}, sdv{st[21], st[22], st[23]};
  constexpr int T = TcTile<D>::ELEMS * static_cast<int>(sizeof(bf16));
  constexpr int stats_bytes = 3 * T, dq_bytes = 6 * T,
                dkdv_bytes = 6 * T + 2 * 2 * kTile * static_cast<int>(sizeof(float));
  auto ks = flash_bwd_stats<D>;
  auto kq = flash_bwd_dq_tc<D>;
  auto kkv = flash_bwd_dkdv_tc<D>;
  cudaError_t err =
      cudaFuncSetAttribute(ks, cudaFuncAttributeMaxDynamicSharedMemorySize, stats_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  const int nqt = (s.Lq + kTile - 1) / kTile, nkt = (s.Lk + kTile - 1) / kTile;
  const unsigned gq = static_cast<unsigned>(nqt) * s.Hq * B;
  const unsigned gkv = static_cast<unsigned>(nkt) * splits * s.Hkv * B;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dO);
  ks<<<gq, kTcThreads, stats_bytes, stream>>>(qp, kp, static_cast<const bf16*>(o), dop, lse,
                                               delta, sq, sk, so, sdo, s, nqt, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kq<<<gq, kTcThreads, dq_bytes, stream>>>(qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dq),
                                            sq, sk, sv, sdo, sdq, s, nqt, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kkv<<<gkv, kTcThreads, dkdv_bytes, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, sq, sk,
      sv, sdo, sdk, sdv, s, nkt, splits, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t runs = static_cast<size_t>(B) * s.Hkv * s.Lk * (D / 4);
  flash_bwd_dkdv_sum<D><<<static_cast<unsigned>((runs + 255) / 256), 256, 0, stream>>>(
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sdk, sdv, B * s.Hkv, s.Hkv, s.Lk,
      splits, s.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dim(int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
               const void* o, const void* dO, void* dq, void* dk, void* dv, float* lse,
               float* delta, const long long* st, int B, const Shape& s, int splits, float* part,
               cudaStream_t stream) {
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_typed<D, float, float>(q, k, v, o, dO, dq, dk, dv, lse, delta, st, B, s, stream);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_typed<D, float, bf16>(q, k, v, o, dO, dq, dk, dv, lse, delta, st, B, s, stream);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_typed<D, bf16, float>(q, k, v, o, dO, dq, dk, dv, lse, delta, st, B, s, stream);
  if (q_dtype == 1 && kv_dtype == 1)  // the tensor-core route
    return launch_tc<D>(q, k, v, o, dO, dq, dk, dv, lse, delta, st, B, s, splits, part, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o, dO, dq, dk, dv: device pointers; strides: 24 element strides
// (batch, head, position) of q, k, v, o, dO, dq, dk and dv in that order,
// each last dimension contiguous; dtype codes 0 = float32, 1 = bfloat16 (o,
// dO and dq have q's, dk and dv k's); D one of 32, 64, 96, 128; Hq a
// multiple of Hkv; Lq, Lk > 0. lse and delta: B·Hq·Lqp floats of workspace
// each, Lqp = Lq rounded up to a multiple of 64, 16-byte aligned. A bf16
// launch (q and k both bf16) also needs every row of q, k, v, o and dO
// 16-byte aligned: pointers, batch, head and position strides; `splits`
// (a divisor of Hq / Hkv) cuts each KV head's group of query heads among
// that many flash_bwd_dkdv_tc blocks, and when it is above 1, `part` holds
// 2·splits·B·Hkv·Lk·D floats of workspace for their partial sums. Other
// launches need splits = 1. Launches flash_bwd_stats, flash_bwd_dq_tc,
// flash_bwd_dkdv_tc and (splits > 1) flash_bwd_dkdv_sum (bf16), or
// flash_bwd_dq and flash_bwd_dkdv (the rest), on `stream`; returns the
// first error cudaGetLastError() reports after a launch (0: none).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, void* dq, void* dk,
                                          void* dv, void* lse, void* delta,
                                          const long long* strides, int B, int Hq, int Hkv,
                                          int Lq, int Lk, int D, int causal, int window,
                                          int q_dtype, int kv_dtype, int splits, void* part,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = q_dtype == 1 && kv_dtype == 1;
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv || splits <= 0 ||
      (Hq / Hkv) % splits || (splits > 1 && (!tc || part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{Hq, Hkv, Lq, Lk, causal, window,
                static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  switch (D) {
    case 32:
      return launch_dim<32>(q_dtype, kv_dtype, q, k, v, o, dO, dq, dk, dv, l, d, strides, B, s,
                            splits, pt, st);
    case 64:
      return launch_dim<64>(q_dtype, kv_dtype, q, k, v, o, dO, dq, dk, dv, l, d, strides, B, s,
                            splits, pt, st);
    case 96:
      return launch_dim<96>(q_dtype, kv_dtype, q, k, v, o, dO, dq, dk, dv, l, d, strides, B, s,
                            splits, pt, st);
    case 128:
      return launch_dim<128>(q_dtype, kv_dtype, q, k, v, o, dO, dq, dk, dv, l, d, strides, B, s,
                             splits, pt, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
