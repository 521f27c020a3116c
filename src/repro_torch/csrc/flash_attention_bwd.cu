// The gradient of causal / sliding-window GQA attention for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference trains through XLA's autodiff of
// its plain attention (src/repro/models/layers.py::attend), and its Pallas
// forward (src/repro/kernels/flash_attention.py) has no backward. The port
// trains through its forward kernel (csrc/flash_attention.cu), so the
// gradient needs a kernel of its own. Given q [B, Hq, Lq, D], k and v
// [B, Hkv, Lk, D], the forward's output o and the loss's gradient dO with
// respect to it, it computes, in float32 with the forward's masks (query i
// right-aligned at Lk - Lq + i; `causal` keeps keys at or before it,
// `window > 0` the last `window` of those; scale 1/sqrt(D)):
//   P = softmax(scale · Q·Kᵀ) recomputed from each row's log-sum-exp,
//   D_i = rowsum(dO ∘ O), dS = P ∘ (dO·Vᵀ − D),
//   dQ = scale · dS·K, dK = scale · Σ_group dSᵀ·Q, dV = Σ_group Pᵀ·dO.
// A row with no key left has P = 0: it gets zero gradients and gives none.
//
// What bounds it on an H100: operations — five products of 2·D multiply-
// adds over each (query, key) pair the masks keep (QKᵀ twice, dO·Vᵀ, dS·K,
// dSᵀ·Q, Pᵀ·dO: six with the recomputation in flash_bwd_dq), against the
// bytes of q, k, v, o, dO in and dq, dk, dv out once. This first kernel
// runs them on the CUDA cores in float32 (fmaf; the library is built with
// -fmad=false), so its bound is the float32 rate, not the tensor cores'.
//
// Two kernels, no atomics: every output element has one writer that sums
// in a fixed order, so a launch's result is bit-identical from launch to
// launch whatever the SM count.
//  - flash_bwd_dq: one block of 256 threads per (64-query tile, query head,
//    batch). It first walks the keys its rows see and keeps each row's
//    running max and sum (the forward kernel stays as it is and saves
//    nothing), reduced over the 16 threads that share a row in a fixed
//    butterfly; it writes each row's log-sum-exp (+inf for a row with no
//    key) and D_i to an f32 workspace [B, Hq, Lq]; then it walks the keys
//    again, recomputes P and dP a 64×64 tile at a time, stages dS in shared
//    memory and accumulates dQ in registers.
//  - flash_bwd_dkdv: one block per (64-key tile, KV head, batch). It walks
//    the group's query heads and, for each, only the query tiles that can
//    see its keys (the causal and window bounds, right-aligned); it reads
//    their log-sum-exp and D, recomputes P and dP, and accumulates dK and dV
//    for the whole group in registers, written once at the end.
// Tiles are staged in shared memory as float32 rows padded to D + 1 floats
// (D is a multiple of 32, so a thread's column of 16 rows hits 16 banks);
// a thread owns a 4×4 block of each 64×64 product (rows ty + 16i, columns
// tx + 16j) and 4 rows × D/16 columns of each D-wide accumulator.
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

template <int D>
int launch_dim(int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
               const void* o, const void* dO, void* dq, void* dk, void* dv, float* lse,
               float* delta, const long long* st, int B, const Shape& s, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_typed<D, float, float>(q, k, v, o, dO, dq, dk, dv, lse, delta, st, B, s, stream);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_typed<D, float, bf16>(q, k, v, o, dO, dq, dk, dv, lse, delta, st, B, s, stream);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_typed<D, bf16, float>(q, k, v, o, dO, dq, dk, dv, lse, delta, st, B, s, stream);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_typed<D, bf16, bf16>(q, k, v, o, dO, dq, dk, dv, lse, delta, st, B, s, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o, dO, dq, dk, dv: device pointers; strides: 24 element strides
// (batch, head, position) of q, k, v, o, dO, dq, dk and dv in that order,
// each last dimension contiguous; dtype codes 0 = float32, 1 = bfloat16 (o,
// dO and dq have q's, dk and dv k's); D one of 32, 64, 96, 128; Hq a
// multiple of Hkv; Lq, Lk > 0. lse and delta: B·Hq·Lq floats of workspace.
// Launches flash_bwd_dq, then flash_bwd_dkdv, on `stream`; returns the
// first error cudaGetLastError() reports after a launch (0: none).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, void* dq, void* dk,
                                          void* dv, void* lse, void* delta,
                                          const long long* strides, int B, int Hq, int Hkv,
                                          int Lq, int Lk, int D, int causal, int window,
                                          int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{Hq, Hkv, Lq, Lk, causal, window,
                static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (D) {
    case 32:
      return launch_dim<32>(q_dtype, kv_dtype, q, k, v, o, dO, dq, dk, dv, l, d, strides, B, s, st);
    case 64:
      return launch_dim<64>(q_dtype, kv_dtype, q, k, v, o, dO, dq, dk, dv, l, d, strides, B, s, st);
    case 96:
      return launch_dim<96>(q_dtype, kv_dtype, q, k, v, o, dO, dq, dk, dv, l, d, strides, B, s, st);
    case 128:
      return launch_dim<128>(q_dtype, kv_dtype, q, k, v, o, dO, dq, dk, dv, l, d, strides, B, s,
                             st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
