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
// Design (simple and right first; tensor cores, TMA and warp
// specialisation are later work):
//  - one block of 256 threads per (batch, KV head, 64-row tile), where a
//    row is a (query position, query head of the group) pair: the group's
//    query heads share every K/V tile the block stages, and decode's one
//    position gives a tile of `group` rows instead of `group` near-empty
//    tiles;
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

template <int D, typename TQ, typename TKV>
int launch_typed(const void* q, const void* k, const void* v, void* o, const long long* st,
                 int B, int Hq, int Hkv, int Lq, int Lk, int causal, int window,
                 cudaStream_t stream) {
  auto kern = flash_fwd<D, TQ, TKV>;
  const size_t bytes = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = Hq / Hkv;
  const long long rows = static_cast<long long>(Lq) * group;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), Hkv, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(o), Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, group, Lq, Lk, causal,
      window, static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dim(int q_dtype, int kv_dtype, const void* q, const void* k, const void* v, void* o,
               const long long* st, int B, int Hq, int Hkv, int Lq, int Lk, int causal,
               int window, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_typed<D, float, float>(q, k, v, o, st, B, Hq, Hkv, Lq, Lk, causal, window, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_typed<D, float, bf16>(q, k, v, o, st, B, Hq, Hkv, Lq, Lk, causal, window, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_typed<D, bf16, float>(q, k, v, o, st, B, Hq, Hkv, Lq, Lk, causal, window, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_typed<D, bf16, bf16>(q, k, v, o, st, B, Hq, Hkv, Lq, Lk, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: device pointers; strides: 12 element strides (batch, head,
// position) of q, k, v and o in that order, each last dimension
// contiguous; dtype codes 0 = float32, 1 = bfloat16 (o has q's); D one of
// 32, 64, 96, 128; Hq a multiple of Hkv. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const long long* strides, int B, int Hq, int Hkv, int Lq,
                                      int Lk, int D, int causal, int window, int q_dtype,
                                      int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dim<32>(q_dtype, kv_dtype, q, k, v, o, strides, B, Hq, Hkv, Lq, Lk, causal,
                            window, s);
    case 64:
      return launch_dim<64>(q_dtype, kv_dtype, q, k, v, o, strides, B, Hq, Hkv, Lq, Lk, causal,
                            window, s);
    case 96:
      return launch_dim<96>(q_dtype, kv_dtype, q, k, v, o, strides, B, Hq, Hkv, Lq, Lk, causal,
                            window, s);
    case 128:
      return launch_dim<128>(q_dtype, kv_dtype, q, k, v, o, strides, B, Hq, Hkv, Lq, Lk, causal,
                             window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
