// Rank-based estimators of the join sample (paper §5.3), for Hopper (sm_90a).
//
// rank_moments replaces the Pallas TPU kernel src/repro/kernels/
// rank_transform.py::rank_moments: per row, the masked midranks of a and b,
//   r_i = Σ_j w_j[x_j < x_i] + ½ Σ_j w_j[x_j = x_i] + ½,
// optionally mapped through the rankit table (kind 1, "rin"), reduced to
// [m, Σr_a, Σr_b, Σr_a², Σr_b², Σr_a r_b].
//
// qn_correlation replaces src/repro/kernels/rank_transform.py::
// qn_correlation: the Shevlyakov–Oja robust correlation from four Qn scales.
//
// rank_transform replaces src/repro/kernels/rank_transform.py::
// rank_transform: the weighted midranks themselves, per row,
//   rank_i = (Σ_j w_j[x_j < x_i] + ½ Σ_j w_j[x_j = x_i] + ½) · w_i,
// for the paper library's Spearman and RIN estimators (core/estimators).
// One block per row; the row's weights are read first, and a row with no
// nonzero weight writes zeros without reading x. The j loop stages the row
// through shared memory a tile at a time, so any n runs; each thread holds
// one x_i and adds the weights of its tile's smaller and equal values in
// ascending j order (f32). With 0/1 weights every sum is an integer below
// 2²⁴, so ranks are exact half-integers. What bounds it: operations, two
// compares per pair of live slots, O(n²) per row against O(n) bytes.
//
// What bounds them on an H100: bytes, at the engine's data. Rows are join
// samples and most candidates share no key with the query (m = 0), so the
// kernels read a row's mask first and read its a and b only when the row
// joined (m ≥ 1 for ranks, m ≥ 2 for Qn); the O(n²) rank compares and the
// Qn bisection run only on those rows.
//
// Design: one block per row, the row in shared memory. Ranks use the
// pairwise rule with integer counts, so 2·r is an exact integer and the rin
// lookup index m·(2n+1) + 2r is exact (the table is the host's float64 Φ⁻¹,
// as in the reference engine). The Pallas Qn kernel runs 31 full n × n count
// passes per scale; here each scale sorts the valid values once (bitonic, in
// shared memory) and each of the 31 bisection probes over the float32 bit
// patterns counts the pairs with x_j ≤ x_i + t by binary search — O(n log n)
// a probe, the reference engine's own formulation. Sums use a fixed
// reduction tree: results are deterministic. Rows with m = 0 (ranks) or
// m < 2 (Qn) exit after reading their mask, with the formula's value, zero.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFiniteBits = 0x7F7FFFFF;
constexpr float kQnConstant = 2.21914f;
constexpr float kBig = 3.4e38f;
constexpr float kInvSqrt2 = 0.70710677f;  // float32(1/sqrt(2))

// Loads a row's validity into shared memory and returns m, its valid slots;
// loads the row's a and b as well only when m ≥ min_m, so a row whose
// result is zero costs its mask alone. m is block-uniform.
__device__ int load_row(const float* a, const float* b, const float* w, size_t base, int n,
                        int min_m, float* sa, float* sb, unsigned char* sw) {
  int m = 0;
  for (int start = 0; start < n; start += blockDim.x) {
    const int i = start + threadIdx.x;
    int ok = 0;
    if (i < n) {
      ok = w[base + i] > 0.f;
      sw[i] = static_cast<unsigned char>(ok);
    }
    m += __syncthreads_count(ok);
  }
  if (m < min_m) return m;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sa[i] = a[base + i];
    sb[i] = b[base + i];
  }
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kThreads)
rank_moments_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ w, int n, int kind,
                    const float* __restrict__ table, float* __restrict__ out) {
  extern __shared__ float smem[];  // a[n], b[n], then n validity bytes
  float* sa = smem;
  float* sb = smem + n;
  unsigned char* sw = reinterpret_cast<unsigned char*>(smem + 2 * n);
  __shared__ float scratch[5 * repro::kMaxWarps];
  const int r = blockIdx.x;
  const int m = load_row(a, b, w, static_cast<size_t>(r) * n, n, 1, sa, sb, sw);
  float* o = out + static_cast<size_t>(r) * 6;
  if (m == 0) {
    if (threadIdx.x < 6) o[threadIdx.x] = 0.f;
    return;
  }
  float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  const float* row_tab = kind == 1 ? table + static_cast<size_t>(m) * (2 * n + 1) : nullptr;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!sw[i]) continue;
    const float ai = sa[i], bi = sb[i];
    int lta = 0, eqa = 0, ltb = 0, eqb = 0;
    for (int j = 0; j < n; ++j) {
      if (sw[j]) {
        const float aj = sa[j], bj = sb[j];
        lta += aj < ai;
        eqa += aj == ai;
        ltb += bj < bi;
        eqb += bj == bi;
      }
    }
    const int ta = 2 * lta + eqa + 1, tb = 2 * ltb + eqb + 1;  // 2 × midrank
    float ra, rb;
    if (kind == 1) {
      ra = row_tab[ta];
      rb = row_tab[tb];
    } else {
      ra = 0.5f * static_cast<float>(ta);
      rb = 0.5f * static_cast<float>(tb);
    }
    s[0] += ra;
    s[1] += rb;
    s[2] += ra * ra;
    s[3] += rb * rb;
    s[4] += ra * rb;
  }
  repro::block_sum(s, scratch);
  if (threadIdx.x == 0) {
    o[0] = static_cast<float>(m);
#pragma unroll
    for (int k = 0; k < 5; ++k) o[k + 1] = s[k];
  }
}

// 2.21914 · the kq-th smallest pairwise difference of the m valid values
// already in xs[0..np2) (invalid and padding slots +inf). Sorts xs.
__device__ float qn_scale(float* xs, int np2, int m, long long kq, long long* scratch,
                          int* s_hi) {
  repro::bitonic_sort<float, float>(xs, nullptr, np2);
  int lo = 0, hi = kMaxFiniteBits;
  for (int step = 0; step < 31; ++step) {
    const int mid = lo + (hi - lo) / 2;
    const float t = __int_as_float(mid);
    long long cnt[1] = {0};
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const float p = __fadd_rn(xs[i], t);
      int L = 0, H = np2;  // upper bound: entries ≤ p
      while (L < H) {
        const int M = (L + H) >> 1;
        if (xs[M] <= p) L = M + 1; else H = M;
      }
      const int c = min(L, m) - i - 1;
      if (c > 0) cnt[0] += c;
    }
    repro::block_sum(cnt, scratch);
    if (threadIdx.x == 0) *s_hi = cnt[0] >= kq;
    __syncthreads();
    if (*s_hi) hi = mid; else lo = mid + 1;
    __syncthreads();
  }
  const float kth = __int_as_float(hi);
  return __fmul_rn(kQnConstant, kth >= kBig ? 0.f : kth);
}

__global__ void __launch_bounds__(kThreads)
qn_kernel(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ w, int n, int np2, float* __restrict__ out) {
  extern __shared__ float smem[];  // a[n], b[n], xs[np2], then n validity bytes
  float* sa = smem;
  float* sb = smem + n;
  float* xs = smem + 2 * n;
  unsigned char* sw = reinterpret_cast<unsigned char*>(xs + np2);
  __shared__ long long scratch[repro::kMaxWarps];
  __shared__ int s_hi;
  const int r = blockIdx.x;
  const int m = load_row(a, b, w, static_cast<size_t>(r) * n, n, 2, sa, sb, sw);
  if (m < 2) {
    if (threadIdx.x == 0) out[r] = 0.f;
    return;
  }
  const long long h = m / 2 + 1;
  const long long kq = max(h * (h - 1) / 2, 1ll);
  const float inf = __int_as_float(0x7F800000);

  auto fill = [&](int which, float za, float zb) {
    // which: 0 → a, 1 → b, 2 → (a/za + b/zb)/√2, 3 → (a/za − b/zb)/√2
    for (int i = threadIdx.x; i < np2; i += blockDim.x) {
      float x = inf;
      if (i < n && sw[i]) {
        if (which == 0) {
          x = sa[i];
        } else if (which == 1) {
          x = sb[i];
        } else {
          const float az = __fdiv_rn(sa[i], za), bz = __fdiv_rn(sb[i], zb);
          x = __fmul_rn(which == 2 ? __fadd_rn(az, bz) : __fsub_rn(az, bz), kInvSqrt2);
        }
      }
      xs[i] = x;
    }
  };

  fill(0, 1.f, 1.f);
  const float qa = qn_scale(xs, np2, m, kq, scratch, &s_hi);
  fill(1, 1.f, 1.f);
  const float qb = qn_scale(xs, np2, m, kq, scratch, &s_hi);
  if (!(qa > 1e-12f && qb > 1e-12f)) {
    if (threadIdx.x == 0) out[r] = 0.f;
    return;
  }
  fill(2, qa, qb);
  const float qu = qn_scale(xs, np2, m, kq, scratch, &s_hi);
  fill(3, qa, qb);
  const float qv = qn_scale(xs, np2, m, kq, scratch, &s_hi);
  if (threadIdx.x == 0) {
    const float uu = __fmul_rn(qu, qu), vv = __fmul_rn(qv, qv);
    const float num = __fsub_rn(uu, vv), den = __fadd_rn(uu, vv);
    const float rr = den > 1e-12f ? __fdiv_rn(num, den) : 0.f;
    out[r] = fminf(fmaxf(rr, -1.f), 1.f);
  }
}

__global__ void __launch_bounds__(kThreads)
rank_transform_kernel(const float* __restrict__ x, const float* __restrict__ w, int n,
                      float* __restrict__ out) {
  __shared__ float tx[kThreads];
  __shared__ float tw[kThreads];
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  int any = 0;  // block-uniform
  for (int start = 0; start < n && !any; start += blockDim.x) {
    const int i = start + threadIdx.x;
    any = __syncthreads_or(i < n && w[base + i] != 0.f);
  }
  if (!any) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[base + i] = 0.f;
    return;
  }
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const float wi = i < n ? w[base + i] : 0.f;
    const float xi = wi != 0.f ? x[base + i] : 0.f;
    float less = 0.f, equal = 0.f;
    for (int j0 = 0; j0 < n; j0 += blockDim.x) {
      const int tile = min(static_cast<int>(blockDim.x), n - j0);
      __syncthreads();  // the previous tile has been read
      if (threadIdx.x < tile) {
        tx[threadIdx.x] = x[base + j0 + threadIdx.x];
        tw[threadIdx.x] = w[base + j0 + threadIdx.x];
      }
      __syncthreads();
      if (wi != 0.f) {
        for (int j = 0; j < tile; ++j) {
          const float xj = tx[j], wj = tw[j];
          if (xj < xi) {
            less = __fadd_rn(less, wj);
          } else if (xj == xi) {
            equal = __fadd_rn(equal, wj);
          }
        }
      }
    }
    if (i < n) {
      const float r = __fadd_rn(__fadd_rn(less, __fmul_rn(0.5f, equal)), 0.5f);
      out[base + i] = wi != 0.f ? __fmul_rn(r, wi) : 0.f;
    }
  }
}

}  // namespace

extern "C" int rank_transform_launch(const void* x, const void* w, int R, int n, void* out,
                                     void* stream) {
  rank_transform_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// table: the rankit table [(n+1)·(2n+1)] for kind 1 (rin), unused for kind 0.
extern "C" int rank_moments_launch(const void* a, const void* b, const void* w, int R, int n,
                                   int kind, const void* table, void* out, void* stream) {
  const size_t smem = static_cast<size_t>(n) * (2 * sizeof(float) + 1);
  rank_moments_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(w), n, kind, static_cast<const float*>(table),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qn_correlation_launch(const void* a, const void* b, const void* w, int R, int n,
                                     void* out, void* stream) {
  const int np2 = repro::next_pow2(n);
  const size_t smem = static_cast<size_t>(2 * n + np2) * sizeof(float) + n;
  qn_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(w), n, np2, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
