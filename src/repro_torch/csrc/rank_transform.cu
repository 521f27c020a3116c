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
// rank_moments design: one block per row, the row in shared memory. Ranks
// use the pairwise rule with integer counts, so 2·r is an exact integer and
// the rin lookup index m·(2n+1) + 2r is exact (the table is the host's
// float64 Φ⁻¹, as in the reference engine). Sums use a fixed reduction
// tree: results are deterministic. Rows with m = 0 exit after reading
// their mask, with the formula's value, zero.
//
// qn_correlation design. The Pallas kernel runs 31 full n × n count passes
// a scale; here a scale sorts the valid values once and each of the 31
// bisection probes over the float32 bit patterns counts the pairs with
// x_j ≤ x_i + t by searching the sorted values (the reference engine's
// formulation). On a joined row that is a chain of dependent steps, so
// what bounds the kernel is latency, then instruction issue when many rows
// join — not bytes or operations. Each row gets a team of two groups of K
// warps, a lane holding 8 values: K = 1 up to n = 256 (four rows a block),
// then 2, 4 and 8 up to MAX_N. The row's warps read its mask with coalesced
// loads and __ballot_sync; a row with m < 2 writes 0 and costs its mask
// alone, so blocks of unjoined rows retire at once and the block scheduler
// spreads the joined ones. Group 0 takes a and then u, group 1 b and then
// v: the two scales of a round run side by side and meet at one named
// barrier of the row. Inside a group there is no block barrier: a bitonic
// sort in registers and shuffles (and through shared memory between the
// group's warps for strides of 256 and up), per-probe counts by
// __reduce_add_sync on int32 (pair counts stay below 2²¹ at n ≤ 2048; at
// K > 1 the K warps' counts meet at one named barrier a probe), and lo/hi
// held alike by every lane. Each value keeps the bracket of its search
// position from the probes so far (qn_scale), so most probes settle a value
// with two loads; at K = 1 the last third of a bisection, once one pair
// alone decides it, runs in one lane's registers. The count predicate, the
// 31 steps over [0, max-finite], kq = max(h(h−1)/2, 1) with h = ⌊m/2⌋+1 and
// the correctly rounded epilogue are the twin's: the result is its order
// statistic, bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFiniteBits = 0x7F7FFFFF;
constexpr float kQnConstant = 2.21914f;
constexpr float kBig = 3.4e38f;
constexpr float kInvSqrt2 = 0.70710677f;  // float32(1/sqrt(2))

// Loads a row's validity into shared memory and returns m, its valid slots;
// loads the row's a and b as well only when m ≥ 1, so a row whose result
// is zero costs its mask alone. m is block-uniform.
__device__ int load_row(const float* a, const float* b, const float* w, size_t base, int n,
                        float* sa, float* sb, unsigned char* sw) {
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
  if (m == 0) return m;
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
  const int m = load_row(a, b, w, static_cast<size_t>(r) * n, n, sa, sb, sw);
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

// qn_correlation: a row's team is two groups of K warps, no block barrier.
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQnE = 8;                  // values a lane holds
constexpr int kQnWarpSlots = 32 * kQnE;  // 256: values a warp holds

// K: warps a scale, the least power of two with 256·K ≥ n (1 up to
// n = 256, 8 at MAX_N). Rows a block: 4 at K = 1 and 2 at K = 2 (256
// threads), 1 at K = 4 (256) and K = 8 (512).
__host__ __device__ constexpr int qn_rows(int K) { return K >= 4 ? 1 : 4 / K; }

// Barrier `id` of `threads` threads (named barriers 1..15; 0 is
// __syncthreads); orders their shared-memory writes as __syncthreads does.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Barrier of one scale's K warps.
template <int K>
__device__ __forceinline__ void group_sync(int id) {
  if constexpr (K == 1) __syncwarp(); else named_sync(id, 32 * K);
}

// Ascending bitonic sort of a group's 256·K values, lane l of warp w
// holding slots i0 + s, i0 = 256w + 8l, in x: strides below 8 swap in
// registers, below 256 trade with lane l ^ (j / 8) by shuffle, and larger
// ones trade through xs between the group's barriers. A pair whose compare
// is false (NaN) keeps its values, as a swap network does.
template <int K>
__device__ __forceinline__ void group_sort(float (&x)[kQnE], float* xs, int i0, int lane,
                                           int bar) {
  constexpr int E = kQnE;
#pragma unroll
  for (int k = 2; k <= kQnWarpSlots * K; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= kQnWarpSlots) {
#pragma unroll
        for (int s = 0; s < E; ++s) xs[i0 + s] = x[s];
        group_sync<K>(bar);
        const bool lower = (i0 & j) == 0, up = (i0 & k) == 0;
        float y[E];
#pragma unroll
        for (int s = 0; s < E; ++s) y[s] = xs[(i0 + s) ^ j];
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const bool take = lower == up ? y[s] < x[s] : y[s] > x[s];
          x[s] = take ? y[s] : x[s];
        }
        group_sync<K>(bar);  // xs is written again by the next such stride
      } else if (j >= E) {
        const bool lower = (lane & (j / E)) == 0;
        float y[E];  // all shuffles first, so they overlap
#pragma unroll
        for (int s = 0; s < E; ++s) y[s] = __shfl_xor_sync(kFull, x[s], j / E);
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const bool up = ((i0 + s) & k) == 0;
          const bool take = lower == up ? y[s] < x[s] : y[s] > x[s];
          x[s] = take ? y[s] : x[s];
        }
      } else {
#pragma unroll
        for (int s = 0; s < E; ++s) {
          if (s & j) continue;
          const float lo = x[s], hi = x[s | j];
          const bool swap = (lo > hi) == (((i0 + s) & k) == 0);
          x[s] = swap ? hi : lo;
          x[s | j] = swap ? lo : hi;
        }
      }
    }
  }
}

// 2.21914 · the kq-th smallest pairwise difference of the m ≥ 2 values in
// x (lane l of warp w holds slots i0 + s, +inf past m), computed by the
// scale's K warps: the least float32 bit pattern t in [0, max-finite] whose
// count of pairs i < j with x_j ≤ x_i + t reaches kq, by 31 bisection steps
// over the bit patterns. The group sorts x into xs[0..256K); xs[256K..512K)
// hold +inf. Each valid x_i keeps the bracket [A, B] of its search position
// (the count of values ≤ x_i + t) from the probes so far; the count is
// monotone in t, so a probe searches only inside the bracket. It first
// tests both ends (the position is A unless x_A ≤ x_i + t, and B if
// x_{B−1} ≤ x_i + t), which settles most values on probes far from the
// answer and every bracket of width 1; the rest walk [A+1, B−1] from A+1 in
// power-of-two strides, as many as the warp's widest such bracket needs. A
// lane's eight values go at a time, their loads issued together. A walk may
// read past B−1 into the +inf pad (2^steps ≤ 2·width) but never passes a
// value above x_i + t. A probe's count is one __reduce_add_sync, and at
// K > 1 a sum of the K warps' counts through `part` (two sets, by the
// step's parity, so one group barrier a probe suffices).
//
// At K = 1, once one bracket alone is open, and of width 1, every other
// position is fixed for all t left in [lo, hi], so the verdict of each
// remaining probe is that of one pair: x_A ≤ x_i + t. Its lane finishes the
// bisection in registers (often a third of the probes) and broadcasts hi.
template <int K>
__device__ float qn_scale(float (&x)[kQnE], float* xs, int* part, int m, int kq, int wi,
                          int lane, int bar) {
  constexpr int E = kQnE;
  const int i0 = wi * kQnWarpSlots + lane * E;
  group_sort<K>(x, xs, i0, lane, bar);
#pragma unroll
  for (int s = 0; s < E; ++s) xs[i0 + s] = x[s];
  group_sync<K>(bar);
  int lb[E], ub[E], pos[E];  // each value's bracket [A, B] and position
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const bool live = i0 + s < m;  // a dead slot keeps [1, 1]
    lb[s] = live ? i0 + s + 1 : 1;
    ub[s] = live ? m : 1;
    pos[s] = lb[s];
  }
  const bool busy = wi * kQnWarpSlots < m;  // the warp holds a valid slot
  int lo = 0, hi = kMaxFiniteBits;
  for (int step = 0; step < 31; ++step) {
    const int mid = lo + (hi - lo) / 2;
    const float t = __int_as_float(mid);
    int cnt = 0;
    if (busy) {
      float p[E], va[E], vb[E];
      int width = 0;
#pragma unroll
      for (int s = 0; s < E; ++s) {
        p[s] = __fadd_rn(x[s], t);
        va[s] = xs[lb[s]];
        vb[s] = xs[ub[s] - 1];
      }
      __syncwarp();  // a fence, as in the walk below: the loads issue together
#pragma unroll
      for (int s = 0; s < E; ++s) {
        const int A = lb[s], B = ub[s];
        const bool at_a = !(va[s] <= p[s]), at_b = vb[s] <= p[s];
        pos[s] = at_a ? A : at_b ? B : A + 1;
        width = max(width, at_a || at_b ? 0 : B - A - 2);
      }
      const int steps = __any_sync(kFull, width > 0)
          ? 32 - __clz(__reduce_max_sync(kFull, static_cast<unsigned>(width))) : 0;
      for (int half = (1 << steps) >> 1; half > 0; half >>= 1) {
        float v[E];
#pragma unroll
        for (int s = 0; s < E; ++s) v[s] = xs[pos[s] + half - 1];
        // no load moves past this fence, so the eight issue back to back and
        // their latencies overlap (else ptxas runs each compare chain alone)
        __syncwarp();
#pragma unroll
        for (int s = 0; s < E; ++s) pos[s] += v[s] <= p[s] ? half : 0;
      }
#pragma unroll
      for (int s = 0; s < E; ++s) {
        pos[s] = min(pos[s], ub[s]);
        if (i0 + s < m) cnt += pos[s] - i0 - s - 1;
      }
    }
    int total = __reduce_add_sync(kFull, cnt);  // all lanes agree
    if constexpr (K > 1) {
      int* mine = part + (step & 1) * K;
      if (lane == 0) mine[wi] = total;
      group_sync<K>(bar);
      total = __reduce_add_sync(kFull, lane < K ? mine[lane] : 0);
    }
    const bool hit = total >= kq;
    if (hit) hi = mid; else lo = mid + 1;
#pragma unroll
    for (int s = 0; s < E; ++s) {
      if (hit) ub[s] = pos[s]; else lb[s] = pos[s];
    }
    if constexpr (K == 1) {
      int n_open = 0, solo = 0;  // open brackets of this lane; the last one's slot
#pragma unroll
      for (int s = 0; s < E; ++s) {
        if (lb[s] < ub[s]) {
          n_open += ub[s] - lb[s];  // a bracket of width w counts w: > 1 unless solo
          solo = s;
        }
      }
      const unsigned owners = __ballot_sync(kFull, n_open > 0);
      if (__popc(owners) == 1 && !__any_sync(kFull, n_open > 1)) {
        // the one open pair: x_i (slot i) against x_A; without it the count
        // is total − 1 after a hit, total after a miss
        const int owner = __ffs(owners) - 1;
        if (lane == owner) {
          const int i = i0 + solo;
          int A = 0;
#pragma unroll
          for (int s = 0; s < E; ++s) A = s == solo ? lb[s] : A;
          const float xi = xs[i], xa = xs[A];
          const int base = hit ? total - 1 : total;
          for (++step; step < 31; ++step) {
            const int m2 = lo + (hi - lo) / 2;
            if (base + (xa <= __fadd_rn(xi, __int_as_float(m2)) ? 1 : 0) >= kq) hi = m2;
            else lo = m2 + 1;
          }
        }
        hi = __shfl_sync(kFull, hi, owner);
        break;
      }
    }
  }
  const float kth = __int_as_float(hi);
  return __fmul_rn(kQnConstant, kth >= kBig ? 0.f : kth);
}

// Shared memory of one row's team, in floats: the row's valid a and b
// values compacted (n each), the ballot words of the mask (nw), then for
// each scale group its sorted values and +inf pad (512K) and its probe
// counts (2K), then four exchange slots.
__host__ __device__ inline int qn_row_floats(int n, int K) {
  return 2 * n + (n + 31) / 32 + 2 * (2 * kQnWarpSlots * K + 2 * K) + 4;
}

// One row a team of 2K warps: group 0 takes a and then u, group 1 b and
// then v, meeting at the row's barrier between the rounds. The block
// scheduler hands out blocks as others retire, which spreads the joined
// rows (they come in runs) over the card.
template <int K>
__global__ void __launch_bounds__(64 * K * qn_rows(K))
qn_kernel(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ w, int R, int n, float* __restrict__ out) {
  constexpr int E = kQnE, P = qn_rows(K), T = 32 * K;  // T: threads a group
  extern __shared__ float smem[];
  const int nw = (n + 31) / 32;
  const int team = threadIdx.x / (2 * T);
  const int half = (threadIdx.x / T) & 1;     // 0: a then u, 1: b then v
  const int wi = (threadIdx.x / 32) % K;      // warp in the group
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * P + team;
  if (r >= R) return;
  const int row_bar = 1 + team, bar = 1 + P + 2 * team + half;
  float* va = smem + team * qn_row_floats(n, K);
  float* vb = va + n;
  uint32_t* bits = reinterpret_cast<uint32_t*>(vb + n);
  float* xs = vb + n + nw + half * (2 * kQnWarpSlots * K + 2 * K);
  int* part = reinterpret_cast<int*>(xs + 2 * kQnWarpSlots * K);
  float* slot = vb + n + nw + 2 * (2 * kQnWarpSlots * K + 2 * K);  // [round][half]
  const float inf = __int_as_float(0x7F800000);
  const size_t base = static_cast<size_t>(r) * n;

  // the mask: the row's 2K warps take its words in turn, coalesced reads,
  // 8 words in flight, each word a ballot
  for (int w0 = half * K + wi; w0 < nw; w0 += 8 * 2 * K) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = (w0 + u * 2 * K) * 32 + lane;
      v[u] = i < n ? w[base + i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (w0 + u * 2 * K < nw) {
        const unsigned word = __ballot_sync(kFull, v[u] > 0.f);
        if (lane == 0) bits[w0 + u * 2 * K] = word;
      }
    }
  }
  named_sync(row_bar, 2 * T);
  // m, and each word's first compacted slot: a warp scan of the words'
  // counts, two words a lane (nw ≤ 64)
  const int c0 = lane < nw ? __popc(bits[lane]) : 0;
  const int c1 = lane + 32 < nw ? __popc(bits[lane + 32]) : 0;
  int s0 = c0, s1 = c1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y0 = __shfl_up_sync(kFull, s0, d), y1 = __shfl_up_sync(kFull, s1, d);
    if (lane >= d) s0 += y0, s1 += y1;
  }
  const int t0 = __shfl_sync(kFull, s0, 31);
  const int m = t0 + __shfl_sync(kFull, s1, 31);
  const int off0 = s0 - c0, off1 = t0 + s1 - c1;  // this lane's words' first slots
  if (m < 2) {
    if (half == 0 && wi == 0 && lane == 0) out[r] = 0.f;
    return;
  }
  for (int i = kQnWarpSlots * K + wi * 32 + lane; i < 2 * kQnWarpSlots * K; i += T) xs[i] = inf;
  // this group's values at the valid slots, compacted in slot order
  const float* src = half == 0 ? a : b;
  float* mine = half == 0 ? va : vb;
  for (int w0 = wi; w0 < nw; w0 += 8 * K) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int wd = w0 + u * K;
      v[u] = (wd < nw && (bits[wd] >> lane) & 1u) ? src[base + wd * 32 + lane] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int wd = w0 + u * K;
      if (wd < nw) {
        const unsigned word = bits[wd];
        const int off = __shfl_sync(kFull, wd < 32 ? off0 : off1, wd & 31);
        if ((word >> lane) & 1u) mine[off + __popc(word & ((1u << lane) - 1u))] = v[u];
      }
    }
  }
  group_sync<K>(bar);
  const int h = m / 2 + 1;
  const int kq = max(h * (h - 1) / 2, 1);
  const int i0 = wi * kQnWarpSlots + lane * E;
  float x[E];
#pragma unroll
  for (int s = 0; s < E; ++s) x[s] = i0 + s < m ? mine[i0 + s] : inf;
  const float q = qn_scale<K>(x, xs, part, m, kq, wi, lane, bar);
  if (wi == 0 && lane == 0) slot[half] = q;
  named_sync(row_bar, 2 * T);
  const float qa = slot[0], qb = slot[1];
  if (!(qa > 1e-12f && qb > 1e-12f)) {
    if (half == 0 && wi == 0 && lane == 0) out[r] = 0.f;
    return;
  }
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int i = i0 + s;
    if (i < m) {
      const float az = __fdiv_rn(va[i], qa), bz = __fdiv_rn(vb[i], qb);
      x[s] = __fmul_rn(half == 0 ? __fadd_rn(az, bz) : __fsub_rn(az, bz), kInvSqrt2);
    } else {
      x[s] = inf;
    }
  }
  const float q2 = qn_scale<K>(x, xs, part, m, kq, wi, lane, bar);
  if (wi == 0 && lane == 0) slot[2 + half] = q2;
  named_sync(row_bar, 2 * T);
  if (half == 0 && wi == 0 && lane == 0) {
    const float qu = slot[2], qv = slot[3];
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
  const int K = n <= kQnWarpSlots ? 1 : n <= 2 * kQnWarpSlots ? 2 : n <= 4 * kQnWarpSlots ? 4 : 8;
  void (*kernel)(const float*, const float*, const float*, int, int, float*) =
      K == 1 ? qn_kernel<1> : K == 2 ? qn_kernel<2> : K == 4 ? qn_kernel<4> : qn_kernel<8>;
  const int P = qn_rows(K);
  const size_t smem = sizeof(float) * qn_row_floats(n, K) * P;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(R + P - 1) / P, 64 * K * P, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(w), R, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
