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
// joined (m ≥ 1 for ranks, m ≥ 2 for Qn); the rank sorts and the Qn
// bisection run only on those rows.
//
// rank_moments design. The pairwise rule walks all n slots for each of n
// values, n² compares a joined row whatever m is, so the old one-block-a-
// row kernel was bound by instruction issue at 28× its bytes. Here a row
// gets the team layout of qn_kernel below: two groups of K warps (K = 1 up
// to n = 256 with four rows a block, then 2, 4 and 8 up to MAX_N), the
// mask read by coalesced loads and __ballot_sync, so a row with m = 0
// writes its zeros having read its mask alone. Group 0 ranks a, group 1 b:
// each sorts its row's 32-bit keys once — the value's order-preserving
// bits, −0.0 made +0.0 first so the two tie — by the bitonic network of
// group_sort, one min or max a value and stage. Masked slots, NaNs and
// padding take the key ~0u, above every valid value (+inf included), so
// they never join a value's run. In sorted order a run of equal keys spans
// [first, last], found by head and tail flags and a max-/min-scan over
// lanes and warps, and its 2r = first + last + 2 is the pairwise rule's
// 2·#{x_j < x_i} + #{x_j = x_i} + 1, an exact integer (a NaN gets 1: it
// compares with nothing), so the rin lookup index m·(2n+1) + 2r is exact
// (the table is the host's float64 Φ⁻¹, as in the reference engine). Each
// slot's key finds its run by a branchless lower_bound over the sorted
// keys in shared memory. (A first version sorted 64-bit keys of value and
// slot instead and needed no search; its 64-bit compares and selects ran
// on the integer pipe at 1.5× this version's time.) Group 1 hands its 2r
// to group 0 by slot, and group 0 sums the moments: int64 for spearman
// (exact), float64 for rin (whose Σr is near 0, where float32 partial sums
// lose digits), each lane its slots in order and then a fixed tree, so the
// result is deterministic and one rounding from the exact sum. O(n log² n)
// a joined row in registers and shuffles, no block-wide barrier for a row
// that did not join.
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

// qn_correlation and rank_moments: a row's team is two groups of K warps,
// no block barrier.
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

// The same network over rank_moments' 32-bit keys: one min or max a value
// and stage. (Kept apart from the float network above, whose generated
// code Qn's timings rest on: sharing one template moved them.)
template <int K>
__device__ __forceinline__ void group_sort(uint32_t (&x)[kQnE], uint32_t* xs, int i0, int lane,
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
        const bool low = ((i0 & j) == 0) == ((i0 & k) == 0);
        uint32_t y[E];
#pragma unroll
        for (int s = 0; s < E; ++s) y[s] = xs[(i0 + s) ^ j];
#pragma unroll
        for (int s = 0; s < E; ++s) x[s] = low ? min(x[s], y[s]) : max(x[s], y[s]);
        group_sync<K>(bar);  // xs is written again by the next such stride
      } else if (j >= E) {
        const bool lower = (lane & (j / E)) == 0;
        uint32_t y[E];  // all shuffles first, so they overlap
#pragma unroll
        for (int s = 0; s < E; ++s) y[s] = __shfl_xor_sync(kFull, x[s], j / E);
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const bool low = lower == (((i0 + s) & k) == 0);
          x[s] = low ? min(x[s], y[s]) : max(x[s], y[s]);
        }
      } else {
#pragma unroll
        for (int s = 0; s < E; ++s) {
          if (s & j) continue;
          const uint32_t lo = x[s], hi = x[s | j];
          const bool up = ((i0 + s) & k) == 0;
          x[s] = up ? min(lo, hi) : max(lo, hi);
          x[s | j] = up ? max(lo, hi) : min(lo, hi);
        }
      }
    }
  }
}

// A row's mask as ballot words bits[0..nw): the row's 2K warps (w2 its
// warp in the team) take its words in turn, coalesced reads, 8 words in
// flight, each word a ballot. The row's barrier follows at the caller.
template <int K>
__device__ __forceinline__ void mask_words(const float* __restrict__ w, size_t base, int n,
                                           int nw, uint32_t* bits, int w2, int lane) {
  for (int w0 = w2; w0 < nw; w0 += 8 * 2 * K) {
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

  mask_words<K>(w, base, n, nw, bits, half * K + wi, lane);
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

// Shared memory of one rank_moments row's team, in 32-bit words: the
// mask's ballot words (to an even count), then for each group its sorted
// keys and the 2r of each sorted position (256K each), group 1's 2r by slot
// (256K), each group's cross-warp words (2K edge values, 2K scan carries),
// and group 0's per-warp partial sums (five 64-bit integers or doubles a
// warp, 8-byte aligned: every count before them is even).
__host__ __device__ inline int rm_row_words(int n, int K) {
  return (((n + 31) / 32 + 1) & ~1) + 2 * 2 * kQnWarpSlots * K + kQnWarpSlots * K + 2 * 4 * K +
         2 * 5 * K;
}

constexpr uint32_t kNoValue = 0xFFFFFFFFu;  // key of masked slots, NaNs, padding

// The sort key of a slot: the order-preserving bits of v (−0.0 as +0.0),
// or kNoValue for a masked slot, a NaN or padding — above every valid
// value, +inf included (0xFF800000).
__device__ __forceinline__ uint32_t rank_key(float v, bool valid) {
  if (!(valid && v == v)) return kNoValue;
  const uint32_t bits = __float_as_uint(v == 0.f ? 0.f : v);
  return (bits & 0x80000000u) ? ~bits : bits | 0x80000000u;
}

// One group's ranks: t2[s] = 2r of the lane's key[s] (1 for a NaN;
// anything for a masked slot). The group sorts a copy of its keys (lane l
// of warp w then holds sorted positions i0 + s, i0 = 256w + 8l), finds each
// run of equal keys [first, last] by head and tail flags and a max-/min-scan
// over lanes and warps, and stores the sorted keys (xs) and each
// position's 2r = first + last + 2 (rr); each key then finds its run's
// first position by a branchless lower_bound over xs. part: the group's 4K
// cross-warp words.
template <int K>
__device__ __forceinline__ void group_ranks(const uint32_t (&key)[kQnE], uint32_t* xs, int* rr,
                                            int* part, int wi, int lane, int bar,
                                            int (&t2)[kQnE]) {
  constexpr int E = kQnE, N = kQnWarpSlots * K;
  const int i0 = wi * kQnWarpSlots + lane * E;
  uint32_t x[E];
#pragma unroll
  for (int s = 0; s < E; ++s) x[s] = key[s];
  group_sort<K>(x, xs, i0, lane, bar);  // ends past the group's last read of xs
  // the keys before this lane's first position and after its last
  uint32_t pv = __shfl_up_sync(kFull, x[E - 1], 1);
  uint32_t nx = __shfl_down_sync(kFull, x[0], 1);
  if constexpr (K > 1) {
    uint32_t* edge = reinterpret_cast<uint32_t*>(part);  // [2K]: each warp's first, last
    if (lane == 0) edge[2 * wi] = x[0];
    if (lane == 31) edge[2 * wi + 1] = x[E - 1];
    group_sync<K>(bar);
    if (lane == 0 && wi > 0) pv = edge[2 * wi - 1];
    if (lane == 31 && wi < K - 1) nx = edge[2 * wi + 2];
  }
  // first[s]: the run's head, by a max-scan of head positions; last[s]: its
  // tail, by a min-scan from the right
  int first[E], last[E];
  int head = -1, tail = N;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    if (i0 + s == 0 || (s ? x[s - 1] : pv) != x[s]) head = i0 + s;
    first[s] = head;
  }
#pragma unroll
  for (int s = E - 1; s >= 0; --s) {
    if (i0 + s == N - 1 || (s < E - 1 ? x[s + 1] : nx) != x[s]) tail = i0 + s;
    last[s] = tail;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int h = __shfl_up_sync(kFull, head, d), t = __shfl_down_sync(kFull, tail, d);
    if (lane >= d) head = max(head, h);
    if (lane + d < 32) tail = min(tail, t);
  }
  int carry_h = __shfl_up_sync(kFull, head, 1), carry_t = __shfl_down_sync(kFull, tail, 1);
  if (lane == 0) carry_h = -1;
  if (lane == 31) carry_t = N;
  if constexpr (K > 1) {
    int* wh = part + 2 * K;  // [K] each warp's last head, [K] its first tail
    if (lane == 31) wh[wi] = head;
    if (lane == 0) wh[K + wi] = tail;
    group_sync<K>(bar);
    for (int v = 0; v < wi; ++v) carry_h = max(carry_h, wh[v]);
    for (int v = wi + 1; v < K; ++v) carry_t = min(carry_t, wh[K + v]);
  }
#pragma unroll
  for (int s = 0; s < E; ++s) {
    xs[i0 + s] = x[s];
    rr[i0 + s] = (first[s] < 0 ? carry_h : first[s]) + (last[s] == N ? carry_t : last[s]) + 2;
  }
  group_sync<K>(bar);
  // lower_bound of each key: the count of sorted keys below it, in log2 N
  // steps, the lane's eight loads of a step issued together
  int pos[E];
#pragma unroll
  for (int s = 0; s < E; ++s) pos[s] = 0;
#pragma unroll
  for (int half = N / 2; half > 0; half >>= 1) {
    uint32_t v[E];
#pragma unroll
    for (int s = 0; s < E; ++s) v[s] = xs[pos[s] + half - 1];
    __syncwarp();
#pragma unroll
    for (int s = 0; s < E; ++s) pos[s] += v[s] < key[s] ? half : 0;
  }
#pragma unroll
  for (int s = 0; s < E; ++s) t2[s] = key[s] == kNoValue ? 1 : rr[pos[s]];
}

// Group 0's five moment sums over its valid slots: its own 2r (t2) and
// group 1's (rkb, by slot), each mapped by `rank`; each lane its slots in
// order, then a fixed shuffle tree, then the group's warps in order through
// red, so the result is deterministic. res[k] = the sum × scale1 for the
// two first-order sums, × scale2 for the three products, rounded once.
template <int K, typename Acc, typename F>
__device__ __forceinline__ void moment_sums(const int (&t2)[kQnE], const bool (&ok)[kQnE],
                                            const int* rkb, Acc* red, int wi, int lane, int bar,
                                            F rank, float scale1, float scale2, float* res) {
  Acc sum[5] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < kQnE; ++s) {
    if (ok[s]) {
      const Acc ra = rank(t2[s]), rb = rank(rkb[(wi * kQnE + s) * 32 + lane]);
      sum[0] += ra;
      sum[1] += rb;
      sum[2] += ra * ra;
      sum[3] += rb * rb;
      sum[4] += ra * rb;
    }
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) sum[k] = repro::warp_sum(sum[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 5; ++k) red[wi * 5 + k] = sum[k];
  }
  group_sync<K>(bar);
  if (wi == 0 && lane < 5) {
    Acc t = 0;
    for (int u = 0; u < K; ++u) t += red[u * 5 + lane];
    res[lane] = static_cast<float>(t) * (lane < 2 ? scale1 : scale2);
  }
}

// One row a team of 2K warps: group 0 ranks a, group 1 ranks b, each lane
// the slots (8w + s)·32 + l of its warp w; group 1 hands its 2r to group 0
// by slot, and group 0 sums the moments. Team t of block x takes row
// t·G + x (G blocks): rows that join come in runs (a table's columns join
// together), and dealt this way a run spreads over many blocks and SMs
// instead of filling a few blocks.
template <int K>
__global__ void __launch_bounds__(64 * K * qn_rows(K))
rank_moments_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ w, int R, int n, int kind,
                    const float* __restrict__ table, float* __restrict__ out) {
  constexpr int E = kQnE, P = qn_rows(K), T = 32 * K;  // T: threads a group
  extern __shared__ unsigned long long rm_smem[];
  const int nw = (n + 31) / 32;
  const int team = threadIdx.x / (2 * T);
  const int half = (threadIdx.x / T) & 1;  // 0: a, 1: b
  const int wi = (threadIdx.x / 32) % K;   // warp in the group
  const int lane = threadIdx.x & 31;
  const int r = team * gridDim.x + blockIdx.x;
  if (r >= R) return;
  const int row_bar = 1 + team, bar = 1 + P + 2 * team + half;
  uint32_t* bits = reinterpret_cast<uint32_t*>(rm_smem) + team * rm_row_words(n, K);
  uint32_t* xs = bits + (((nw + 1) & ~1)) + half * 2 * kQnWarpSlots * K;  // this group's
  int* rr = reinterpret_cast<int*>(xs + kQnWarpSlots * K);
  int* rkb = reinterpret_cast<int*>(bits + (((nw + 1) & ~1)) + 4 * kQnWarpSlots * K);
  int* part = rkb + kQnWarpSlots * K + half * 4 * K;
  long long* red = reinterpret_cast<long long*>(rkb + kQnWarpSlots * K + 8 * K);
  const size_t base = static_cast<size_t>(r) * n;
  float* o = out + static_cast<size_t>(r) * 6;

  mask_words<K>(w, base, n, nw, bits, half * K + wi, lane);
  named_sync(row_bar, 2 * T);
  int m = 0;
  for (int wd = lane; wd < nw; wd += 32) m += __popc(bits[wd]);
  m = __reduce_add_sync(kFull, m);
  if (m == 0) {
    if (half == 0 && wi == 0 && lane < 6) o[lane] = 0.f;
    return;
  }
  // this group's keys: lane l of warp w takes slots (8w + s)·32 + l, so
  // each load is one coalesced row segment
  const float* src = half == 0 ? a : b;
  float v[E];
  bool ok[E];
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int wd = wi * E + s, j = wd * 32 + lane;
    ok[s] = j < n && (bits[wd] >> lane) & 1u;
    v[s] = ok[s] ? src[base + j] : 0.f;
  }
  uint32_t key[E];
#pragma unroll
  for (int s = 0; s < E; ++s) key[s] = rank_key(v[s], ok[s]);
  int t2[E];
  group_ranks<K>(key, xs, rr, part, wi, lane, bar, t2);
  if (half == 1) {
#pragma unroll
    for (int s = 0; s < E; ++s) {
      if (ok[s]) rkb[(wi * E + s) * 32 + lane] = t2[s];
    }
  }
  named_sync(row_bar, 2 * T);
  if (half == 1) return;

  if (kind == 1) {  // float64 sums of the rankits
    const float* tab = table + static_cast<size_t>(m) * (2 * n + 1);
    moment_sums<K, double>(t2, ok, rkb, reinterpret_cast<double*>(red), wi, lane, bar,
                           [tab](int t) { return static_cast<double>(tab[t]); }, 1.f, 1.f, o + 1);
  } else {  // exact int64 sums of 2r: Σ2r → Σr, Σ(2r)² → Σr² by a power of two
    moment_sums<K, long long>(t2, ok, rkb, red, wi, lane, bar,
                              [](int t) { return static_cast<long long>(t); }, 0.5f, 0.25f, o + 1);
  }
  if (wi == 0 && lane == 0) o[0] = static_cast<float>(m);
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
  const int K = n <= kQnWarpSlots ? 1 : n <= 2 * kQnWarpSlots ? 2 : n <= 4 * kQnWarpSlots ? 4 : 8;
  void (*kernel)(const float*, const float*, const float*, int, int, int, const float*, float*) =
      K == 1 ? rank_moments_kernel<1> : K == 2 ? rank_moments_kernel<2>
      : K == 4 ? rank_moments_kernel<4> : rank_moments_kernel<8>;
  const int P = qn_rows(K);
  const size_t smem = sizeof(uint32_t) * rm_row_words(n, K) * P;
  kernel<<<(R + P - 1) / P, 64 * K * P, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(w), R, n, kind, static_cast<const float*>(table),
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
