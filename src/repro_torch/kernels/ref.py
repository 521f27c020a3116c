"""Plain PyTorch twins of the port's CUDA kernels.

Each function here computes what its kernel computes, with ordinary tensor
operations. They are the CPU path of `repro_torch.kernels.ops` and the
oracle the kernels are held against on the card; the tests hold them
against the JAX package's oracles. Masks are 0/1: a slot is valid where its
mask is > 0.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import hashing


#: float32 3.4e38, the reference's 'vacuous bound' sentinel
_BIG = float(np.float32(3.4e38))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(x, idx, dim=-1)


# ----------------------------------------------------------------------------
# sketch_join: key intersection + paired moments
# ----------------------------------------------------------------------------

def sketch_join_moments_batched(q_kh, q_val, q_mask, c_kh, c_val, c_mask,
                                with_aligned: bool = True):
    """Intersect each query sketch (``q_* [B, nq]``, keys as int32 bit
    patterns) with every candidate sketch (``c_* [C, n]``) and return

      mom      f32[B, C, 6] = (m, Σa, Σb, Σa², Σb², Σab) over matched pairs
      aligned  f32[B, C, nq]: Σ of candidate values whose key equals query
               slot i's key (one value: keys are distinct in a sketch)
      hit      f32[B, C, nq]: 1 where query slot i matched

    with a = query value · hit and b = aligned; ``aligned``/``hit`` are
    None unless ``with_aligned``. Each candidate's valid keys are sorted
    once and every query key binary-searches them."""
    B, nq = q_kh.shape
    C, n = c_kh.shape
    invalid = 1 << 32   # above every hash: invalid slots never match
    ck = torch.where(c_mask > 0, hashing.from_pattern(c_kh), invalid)
    ck_s, perm = torch.sort(ck, dim=-1)
    cv_s = _take(c_val, perm)
    probe = hashing.from_pattern(q_kh).reshape(1, B * nq).expand(C, B * nq)
    probe = probe.contiguous()
    lo = torch.searchsorted(ck_s, probe)
    count = torch.searchsorted(ck_s, probe, right=True) - lo
    aligned = torch.zeros((C, B * nq), dtype=torch.float32, device=c_val.device)
    for k in range(int(count.max()) if count.numel() else 0):
        pos = torch.clamp(lo + k, max=n - 1)
        aligned += torch.where(k < count, _take(cv_s, pos), 0.0)
    qm = (q_mask > 0)[:, None, :]
    hit = ((count > 0).reshape(C, B, nq).transpose(0, 1) & qm).to(torch.float32)
    aligned = torch.where(qm, aligned.reshape(C, B, nq).transpose(0, 1), 0.0)
    a = q_val[:, None, :] * hit
    mom = torch.stack([hit.sum(-1), a.sum(-1), aligned.sum(-1),
                       (a * a).sum(-1), (aligned * aligned).sum(-1),
                       (a * aligned).sum(-1)], dim=-1)
    if not with_aligned:
        return mom, None, None
    return mom, aligned.contiguous(), hit.contiguous()



def sketch_join_moments(q_kh, q_val, q_mask, c_kh, c_val, c_mask):
    """Single-query twin: ``q_* [nq]`` against ``c_* [C, n]`` → (mom
    [C, 6], aligned [C, nq], hit [C, nq]), the batched twin's row."""
    mom, aligned, hit = sketch_join_moments_batched(
        q_kh[None], q_val[None], q_mask[None], c_kh, c_val, c_mask)
    return mom[0], aligned[0], hit[0]


# ----------------------------------------------------------------------------
# containment: exact key-intersection counts (stage 1)
# ----------------------------------------------------------------------------

#: probe elements a containment step holds (bounds its [chunk, B·nq] tensors)
_CONTAINMENT_CHUNK = 1 << 22


def containment_hits_batched(q_kh, q_mask, c_kh, c_mask):
    """Per query row (``q_* [B, nq]``, keys as int32 bit patterns) and
    candidate (``c_* [C, n]``):

      hits f32[B, C] = |{(i, j) : q_kh[b, i] == c_kh[c, j], both valid}|

    — with keys distinct in a sketch, the intersection size of the two
    stored key sets, i.e. the sketch-join sample size m. Each candidate's
    valid keys are sorted and every valid query slot counts its equal keys;
    candidates go in chunks so the probe tensors stay bounded."""
    B, nq = q_kh.shape
    C, n = c_kh.shape
    dev = c_kh.device
    invalid = 1 << 32   # above every hash: invalid slots never match
    ck_s = torch.sort(torch.where(c_mask > 0, hashing.from_pattern(c_kh),
                                  invalid), dim=-1).values
    probe = hashing.from_pattern(q_kh).reshape(1, B * nq)
    qv = (q_mask > 0).reshape(1, B * nq)
    out = torch.zeros((C, B), dtype=torch.float32, device=dev)
    step = max(1, _CONTAINMENT_CHUNK // max(B * nq, 1))
    for s in range(0, C if B * nq else 0, step):
        blk = ck_s[s:s + step]
        pr = probe.expand(blk.shape[0], B * nq).contiguous()
        cnt = (torch.searchsorted(blk, pr, right=True)
               - torch.searchsorted(blk, pr))
        cnt = torch.where(qv, cnt, 0).reshape(-1, B, nq).sum(-1)
        out[s:s + step] = cnt.to(torch.float32)
    return out.T.contiguous()


def containment_hits(q_kh, q_mask, c_kh, c_mask):
    """Single-query twin: ``q_* [nq]`` against ``c_* [C, n]`` → hits
    f32[C], the batched twin's row."""
    return containment_hits_batched(q_kh[None], q_mask[None], c_kh, c_mask)[0]


def pearson_from_moments(moments):
    """Pearson r per candidate from the 6 accumulated moments."""
    m, sa, sb, saa, sbb, sab = moments.unbind(-1)
    msafe = torch.clamp(m, min=1.0)
    mu_a, mu_b = sa / msafe, sb / msafe
    cov = sab / msafe - mu_a * mu_b
    va = torch.clamp(saa / msafe - mu_a ** 2, min=0.0)
    vb = torch.clamp(sbb / msafe - mu_b ** 2, min=0.0)
    den = torch.sqrt(va) * torch.sqrt(vb)
    ok = (m >= 2) & (den > 1e-12)
    return torch.where(ok, cov / torch.where(ok, den, 1.0), 0.0)


def hoeffding_from_moments(moments, c_low, c_high, alpha=0.05):
    """§4.3 CI bounds from raw moments, the variables shifted into [0, C]
    analytically: returns (lo, hi) per candidate. ``alpha`` is taken in
    float32, as the reference's request operand is."""
    m, sa, sb, saa, sbb, sab = moments.unbind(-1)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=m.device)
    msafe = torch.clamp(m, min=1.0)
    mu_a = sa / msafe - c_low
    mu_b = sb / msafe - c_low
    va = saa / msafe - 2.0 * c_low * (sa / msafe) + c_low ** 2
    vb = sbb / msafe - 2.0 * c_low * (sb / msafe) + c_low ** 2
    vab = sab / msafe - c_low * (sa / msafe) - c_low * (sb / msafe) + c_low ** 2
    C = torch.clamp(c_high - c_low, min=1e-30)
    log_term = torch.log(10.0 / alpha)
    t = torch.sqrt(log_term * C * C / (2.0 * msafe))
    # C⁴ as two squarings, as the reference's integer power computes it:
    # torch's pow(C, 4) rounds differently in its vector body and its
    # scalar tail, so a candidate's bound would depend on its position
    tp = torch.sqrt(log_term * ((C * C) * (C * C)) / (2.0 * msafe))
    num_lo = (vab - tp) - (mu_a + t) * (mu_b + t)
    num_hi = (vab + tp) - (mu_a - t) * (mu_b - t)
    den_lo = torch.sqrt(torch.clamp((va - tp) - (mu_a + t) ** 2, min=0.0)
                        * torch.clamp((vb - tp) - (mu_b + t) ** 2, min=0.0))
    den_hi = torch.sqrt(torch.clamp((va + tp) - (mu_a - t) ** 2, min=0.0)
                        * torch.clamp((vb + tp) - (mu_b - t) ** 2, min=0.0))
    sden = torch.sqrt(torch.clamp(va - mu_a ** 2, min=0.0)
                      * torch.clamp(vb - mu_b ** 2, min=0.0))
    degenerate = (den_lo <= 1e-30) | (den_hi <= 1e-30)
    den_lo = torch.where(degenerate, sden, den_lo)
    den_hi = torch.where(degenerate, sden, den_hi)

    def _div(num, den):
        return num / torch.clamp(den, min=1e-30)

    lo = torch.where(num_lo >= 0, _div(num_lo, den_hi), _div(num_lo, den_lo))
    hi = torch.where(num_hi >= 0, _div(num_hi, den_lo), _div(num_hi, den_hi))
    ok = m >= 2
    return torch.where(ok, lo, -_BIG), torch.where(ok, hi, _BIG)


# ----------------------------------------------------------------------------
# rank_moments: masked midranks → sufficient statistics
# ----------------------------------------------------------------------------

def _ndtri64(q: np.ndarray) -> np.ndarray:
    """Float64 inverse normal CDF on the host (scipy when present, else
    Acklam's rational approximation — |rel err| < 1.15e-9, which rounds to
    the correct float32 everywhere it is used)."""
    try:
        from scipy.special import ndtri
        return ndtri(q)
    except ImportError:
        pass
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    q = np.asarray(q, np.float64)
    lo, hi = 0.02425, 1.0 - 0.02425
    ql = np.sqrt(-2.0 * np.log(np.clip(q, 1e-300, None)))
    qh = np.sqrt(-2.0 * np.log(np.clip(1.0 - q, 1e-300, None)))
    poly = lambda cs, x: functools.reduce(lambda acc, ci: acc * x + ci, cs)
    tail = lambda t: (poly(c, t) / (poly(d, t) * t + 1.0))
    r = q - 0.5
    s = r * r
    mid = (poly(a, s) * r) / (poly(b, s) * s + 1.0)
    return np.where(q < lo, tail(ql), np.where(q > hi, -tail(qh), mid))


@functools.lru_cache(maxsize=None)
def _rankit_table(n: int) -> np.ndarray:
    """Rankit lookup table of the ``kind='rin'`` transform, flattened
    ``[(n+1)·(2n+1)] f32``: entry ``m·(2n+1) + 2·rank`` holds
    ``Φ⁻¹(clip((rank − ½)/max(m, 1), 1e-6, 1 − 1e-6))``, computed in
    float64 on the host (ranks are half-integers ≤ n, m an integer ≤ n)."""
    m = np.maximum(np.arange(n + 1, dtype=np.float64), 1.0)[:, None]
    half = (np.arange(2 * n + 1, dtype=np.float64)[None, :] - 1.0) / 2.0
    q = np.clip(half / m, 1e-6, 1.0 - 1e-6)
    return _ndtri64(q).astype(np.float32).ravel()


@functools.lru_cache(maxsize=None)
def rankit_table(n: int, device: torch.device) -> torch.Tensor:
    """`_rankit_table` as a tensor on ``device`` (the rin kernel reads it)."""
    return torch.from_numpy(_rankit_table(n)).to(device)


def _twice_ranks(x, valid):
    """2 × masked midrank as an exact integer: ``2·#{x_j < x_i} +
    #{x_j = x_i} + 1`` over valid j (sort + two binary searches)."""
    xv = torch.where(valid, x, float("inf"))
    xs = torch.sort(xv, dim=-1).values
    return (torch.searchsorted(xs, xv) + torch.searchsorted(xs, xv, right=True)
            + 1)


def rank_moments(a, b, mask, kind: str = "spearman"):
    """Masked midranks of ``a`` and ``b`` per row (``kind='rin'``:
    rankit-transformed through `_rankit_table`), reduced to
    ``[m, Σrₐ, Σr_b, Σrₐ², Σr_b², Σrₐr_b]``. a, b, mask f32[..., n] →
    f32[..., 6]. Rows without valid slots give zeros."""
    if kind not in ("spearman", "rin"):
        raise ValueError(f"unknown rank_moments kind: {kind!r}")
    lead, n = a.shape[:-1], a.shape[-1]
    a2, b2 = a.reshape(-1, n), b.reshape(-1, n)
    w2 = mask.reshape(-1, n) > 0
    m = w2.sum(-1)
    out = torch.zeros((a2.shape[0], 6), dtype=torch.float32, device=a.device)
    live = torch.nonzero(m > 0).squeeze(-1)
    w, ml = w2[live], m[live]
    ta, tb = _twice_ranks(a2[live], w), _twice_ranks(b2[live], w)
    if kind == "rin":
        tab = rankit_table(n, a.device)
        base = (ml * (2 * n + 1))[:, None]
        ra = torch.where(w, tab[base + ta], 0.0)
        rb = torch.where(w, tab[base + tb], 0.0)
    else:
        ra = torch.where(w, ta.to(torch.float32) * 0.5, 0.0)
        rb = torch.where(w, tb.to(torch.float32) * 0.5, 0.0)
    out[live] = torch.stack([ml.to(torch.float32), ra.sum(-1), rb.sum(-1),
                             (ra * ra).sum(-1), (rb * rb).sum(-1),
                             (ra * rb).sum(-1)], dim=-1)
    return out.reshape(*lead, 6)


# ----------------------------------------------------------------------------
# rank_transform: weighted midranks
# ----------------------------------------------------------------------------

#: elements of one [rows, n, n] compare tensor of `rank_transform`
_RANK_CHUNK = 1 << 24


def rank_transform(x, mask):
    """Per row, ``rank_i = (Σ_j w_j[x_j < x_i] + ½ Σ_j w_j[x_j = x_i] + ½)
    · w_i`` with weights ``w = mask``: for a 0/1 mask, the average rank
    (ties share their mean rank) among the valid entries, 0 in masked
    slots. NaNs compare false, so a NaN gets rank ½ and counts for no one.
    x, mask f32[R, n] → f32[R, n]. Rows without a nonzero weight are zeros
    and skipped; the others go in chunks that bound the pairwise compare
    tensor."""
    R, n = x.shape
    w = mask.to(torch.float32)
    out = torch.zeros((R, n), dtype=torch.float32, device=x.device)
    live = torch.nonzero((w != 0).any(-1)).squeeze(-1)
    step = max(1, _RANK_CHUNK // max(n * n, 1))
    for s in range(0, live.shape[0], step):
        rows = live[s:s + step]
        xs, ws = x[rows], w[rows]
        wj = ws[:, None, :]
        less = torch.where(xs[:, None, :] < xs[:, :, None], wj, 0.0).sum(-1)
        equal = torch.where(xs[:, None, :] == xs[:, :, None], wj, 0.0).sum(-1)
        out[rows] = (less + 0.5 * equal + 0.5) * ws
    return out


# ----------------------------------------------------------------------------
# qn_correlation: Shevlyakov–Oja robust correlation, sort + bisection
# ----------------------------------------------------------------------------

#: bit pattern of the largest finite float32
MAX_FINITE_BITS = int(np.float32(np.finfo(np.float32).max).view(np.int32))
QN_CONSTANT = float(np.float32(2.21914))


def _qn_scale_rows(x, valid):
    """Per-row Qn scale: 2.21914 · the kq-th smallest valid pairwise
    difference, h = ⌊m/2⌋+1, kq = max(h(h−1)/2, 1). The row is sorted once;
    31 bisection steps over the bit patterns of non-negative float32 each
    count the pairs with ``x_j ≤ x_i + t`` by binary search."""
    R, n = x.shape
    xs = torch.sort(torch.where(valid, x, float("inf")), dim=-1).values
    m = valid.sum(-1)
    h = m // 2 + 1
    kq = torch.clamp(h * (h - 1) // 2, min=1)
    idx = torch.arange(n, device=x.device)
    ivalid = idx[None, :] < m[:, None]
    lo = torch.zeros(R, dtype=torch.int32, device=x.device)
    hi = torch.full((R,), MAX_FINITE_BITS, dtype=torch.int32, device=x.device)
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        t = mid.view(torch.float32)
        probe = torch.where(ivalid, xs + t[:, None], float("-inf"))
        pos = torch.searchsorted(xs, probe, right=True)
        c = torch.clamp(torch.minimum(pos, m[:, None]) - idx - 1, min=0)
        hit = c.sum(-1) >= kq
        lo = torch.where(hit, lo, mid + 1)
        hi = torch.where(hit, mid, hi)
    kth = hi.view(torch.float32)
    # kq beyond the valid pair count leaves hi at max-finite → scale 0
    return torch.where(kth >= _BIG, 0.0, kth) * QN_CONSTANT


def qn_correlation(a, b, mask):
    """Per-row Qn robust correlation (Shevlyakov & Oja): scales of a and b
    standardise them, then r = (Qn(u)² − Qn(v)²)/(Qn(u)² + Qn(v)²) for
    u, v = (a_z ± b_z)/√2. Degenerate scales give 0; r is clipped to
    [−1, 1]. a, b, mask f32[..., n] → f32[...]. Rows with fewer than two
    valid slots give 0 and are skipped."""
    lead, n = a.shape[:-1], a.shape[-1]
    a2, b2 = a.reshape(-1, n), b.reshape(-1, n)
    w2 = mask.reshape(-1, n) > 0
    out = torch.zeros(a2.shape[0], dtype=torch.float32, device=a.device)
    live = torch.nonzero(w2.sum(-1) >= 2).squeeze(-1)
    a2, b2, w = a2[live], b2[live], w2[live]
    R = a2.shape[0]
    ww = torch.cat([w, w])
    s = _qn_scale_rows(torch.cat([a2, b2]), ww)
    sa, sb = s[:R], s[R:]
    ok = (sa > 1e-12) & (sb > 1e-12)
    az = a2 / torch.where(ok, sa, 1.0)[:, None]
    bz = b2 / torch.where(ok, sb, 1.0)[:, None]
    inv_sqrt2 = float(np.float32(1.0 / np.sqrt(2.0)))
    q = _qn_scale_rows(torch.cat([(az + bz) * inv_sqrt2,
                                  (az - bz) * inv_sqrt2]), ww)
    qu, qv = q[:R], q[R:]
    num = qu * qu - qv * qv
    den = qu * qu + qv * qv
    r = torch.where(den > 1e-12, num / torch.where(den > 1e-12, den, 1.0), 0.0)
    out[live] = torch.clamp(torch.where(ok, r, 0.0), -1.0, 1.0)
    return out.reshape(lead)



# ----------------------------------------------------------------------------
# postings: merge gathered window ids, select the eligible union
# ----------------------------------------------------------------------------

_I32_MAX = int(np.iinfo(np.int32).max)


def postings_merge(cand, C: int):
    """Merge the column ids gathered from postings windows (``cand`` i32
    ``[B, L]``, ids in [0, C), −1 in non-matching slots) into per-column
    hit counts: ``(cols i32[B, L], counts f32[B, L])`` with each row's
    distinct ids ≥ 0 ascending at the front, each with its multiplicity
    (the exact key-intersection size), then (−1, 0). The reference's
    contract is set equality per row; this layout is also the CUDA
    kernel's. ``C`` bounds the ids (checked; the kernel marks them in a
    C-bit bitmap a row) and does not change the result."""
    if bool((cand >= int(C)).any()):
        raise ValueError(f"postings_merge: an id is ≥ the column count C={int(C)}")
    B, L = cand.shape
    s = torch.sort(torch.where(cand < 0, _I32_MAX, cand), dim=-1).values
    head = torch.ones_like(s, dtype=torch.bool)
    head[:, 1:] = s[:, 1:] != s[:, :-1]
    head &= s != _I32_MAX
    cnt = (torch.searchsorted(s, s, right=True)
           - torch.searchsorted(s, s)).to(torch.float32)
    # run heads, id-ascending, to the front of the row
    order = torch.sort((~head).to(torch.int8), dim=-1, stable=True).indices
    cols = torch.where(head, s, -1).gather(-1, order)
    counts = torch.where(head, cnt, 0.0).gather(-1, order)
    return cols.to(torch.int32), counts


def postings_select(cols, counts, floor, M: int):
    """Survivor selection over merged postings rows: the union across all
    rows of the ids with ``cols ≥ 0`` and ``counts ≥ floor`` (float32),
    ascending, into a fixed rung of M slots → ``(surv i32[M], valid
    bool[M], n_surv i32[])``. ``surv`` holds the first min(n_surv, M)
    survivors with zeros beyond, ``valid`` flags them, and ``n_surv``
    counts every eligible id — n_surv > M means the rung overflowed and
    holds the M smallest ids."""
    dev = cols.device
    floor = torch.tensor(float(np.float32(floor)), dtype=torch.float32)
    elig = (cols >= 0) & (counts >= floor.to(dev))
    ids = torch.unique(cols[elig].to(torch.int64), sorted=True)
    n_surv = int(ids.shape[0])
    kept = min(n_surv, int(M))
    surv = torch.zeros((int(M),), dtype=torch.int32, device=dev)
    surv[:kept] = ids[:kept].to(torch.int32)
    valid = torch.arange(int(M), device=dev) < kept
    return surv, valid, torch.tensor(n_surv, dtype=torch.int32, device=dev)


# ----------------------------------------------------------------------------
# hash_build: murmur3 + Fibonacci + unit interval of 32-bit keys
# ----------------------------------------------------------------------------

def hash_build(keys):
    """Elementwise over 32-bit keys (``keys`` i32, the key's bit pattern,
    any shape): h = murmur3-32 of one 4-byte block (seed 0x9747B28C),
    fib = h · 2654435769 mod 2³², unit = f32(fib) · 2⁻³² →
    ``(h i32, fib i32, unit f32)``, h and fib as their int32 bit patterns
    (`hashing.from_pattern` gives the int64 values)."""
    if keys.dtype != torch.int32:
        raise TypeError(f"hash_build takes int32 key patterns, not {keys.dtype}")
    h = hashing.murmur3_32(keys)
    fib = hashing.fibonacci_u32(h)
    return (hashing.to_pattern(h), hashing.to_pattern(fib),
            hashing.unit_interval(fib))


# ----------------------------------------------------------------------------
# flash_attention: causal / sliding-window GQA attention (forward)
# ----------------------------------------------------------------------------

def _attention_keep(Lq: int, Lk: int, causal: bool, window: int, device):
    """The [Lq, Lk] mask of the (query, key) pairs attention keeps: queries
    right-aligned (query i at Lk − Lq + i), ``causal`` keys at or before
    it, ``window > 0`` the last ``window`` of those."""
    qpos = torch.arange(Lq, device=device)[:, None] + (Lk - Lq)
    kpos = torch.arange(Lk, device=device)[None, :]
    keep = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        keep &= kpos <= qpos
    if window > 0:
        keep &= kpos > qpos - window
    return keep


def _attention_probs(q, k, causal: bool, window: int):
    """(P [B, Hq, Lq, Lk] f32, K repeated over the group [B, Hq, Lk, D] f32):
    the softmax of the masked logits, 0 in a row with no key left."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    kq = k.to(torch.float32).repeat_interleave(Hq // Hkv, dim=1)
    logits = torch.matmul(q.to(torch.float32), kq.transpose(-1, -2)) * (1.0 / np.sqrt(D))
    keep = _attention_keep(Lq, Lk, causal, window, q.device)
    p = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.nan_to_num(p, nan=0.0), kq  # rows with every key masked


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, Hq, Lq, D], k and v [B, Hkv, Lk, D] (any strides; f32 or bf16,
    each on its own) → [B, Hq, Lq, D] in q's dtype. Query head h reads KV
    head h // (Hq // Hkv); logits scale 1/√D; positions are right-aligned
    (query i sits at Lk − Lq + i), so ``causal`` keeps keys at or before
    it and ``window > 0`` keeps the last ``window`` of those. Logits,
    softmax and sums in f32; a row with no key left gives 0."""
    p, _ = _attention_probs(q, k, causal, window)
    vq = v.to(torch.float32).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return torch.matmul(p, vq).to(q.dtype)


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True, window: int = 0):
    """The gradient of `flash_attention` (same masks and layouts): given its
    output ``o`` [B, Hq, Lq, D] and the gradient ``do`` of the loss with
    respect to it, returns (dq, dk, dv) in q's, k's and v's dtypes. In
    f32: P recomputed; dV = Σ_group Pᵀ·dO; dP = dO·Vᵀ; Dᵢ = rowsum(dO ∘ O);
    dS = P ∘ (dP − D); dQ = dS·K/√D; dK = Σ_group dSᵀ·Q/√D. A row with no
    key left has P = 0, so it gets zero gradients and gives none."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    f32 = torch.float32
    p, kq = _attention_probs(q, k, causal, window)
    vq = v.to(f32).repeat_interleave(group, dim=1)
    do32 = do.to(f32)
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, vq.transpose(-1, -2))
    ds = p * (dp - (do32 * o.to(f32)).sum(-1, keepdim=True))
    scale = 1.0 / np.sqrt(D)
    dq = torch.matmul(ds, kq) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(f32)) * scale
    fold = lambda t: t.reshape(B, Hkv, group, Lk, D).sum(2)
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)
