"""Joinability estimation from stored bottom-k key minima (paper §2.1/§3.3).

The KMV synopsis inside every correlation sketch answers *joinability*
questions without touching the value columns: the stored key-hash minima of
a query column Q and a candidate column C give

* the **exact sketch-intersection size** ``hits = |keys(L_Q) ∩ keys(L_C)|``
  — the sketch-join sample size ``m`` the scoring path bounds its
  eligibility on;
* a **containment estimate** ``ĉ(Q→C) ≈ |K_Q ∩ K_C| / |K_Q|``: a query
  minimum whose Fibonacci hash lies at or below the candidate's KMV
  threshold ``τ_C`` is an exact membership probe (the candidate sketch holds
  every key with ``h_u ≤ τ_C``), and the query minima are a uniform sample of
  K_Q, so ``ĉ = hits / probes`` is a Bernoulli mean with the Hoeffding CI of
  `repro_torch.core.bounds.containment_ci`;
* **Jaccard** and **join-size** estimates through the distinct-value
  estimator D̂ = (k−1)/U(k) (Beyer et al., §2.1).

Everything here is host numpy on O(C) scalars per candidate (never the
``[C, n]`` sketch payload); the hit counts come from the stage-1 candidate
sources (`repro_torch.engine.candidates`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import bounds
from repro_torch.core.hashing import FIBONACCI_MULTIPLIER

#: re-exported for callers choosing a safe prune floor (DESIGN.md §5)
hoeffding_eligibility_floor = bounds.hoeffding_eligibility_floor


def fib_u32_np(key_hash: np.ndarray) -> np.ndarray:
    """Numpy Fibonacci hash ``h_u`` as raw ``uint32`` (the KMV order) of
    32-bit key hashes (``uint32``, or ``int32`` bit patterns)."""
    with np.errstate(over="ignore"):
        kh = np.asarray(key_hash).astype(np.uint32)
        return (kh * np.uint32(FIBONACCI_MULTIPLIER)).astype(np.uint32)


def distinct_from_minima(count: np.ndarray, tau: np.ndarray,
                         n: int) -> np.ndarray:
    """Beyer et al. distinct-value estimate D̂ from a bottom-k state (§2.1).

    ``count`` is the number of stored minima (k), ``tau`` the k-th smallest
    Fibonacci value as raw uint32 (``U(k) = tau / 2^32``). A sketch that is
    not full (count < n) holds every key of its column, so D̂ is exact
    there; a full sketch uses the unbiased (k−1)/U(k) estimator."""
    count = np.asarray(count, np.float32)
    u = np.asarray(tau, np.uint32).astype(np.float64) / 4294967296.0
    est = (count - 1.0) / np.maximum(u, 1e-30)
    return np.where(count >= n, est, count).astype(np.float32)


def probe_counts(q_fib_sorted: np.ndarray, cand_count: np.ndarray,
                 cand_tau: np.ndarray, n: int) -> np.ndarray:
    """Per-candidate number of query minima that are exact membership
    probes: all k_Q of them for a candidate that is not full (it holds all
    of K_C), else those with ``h_u ≤ τ_C``. Every match satisfies
    ``h_u ≤ τ_C``, hence ``hits ≤ probes``."""
    kq = int(q_fib_sorted.shape[0])
    below = np.searchsorted(q_fib_sorted, np.asarray(cand_tau, np.uint32),
                            side="right").astype(np.int32)
    return np.where(np.asarray(cand_count) >= n, below,
                    np.int32(kq)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class JoinabilityEstimates:
    """Per-candidate joinability statistics (§3.3), arrays shaped like
    ``hits``: ``hits`` is exact; ``containment`` carries the Hoeffding CI
    ``[ci_lo, ci_hi]``; ``jaccard`` / ``join_size`` go through the D̂
    estimates; ``probes`` is the Bernoulli sample size behind the CI."""
    hits: np.ndarray          # f32, exact |keys(L_Q) ∩ keys(L_C)|
    probes: np.ndarray        # i32, membership trials behind the estimate
    containment: np.ndarray   # f32, ĉ(Q→C) ∈ [0, 1]
    ci_lo: np.ndarray         # f32, Hoeffding lower bound on containment
    ci_hi: np.ndarray         # f32, Hoeffding upper bound on containment
    jaccard: np.ndarray       # f32, Ĵ(K_Q, K_C) ∈ [0, 1]
    join_size: np.ndarray     # f32, estimated |K_Q ∩ K_C|
    cand_distinct: np.ndarray  # f32, D̂_C per candidate


def joinability_estimates(hits: np.ndarray, q_fib_sorted: np.ndarray,
                          cand_count: np.ndarray, cand_tau: np.ndarray,
                          n: int, *, q_full: bool | None = None,
                          cand_distinct: np.ndarray | None = None,
                          alpha: float = 0.05) -> JoinabilityEstimates:
    """Raw hit counts → the joinability estimate set (§3.3).

    ``hits [C]`` — stage-1 intersection sizes; ``q_fib_sorted [k_Q]`` — the
    query's valid minima as ascending uint32 Fibonacci values
    (`query_minima`); ``cand_count`` / ``cand_tau [C]`` — the index's
    `KeyMinima`; ``n`` — the sketch capacity; ``q_full`` — whether the
    query sketch is saturated (default ``k_Q >= n``); ``cand_distinct`` —
    a cached ``distinct_from_minima(cand_count, cand_tau, n)``.

    Where both sketches are unsaturated they hold complete key sets, so the
    estimates are exact counts and the CI collapses onto them."""
    hits = np.asarray(hits, np.float32)
    kq = int(q_fib_sorted.shape[0])
    if q_full is None:
        q_full = kq >= n
    probes = probe_counts(q_fib_sorted, cand_count, cand_tau, n)
    c_hat = (hits / np.maximum(probes, 1)).astype(np.float32)
    c_hat = np.where(probes > 0, c_hat, 0.0).astype(np.float32)
    lo, hi = bounds.containment_ci(c_hat, probes, alpha=alpha)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    exact = (~np.asarray(q_full)) & (np.asarray(cand_count) < n)
    lo = np.where(exact, c_hat, lo)
    hi = np.where(exact, c_hat, hi)

    if q_full and kq:
        u_q = float(np.uint32(q_fib_sorted[-1])) / 4294967296.0
        d_q = (kq - 1.0) / max(u_q, 1e-30)
    else:
        d_q = float(kq)
    d_c = (cand_distinct if cand_distinct is not None
           else distinct_from_minima(cand_count, cand_tau, n))
    inter = (c_hat * d_q).astype(np.float32)
    union = np.maximum(d_q + d_c - inter, 1e-30)
    jac = np.clip(inter / union, 0.0, 1.0).astype(np.float32)
    return JoinabilityEstimates(hits=hits, probes=probes, containment=c_hat,
                                ci_lo=lo, ci_hi=hi, jaccard=jac,
                                join_size=inter, cand_distinct=d_c)


def query_minima(q_kh: np.ndarray, q_mask: np.ndarray) -> np.ndarray:
    """Ascending uint32 Fibonacci values of a query sketch's valid minima
    — the ``q_fib_sorted`` input of `joinability_estimates`."""
    kh = np.asarray(q_kh).astype(np.uint32)[np.asarray(q_mask) > 0]
    return np.sort(fib_u32_np(kh))
