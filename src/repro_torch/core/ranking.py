"""Top-k join-correlation query evaluation (paper Defn. 3, §4).

Given one query sketch and a stacked batch of candidate sketches: sketch
join (§3.2) → estimator (§5.3) → Hoeffding CI (§4.3) for every candidate,
then the chosen §4.4 scorer and the k best. Candidates go through in
chunks of the leading axis, which bounds the bootstrap's ``[chunk, 599,
n]`` resamples; no result depends on the chunking. This is the paper
library's single-device path; `repro_torch.engine.serve` is the batched
serving engine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import device as D
from repro_torch.core import bounds as B
from repro_torch.core import estimators as E
from repro_torch.core import join as J
from repro_torch.core import scoring as SC
from repro_torch.core.sketch import CorrelationSketch

#: candidates per chunk without and with the bootstrap (whose resamples
#: take ``chunk · 599 · n`` elements of each of several tensors)
CHUNK = 16384
BOOT_ELEMENTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Top-k answer to a join-correlation query (paper Defn. 3): ranked
    candidate ids with their estimates, §4.3 bounds and join sizes."""
    indices: torch.Tensor    # int32 [k], candidate indices into the stack
    scores: torch.Tensor     # f32 [k]
    r: torch.Tensor          # f32 [k], correlation estimates
    m: torch.Tensor          # int32 [k], sketch-join sample sizes
    ci_lo: torch.Tensor
    ci_hi: torch.Tensor
    join_size: torch.Tensor  # f32 [k], estimated |K_Q ∩ K_C|


def _to(sk: CorrelationSketch, dev: torch.device) -> CorrelationSketch:
    return sk.map(lambda t: t.to(dev))


def candidate_stats(query: CorrelationSketch, candidates: CorrelationSketch,
                    *, estimator: str = "pearson", alpha: float = 0.05,
                    bootstrap: bool = False,
                    generator: Optional[torch.Generator] = None,
                    device: D.DeviceLike = None):
    """`CandidateStats` and Eq. 1 join sizes (``[C]`` each) of every
    candidate of the stack, on ``device``. With ``bootstrap`` each
    candidate also gets its PM1 bootstrap, its resample stream drawn from
    ``generator`` (a fresh one seeded 0 when None)."""
    if estimator not in E.ESTIMATORS:
        raise ValueError(f"unknown estimator {estimator!r}: use one of "
                         f"{tuple(E.ESTIMATORS)}")
    est = E.ESTIMATORS[estimator]
    dev = D.resolve(device)
    query, candidates = _to(query, dev), _to(candidates, dev)
    C, n = candidates.key_hash.shape[0], max(query.n, candidates.n)
    if C == 0:
        raise ValueError("no candidates to score")
    keys = None
    chunk = CHUNK
    if bootstrap:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        keys = E.bootstrap_keys((C,), generator).to(dev)
        chunk = max(1, BOOT_ELEMENTS // (E._B * n))
    parts = []
    for s in range(0, C, chunk):
        sj = J.sketch_join(query, candidates.map(lambda t: t[s:s + chunk]))
        ci = B.hoeffding_ci(sj.a, sj.b, sj.mask, sj.c_low, sj.c_high,
                            alpha=alpha)
        part = [est(sj.a, sj.b, sj.mask), sj.m, ci.lo, ci.hi,
                sj.join_size_estimate()]
        if bootstrap:
            part += E.pm1_from_keys(sj.a, sj.b, sj.mask, keys[s:s + chunk])
        parts.append(part)
    cols = [torch.cat(c) for c in zip(*parts)]
    r, m, lo, hi, jsz = cols[:5]
    r_b = ci_b_lo = ci_b_hi = None
    if bootstrap:
        r_b, ci_b_lo, ci_b_hi = cols[5:]
    stats = SC.CandidateStats(r_p=r, m=m, ci_lo=lo, ci_hi=hi, r_b=r_b,
                              ci_b_lo=ci_b_lo, ci_b_hi=ci_b_hi)
    return stats, jsz


def topk_query(query: CorrelationSketch, candidates: CorrelationSketch, *,
               k: int = 10, estimator: str = "pearson", scorer: str = "s4",
               alpha: float = 0.05, bootstrap: bool = False,
               generator: Optional[torch.Generator] = None,
               min_sample: int = 3,
               device: D.DeviceLike = None) -> QueryResult:
    """Answer a top-k join-correlation query (paper Defn. 3) against a
    candidate stack on ``device`` (the CUDA card unless named): score with
    the chosen §4.4 scorer, send candidates under the m ≥ ``min_sample``
    floor to −inf, return the k best — score descending, ties (−inf rows
    among them) to the lower index."""
    if scorer not in SC.SCORERS:
        raise ValueError(f"unknown scorer {scorer!r}: use one of {SC.SCORERS}")
    stats, jsz = candidate_stats(query, candidates, estimator=estimator,
                                 alpha=alpha, bootstrap=bootstrap,
                                 generator=generator, device=device)
    eligible = stats.m >= min_sample
    s = torch.where(eligible, SC.score(stats, scorer, eligible=eligible),
                    -torch.inf)
    # a stable sort of −s: higher score first, equal scores by index
    top = torch.sort(-s, stable=True).indices[:min(k, s.shape[0])]
    return QueryResult(indices=top.to(torch.int32), scores=s[top],
                       r=stats.r_p[top], m=stats.m[top], ci_lo=stats.ci_lo[top],
                       ci_hi=stats.ci_hi[top], join_size=jsz[top])
