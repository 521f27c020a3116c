"""The plans of the serving engine (DESIGN.md §5–§7, §11), single device.

`ShapePolicy` holds what shapes a dispatch (top-k width, candidate chunk,
survivor ladders, candidate source); `Request` holds the per-query
semantics (k, estimator, scorer, prune mode, α, eligibility floor).
Request values are plain run-time arguments: no kernel specialises on
them, and a sweep over them after `Server.warmup` builds nothing new.

The scan (``prune="off"``) scores every candidate:

    _shard_stats   candidates in ``score_chunk`` blocks → (r, m, ci_len)
      _score_block   sketch join → estimator (pearson | spearman | rin | qn)
    score_stats    §4.4 scorer (s1 | s2 | s4) with the m ≥ floor gate
    topk           score descending, then candidate id ascending

Two-stage retrieval scores only candidates that can be eligible:

    probe          stage 1: exact key-intersection counts (= m) of every
                   candidate, one containment launch
    select_survivors / prune_rung   host filter → a ``prune_base · 2^i`` rung
    pruned         stage 2: the survivor sub-shard through `_shard_stats`
    topm           probe → per-row top-M by hits → per-row scoring
    inverted       postings window probe → merge → device select → stage 2,
                   one dispatch that also reports the survivor count
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core import scoring as SC
from repro_torch.core.bounds import hoeffding_eligibility_floor
from repro_torch.engine.index import PAD_PATTERN, IndexShard
from repro_torch.kernels import ops as K

FAST_SCORERS = ("s1", "s2", "s4")
ESTIMATORS = ("pearson", "spearman", "rin", "qn")
PRUNE_MODES = ("off", "safe", "topm")

_SCORER_INDEX = {s: i for i, s in enumerate(FAST_SCORERS)}
_ESTIMATOR_INDEX = {e: i for i, e in enumerate(ESTIMATORS)}


@dataclasses.dataclass(frozen=True)
class ShapePolicy:
    """Shape knobs of a dispatch; nothing here encodes query semantics."""
    #: top-k width of the rank stage; any request k ≤ k_max is a slice of it
    k_max: int = 10
    #: candidates scored per step; bounds the [B, chunk, nq] aligned tensors
    score_chunk: int = 512
    #: survivors per row of the ``topm`` plan
    prune_m: int = 128
    #: base rung of the survivor ladder ``prune_base · 2^i`` of the
    #: ``safe`` plans (stage-2 shapes come from this fixed ladder)
    prune_base: int = 64
    #: stage-1 candidate source (`repro_torch.engine.candidates`): "scan"
    #: (containment over every column), "inverted" (the postings index) or
    #: "auto" (`resolve_candidates` by corpus size); prune="off" is a scan
    candidates: str = "scan"


@dataclasses.dataclass(frozen=True)
class Request:
    """Per-request query semantics (paper Defn. 3, §4.3/§4.4, §5.3)."""
    k: int = 10
    estimator: str = "pearson"      # pearson | spearman | rin | qn
    scorer: str = "s4"              # s1 | s2 | s4
    prune: str = "off"              # off | safe | topm
    alpha: float = 0.05
    min_sample: int = 3


#: `ShapePolicy.candidates` vocabulary — "auto" resolves per corpus size
CANDIDATE_CHOICES = ("scan", "inverted", "auto")

#: corpus size from which ``candidates="auto"`` picks the inverted source
#: (the reference's crossover, measured on XLA:CPU; kept as it is)
AUTO_INVERTED_MIN_C = 4096


def resolve_candidates(candidates: str, num_columns: int) -> str:
    """``"auto"`` → "inverted" at `AUTO_INVERTED_MIN_C` columns or more,
    else "scan"; explicit sources pass through."""
    if candidates not in CANDIDATE_CHOICES:
        raise ValueError(f"unknown candidate source {candidates!r}: "
                         f"use one of {CANDIDATE_CHOICES}")
    if candidates != "auto":
        return candidates
    return "inverted" if int(num_columns) >= AUTO_INVERTED_MIN_C else "scan"


def request_operands(req: Request) -> np.ndarray:
    """Validate a `Request` and encode its scan knobs as ``f32[4] =
    [estimator, scorer, alpha, eligibility floor]`` — the reference's
    request operand vector."""
    if req.estimator not in _ESTIMATOR_INDEX:
        raise ValueError(f"unknown estimator {req.estimator!r}: "
                         f"use one of {ESTIMATORS}")
    if req.scorer not in _SCORER_INDEX:
        raise ValueError(f"unknown scorer {req.scorer!r}: the scan serves "
                         f"{FAST_SCORERS}")
    if req.prune not in PRUNE_MODES:
        raise ValueError(f"unknown prune mode {req.prune!r}: "
                         f"use one of {PRUNE_MODES}")
    return np.asarray([_ESTIMATOR_INDEX[req.estimator],
                       _SCORER_INDEX[req.scorer],
                       float(req.alpha),
                       float(hoeffding_eligibility_floor(req.min_sample))],
                      np.float32)


def coalesce_key(req: Request) -> tuple:
    """Request-compatibility key of the admission queue
    (`repro_torch.engine.scheduler`): requests with equal keys ride one
    dispatch — same estimator, scorer, prune mode, α and eligibility floor.
    ``k`` is left out: a coalesced dispatch runs at the group's largest k
    and each member keeps its own first k. Validates the request, so a bad
    one fails at submit time, not inside a worker."""
    request_operands(req)
    return (req.estimator, req.scorer, req.prune, float(req.alpha),
            int(req.min_sample))


def _score_block(q_kh, q_val, q_mask, kh, vals, mask, est: str):
    """One candidate block: moments ``[B, chunk, 6]`` and r ``[B, chunk]``
    under estimator ``est``. The rank and Qn estimators work on the join
    sample aligned to the query slots."""
    mom, aligned, hit = K.sketch_join_moments_batched(
        q_kh, q_val, q_mask, kh, vals, mask, with_aligned=est != "pearson")
    if est == "pearson":
        return mom, K.pearson_from_moments(mom)
    qv = q_val[:, None, :] * hit
    if est == "qn":
        return mom, K.qn_correlation(qv, aligned, hit)
    return mom, K.pearson_from_moments(K.rank_moments(qv, aligned, hit, est))


def _chunk_layout(C: int, score_chunk: int):
    """(chunk, pad, nb) of the candidate loop for a C-column shard."""
    chunk = min(score_chunk, C)
    pad = (-C) % chunk
    return chunk, pad, (C + pad) // chunk


def _shard_stats(q_kh, q_val, q_mask, q_cmin, q_cmax, shard: IndexShard,
                 score_chunk: int, est: str, alpha):
    """Chunked scan of every candidate → (r, m, ci_len), each ``[B, C]``.

    Candidates go through in ``score_chunk`` blocks, so the aligned
    ``[B, chunk, nq]`` tensors stay bounded for any C. The last block of a
    shard whose size is not a chunk multiple is padded with masked
    candidates, which are dropped again."""
    C = shard.num_columns
    B = q_kh.shape[0]
    chunk, pad, nb = _chunk_layout(C, score_chunk)
    dev = q_kh.device
    mom = torch.empty((B, C, 6), dtype=torch.float32, device=dev)
    r = torch.empty((B, C), dtype=torch.float32, device=dev)
    for i in range(nb):
        s, e = i * chunk, min((i + 1) * chunk, C)
        kh, vals, mask = (shard.key_hash[s:e], shard.values[s:e],
                          shard.mask[s:e])
        if e - s < chunk:
            fill = lambda x, v: torch.cat(
                [x, torch.full((chunk - (e - s),) + x.shape[1:], v,
                               dtype=x.dtype, device=dev)])
            kh, vals, mask = (fill(kh, PAD_PATTERN), fill(vals, 0.0),
                              fill(mask, 0.0))
        mom_b, r_b = _score_block(q_kh, q_val, q_mask, kh, vals, mask, est)
        mom[:, s:e] = mom_b[:, :e - s]
        r[:, s:e] = r_b[:, :e - s]
    c_lo = torch.minimum(q_cmin[:, None], shard.col_min[None, :])
    c_hi = torch.maximum(q_cmax[:, None], shard.col_max[None, :])
    lo, hi = K.hoeffding_from_moments(mom, c_lo, c_hi, alpha=alpha)
    return r, mom[..., 0], hi - lo


def score_stats(r, m, ci_len, scorer: str, floor: float):
    """The §4.4 scoring tail: (r, m, ci_len) ``[B, C]`` → scores, with the
    m ≥ floor eligibility gate (ineligible → −inf). s4 normalises the
    Hoeffding CI length over each query row's eligible candidates."""
    eligible = m >= floor
    abs_r = r.abs()
    if scorer == "s1":
        s = abs_r
    elif scorer == "s2":
        s = abs_r * SC.se_z_factor(m)
    elif scorer == "s4":
        lmin, lmax = SC.ci_h_bounds(ci_len, eligible, keepdim=True)
        s = abs_r * SC.ci_h_factor_from_bounds(ci_len, lmin, lmax)
    else:
        raise ValueError(f"unknown scorer {scorer!r}: use one of "
                         f"{FAST_SCORERS}")
    return torch.where(eligible, s, float("-inf"))


def topk(s, r, m, k: int, gids: Optional[torch.Tensor] = None):
    """Rank stage: the k best candidates per row in the order score
    descending, then position ascending (a stable sort) → (scores, ids, r,
    m), each ``[B, min(k, width)]``. Ids are positions, or ``gids`` (``[M]``
    or ``[B, M]`` index ids of the scored candidates) at those positions."""
    kk = min(k, s.shape[-1])
    pos = torch.sort(s, dim=-1, descending=True, stable=True).indices[:, :kk]
    take = lambda x: torch.take_along_dim(x, pos, dim=-1)
    ids = pos if gids is None else take(gids.expand(s.shape).to(torch.int64))
    return take(s), ids.to(torch.int32), take(r), take(m)


def _unpack(ops: np.ndarray):
    """(estimator, scorer, α, floor) of a `request_operands` vector."""
    return (ESTIMATORS[int(ops[0])], FAST_SCORERS[int(ops[1])], ops[2],
            float(ops[3]))


def scan(q_kh, q_val, q_mask, q_cmin, q_cmax, shard: IndexShard,
         shape: ShapePolicy, ops: np.ndarray):
    """The full scan plan: query arrays ``[B, nq]`` against ``shard`` under
    the `request_operands` vector ``ops`` → top-``k_max`` (scores, ids, r,
    m), each ``[B, min(k_max, C)]``."""
    est, scorer, alpha, floor = _unpack(ops)
    r, m, ci_len = _shard_stats(q_kh, q_val, q_mask, q_cmin, q_cmax, shard,
                                shape.score_chunk, est, alpha)
    s = score_stats(r, m, ci_len, scorer, floor)
    return topk(s, r, m, shape.k_max)


# ----------------------------------------------------------------------------
# two-stage retrieval: stage-1 probe, survivor filter, stage-2 scoring
# ----------------------------------------------------------------------------

def probe(q_kh, q_mask, shard: IndexShard):
    """Stage-1 scan: the exact sketch-intersection size of every query row
    with every candidate, ``[B, C]`` — by key distinctness the sketch-join
    sample size m the scan would compute, which is what makes
    ``prune="safe"`` lose no top-k column. One containment launch over all
    C: nothing ``[B, chunk, nq]``-sized is materialised."""
    return K.containment_hits_batched(q_kh, q_mask, shard.key_hash,
                                      shard.mask)


def _gather_rows(shard: IndexShard, ids: torch.Tensor,
                 ok: Optional[torch.Tensor] = None) -> IndexShard:
    """The sub-shard of columns ``ids``; rows where ``ok`` is false are
    fully masked (they score −inf and never rank)."""
    ids = ids.to(torch.int64)
    sub = IndexShard(*(getattr(shard, f.name)[ids]
                       for f in dataclasses.fields(shard)))
    if ok is None:
        return sub
    okf = ok.to(torch.float32)
    return IndexShard(
        key_hash=torch.where(ok[:, None], sub.key_hash, PAD_PATTERN),
        values=sub.values * okf[:, None], mask=sub.mask * okf[:, None],
        col_min=torch.where(ok, sub.col_min, 0.0),
        col_max=torch.where(ok, sub.col_max, 0.0), rows=sub.rows * okf)


def survivor_stats(q_kh, q_val, q_mask, q_cmin, q_cmax, shard: IndexShard,
                   surv, valid, score_chunk: int, est: str, alpha):
    """Stage-2 body: gather the survivor columns ``surv [M]`` (``valid``
    flags the real ones) into a masked sub-shard and run the ordinary
    chunked scorer on it → per-survivor (r, m, ci_len), each ``[B, M]``.
    Shared by the host-selected `pruned` plan and the fused `inverted`
    plan, so equal survivor inputs give equal stats."""
    return _shard_stats(q_kh, q_val, q_mask, q_cmin, q_cmax,
                        _gather_rows(shard, surv, valid), score_chunk, est,
                        alpha)


def pruned(q_kh, q_val, q_mask, q_cmin, q_cmax, shard: IndexShard, surv,
           valid, shape: ShapePolicy, ops: np.ndarray):
    """Gather + score + rank of ``M`` survivor columns (a rung of the
    ``prune_base · 2^i`` ladder, ``M ≥ k_max``; the filter ran on the
    host) → top-``k_max`` (scores, index ids, r, m)."""
    if shape.k_max > surv.shape[0]:
        raise ValueError(f"rung {surv.shape[0]} is below k_max={shape.k_max}")
    est, scorer, alpha, floor = _unpack(ops)
    r, m, ci_len = survivor_stats(q_kh, q_val, q_mask, q_cmin, q_cmax, shard,
                                  surv, valid, shape.score_chunk, est, alpha)
    s = score_stats(r, m, ci_len, scorer, floor)
    return topk(s, r, m, shape.k_max, gids=surv)


def topm(q_kh, q_val, q_mask, q_cmin, q_cmax, shard: IndexShard,
         shape: ShapePolicy, ops: np.ndarray):
    """The ``prune="topm"`` plan on the scan source: probe, then each row
    keeps its own M = ``prune_m`` best candidates by exact hits (ineligible
    ones last, ties to the lower id) and scores only those → top-``k_max``
    (scores, index ids, r, m). Rows have their own candidate sets, and s4
    normalises over each row's own list, so each row is scored by itself
    against its gathered ``[M, n]`` planes."""
    est, scorer, alpha, floor = _unpack(ops)
    C = shard.num_columns
    M = max(min(int(shape.prune_m), C), min(shape.k_max, C))
    hits = probe(q_kh, q_mask, shard)
    hits = torch.where(hits >= floor, hits, -1.0)
    ids = torch.sort(hits, dim=-1, descending=True, stable=True).indices[:, :M]
    stats = [_shard_stats(q_kh[b:b + 1], q_val[b:b + 1], q_mask[b:b + 1],
                          q_cmin[b:b + 1], q_cmax[b:b + 1],
                          _gather_rows(shard, ids[b]), shape.score_chunk, est,
                          alpha) for b in range(q_kh.shape[0])]
    r, m, ci_len = (torch.cat(x) for x in zip(*stats))
    s = score_stats(r, m, ci_len, scorer, floor)
    return topk(s, r, m, shape.k_max, gids=ids)


def postings_window_candidates(q_kh, q_mask, keys, cols, W: int):
    """Front half of the inverted probe (DESIGN.md §7): per valid query
    key, ``searchsorted`` into the key-sorted postings and gather a W-wide
    window → the matched column ids ``cand i32[B, n·W]``, −1 elsewhere.
    ``keys`` are int64 hashes in [0, 2³²) with the PAD tail last; real keys
    never equal PAD, so the tail cannot match."""
    B, n = q_kh.shape
    E = keys.shape[0]
    q = hashing.from_pattern(q_kh)
    pos = torch.searchsorted(keys, q)
    win = pos[..., None] + torch.arange(W, device=q.device)
    ok = win < E
    win = torch.clamp(win, max=E - 1)
    c_g = cols[win]
    match = (ok & (keys[win] == q[..., None]) & (c_g >= 0)
             & (q_mask[..., None] > 0))
    return torch.where(match, c_g, -1).reshape(B, n * W)


def inverted(q_kh, q_val, q_mask, q_cmin, q_cmax, shard: IndexShard, keys,
             cols, W: int, M: int, shape: ShapePolicy, ops: np.ndarray):
    """The fused inverted ``safe`` plan (DESIGN.md §11): postings probe →
    merge → device survivor select → gather → score → rank, with no
    ``[B, C]`` hit matrix and no host round trip inside → top-``k_max``
    (scores, index ids, r, m) and the exact survivor-union size ``n_surv``
    (a 0-d tensor). ``n_surv > M`` means the rung overflowed: the scored
    survivors are then the M smallest ids, and the caller re-dispatches on
    the covering rung."""
    if shape.k_max > M:
        raise ValueError(f"rung {M} is below k_max={shape.k_max}")
    est, scorer, alpha, floor = _unpack(ops)
    cand = postings_window_candidates(q_kh, q_mask, keys, cols, W)
    mcols, mcnt = K.postings_merge(cand, shard.num_columns)
    surv, valid, n_surv = K.postings_select(mcols, mcnt, floor, M,
                                            shard.num_columns)
    r, m, ci_len = survivor_stats(q_kh, q_val, q_mask, q_cmin, q_cmax, shard,
                                  surv, valid, shape.score_chunk, est, alpha)
    s = score_stats(r, m, ci_len, scorer, floor)
    return topk(s, r, m, shape.k_max, gids=surv) + (n_surv,)


def select_survivors(hits, prune: str, min_sample: int = 3,
                     prune_m: int = 128) -> np.ndarray:
    """Host stage-1 → stage-2 selection over ``hits`` ``[C]`` or
    ``[B, C]`` (a batch prunes to the union of its rows' sets) → sorted
    survivor ids. ``"safe"``: every candidate with hits ≥ the eligibility
    floor in some row — the scan scores all others −inf, so no top-k
    column is lost. ``"topm"``: per row, the ``prune_m`` eligible
    candidates with the most hits (stable: lower id wins ties)."""
    h = np.atleast_2d(np.asarray(hits))
    eligible = h >= hoeffding_eligibility_floor(min_sample)
    if prune == "safe":
        return np.nonzero(eligible.any(0))[0].astype(np.int32)
    if prune == "topm":
        m = max(int(prune_m), 1)
        keep = np.zeros(h.shape[1], bool)
        for row, okr in zip(h, eligible):
            ids = np.argsort(-row, kind="stable")[:m]
            keep[ids[okr[ids]]] = True
        return np.nonzero(keep)[0].astype(np.int32)
    raise ValueError(f"unknown prune mode {prune!r}: use 'safe' or 'topm'")


def prune_rung(n_survivors: int, base: int, C: int) -> Optional[int]:
    """Smallest rung of the ladder ``base · 2^i`` holding ``n_survivors``,
    or None when it would not beat the full scan (≥ C columns) — the
    caller then scans."""
    r = max(int(base), 1)
    while r < max(n_survivors, 1):
        r *= 2
    return None if r >= C else r
