"""The scan plan of the serving engine (DESIGN.md §6), single device.

`ShapePolicy` holds what shapes a dispatch (top-k width, candidate chunk);
`Request` holds the per-query semantics (k, estimator, scorer, α,
eligibility floor). Request values are plain run-time arguments: no kernel
specialises on them, and a sweep over them after `Server.warmup` builds
nothing new.

The scan scores every candidate:

    _shard_stats   candidates in ``score_chunk`` blocks → (r, m, ci_len)
      _score_block   sketch join → estimator (pearson | spearman | rin | qn)
    score_stats    §4.4 scorer (s1 | s2 | s4) with the m ≥ floor gate
    topk           score descending, then candidate id ascending
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import scoring as SC
from repro_torch.core.bounds import hoeffding_eligibility_floor
from repro_torch.engine.index import PAD_PATTERN, IndexShard
from repro_torch.kernels import ops as K

FAST_SCORERS = ("s1", "s2", "s4")
ESTIMATORS = ("pearson", "spearman", "rin", "qn")

_SCORER_INDEX = {s: i for i, s in enumerate(FAST_SCORERS)}
_ESTIMATOR_INDEX = {e: i for i, e in enumerate(ESTIMATORS)}


@dataclasses.dataclass(frozen=True)
class ShapePolicy:
    """Shape knobs of a dispatch; nothing here encodes query semantics."""
    #: top-k width of the rank stage; any request k ≤ k_max is a slice of it
    k_max: int = 10
    #: candidates scored per step; bounds the [B, chunk, nq] aligned tensors
    score_chunk: int = 512


@dataclasses.dataclass(frozen=True)
class Request:
    """Per-request query semantics (paper Defn. 3, §4.3/§4.4, §5.3)."""
    k: int = 10
    estimator: str = "pearson"      # pearson | spearman | rin | qn
    scorer: str = "s4"              # s1 | s2 | s4
    alpha: float = 0.05
    min_sample: int = 3


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
    return np.asarray([_ESTIMATOR_INDEX[req.estimator],
                       _SCORER_INDEX[req.scorer],
                       float(req.alpha),
                       float(hoeffding_eligibility_floor(req.min_sample))],
                      np.float32)


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


def topk(s, r, m, k: int):
    """Rank stage: the k best candidates per row in the order score
    descending, then candidate id ascending (a stable sort) → (scores, ids,
    r, m), each ``[B, min(k, C)]``."""
    kk = min(k, s.shape[-1])
    ids = torch.sort(s, dim=-1, descending=True, stable=True).indices[:, :kk]
    take = lambda x: torch.take_along_dim(x, ids, dim=-1)
    return take(s), ids.to(torch.int32), take(r), take(m)


def scan(q_kh, q_val, q_mask, q_cmin, q_cmax, shard: IndexShard,
         shape: ShapePolicy, ops: np.ndarray):
    """The full scan plan: query arrays ``[B, nq]`` against ``shard`` under
    the `request_operands` vector ``ops`` → top-``k_max`` (scores, ids, r,
    m), each ``[B, min(k_max, C)]``."""
    est = ESTIMATORS[int(ops[0])]
    scorer = FAST_SCORERS[int(ops[1])]
    r, m, ci_len = _shard_stats(q_kh, q_val, q_mask, q_cmin, q_cmax, shard,
                                shape.score_chunk, est, ops[2])
    s = score_stats(r, m, ci_len, scorer, float(ops[3]))
    return topk(s, r, m, shape.k_max)
