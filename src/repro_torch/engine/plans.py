"""The plans of the serving engine (DESIGN.md §5–§7, §10, §11).

`ShapePolicy` holds what shapes a dispatch (top-k width, candidate chunk,
survivor ladders, candidate source, shard count, rank combine); `Request`
holds the per-query semantics (k, estimator, scorer, prune mode, α,
eligibility floor). Request values are plain run-time arguments: no
kernel specialises on them, and a sweep over them after `Server.warmup`
builds nothing new.

Every plan runs over an index shard placed on one device (`IndexShard`) or
column-sharded over a mesh (`MeshShard`, DESIGN.md §10): each shard scores
its own columns on its own device, and only ``[B, k_max]`` strips (and s4's
two ``[B]`` bound vectors) cross between shards. The scan
(``prune="off"``) scores every candidate:

    _shard_stats   candidates in ``score_chunk`` blocks → (r, m, ci_len)
      _score_block   sketch join → estimator (pearson | spearman | rin | qn)
    score_shards   §4.4 scorer (s1 | s2 | s4) with the m ≥ floor gate; s4's
                   CI-length bounds are reduced across shards first
    topk           each shard's top-k_max: score descending, id ascending
    combine        ``"gather"`` (strips ranked on the first shard's device)
                   or ``"host"`` (`combine_local_topk`, a numpy lexsort) —
                   one total order, score descending then global id
                   ascending, so every shard count gives the same result

Two-stage retrieval scores only candidates that can be eligible:

    probe          stage 1: exact key-intersection counts (= m) of every
                   candidate, one containment launch per shard
    select_survivors / prune_rung   host filter → a ``prune_base · 2^i`` rung
    pruned         stage 2: each shard scores the survivors it owns
    topm           probe → per-shard, per-row top-M by hits → scoring
    inverted       postings window probe → merge → device select (on the
                   first shard's device, the probe is replicated) → stage 2,
                   one dispatch that also reports the survivor count

`scan`, `probe` and `pruned` also take a single query (``[nq]`` arrays):
it runs as a batch of one, so its result equals its row of any batch.
`split_config` maps a legacy `repro_torch.engine.query.QueryConfig` onto a
(`ShapePolicy`, `Request`) pair, and `make_scan_fn`, `make_probe_fn`,
`make_pruned_fn` and `make_topm_fn` keep the reference's plan-builder
signatures over these plans (the legacy facade's programs).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import hashing
from repro_torch.core import scoring as SC
from repro_torch.core.bounds import hoeffding_eligibility_floor
from repro_torch.engine.index import PAD_PATTERN, IndexShard, MeshShard
from repro_torch.kernels import ops as K
from repro_torch.launch import mesh as MS

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
    #: shards of the mesh the plans run on; 0 = unresolved, pinned by
    #: `resolve_shape` (a nonzero value must match the mesh)
    mesh_shards: int = 0
    #: cross-shard rank combine (DESIGN.md §10): "gather" ranks the
    #: ``[D, k_max]`` strips on the first shard's device, "host" merges
    #: them on the host (`combine_local_topk`); both use one total order.
    #: "auto": "gather" on one shard, "host" on more
    combine: str = "auto"


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


#: `ShapePolicy.combine` vocabulary
COMBINE_MODES = ("auto", "gather", "host")


def resolve_shape(shape: ShapePolicy, mesh,
                  num_columns: Optional[int] = None) -> ShapePolicy:
    """Pin the mesh-dependent fields of ``shape`` for ``mesh`` (a sequence
    of devices): ``mesh_shards`` becomes the shard count (a nonzero value
    must already equal it) and ``combine="auto"`` becomes "gather" on one
    shard and "host" on more. With ``num_columns`` (a segment's padded
    column count) ``candidates="auto"`` resolves too (`resolve_candidates`);
    without it the value is only checked."""
    ndev = len(mesh)
    _plan_combine(shape, ndev)
    combine = shape.combine
    if combine == "auto":
        combine = "host" if ndev > 1 else "gather"
    resolved = resolve_candidates(shape.candidates, num_columns or 0)
    candidates = shape.candidates if num_columns is None else resolved
    return dataclasses.replace(shape, mesh_shards=ndev, combine=combine,
                               candidates=candidates)


def _plan_combine(shape: ShapePolicy, ndev: int) -> bool:
    """Check ``shape`` against an ``ndev``-shard mesh; True when its plans
    combine on the host. An unresolved ``"auto"`` gathers, as the
    reference's plan builders do."""
    if shape.combine not in COMBINE_MODES:
        raise ValueError(f"unknown combine mode {shape.combine!r}: "
                         f"use one of {COMBINE_MODES}")
    if shape.mesh_shards not in (0, ndev):
        raise ValueError(f"ShapePolicy.mesh_shards={shape.mesh_shards} does "
                         f"not match the {ndev}-shard mesh")
    return shape.combine == "host"


def split_config(qcfg) -> "tuple[ShapePolicy, Request]":
    """Split a legacy `repro_torch.engine.query.QueryConfig` into a
    (`ShapePolicy`, `Request`) pair; ``k_max`` is the legacy ``k``.

    Keeps the reference's leniency: a scorer outside {s1, s2} scores as
    s4, an estimator outside the four as pearson (a `Request` built
    directly is still checked strictly by `request_operands`); an unknown
    prune mode raises. ``intersect`` ("sortmerge" or "eqmatrix") and
    ``kernels`` name the reference's XLA intersect and kernel backend: the
    reference serves any other ``intersect`` through its eq-matrix branch,
    and both give the same statistics, so the port accepts any value, as
    the reference does, and drops both — its plans have one intersect, the
    kernel of the tensors' device."""
    if qcfg.prune not in PRUNE_MODES:
        raise ValueError(f"unknown prune mode {qcfg.prune!r}: "
                         f"use one of {PRUNE_MODES}")
    shape = ShapePolicy(k_max=qcfg.k, score_chunk=qcfg.score_chunk,
                        prune_m=qcfg.prune_m, prune_base=qcfg.prune_base)
    req = Request(k=qcfg.k,
                  estimator=(qcfg.estimator if qcfg.estimator in ESTIMATORS
                             else "pearson"),
                  scorer=(qcfg.scorer if qcfg.scorer in ("s1", "s2")
                          else "s4"),
                  prune=qcfg.prune, alpha=qcfg.alpha,
                  min_sample=qcfg.min_sample)
    return shape, req


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


def score_stats(r, m, ci_len, scorer: str, floor: float, bounds=None):
    """The §4.4 scoring tail: (r, m, ci_len) ``[B, C]`` → scores, with the
    m ≥ floor eligibility gate (ineligible → −inf). s4 normalises the
    Hoeffding CI length over each query row's eligible candidates: over
    these C, or by ``bounds`` (``[B, 1]`` min and max, `_s4_bounds`)."""
    eligible = m >= floor
    abs_r = r.abs()
    if scorer == "s1":
        s = abs_r
    elif scorer == "s2":
        s = abs_r * SC.se_z_factor(m)
    elif scorer == "s4":
        lmin, lmax = (SC.ci_h_bounds(ci_len, eligible, keepdim=True)
                      if bounds is None else bounds)
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


def _single(plan):
    """Let ``plan`` (query arrays first) take one query: ``[nq]`` arrays
    run as a batch of one and every output loses its batch axis, so a
    single query's result is its row of any batch."""
    @functools.wraps(plan)
    def run(q_kh, q_val, q_mask, q_cmin, q_cmax, *rest):
        qa = (q_kh, q_val, q_mask, q_cmin, q_cmax)
        if q_kh.dim() != 1:
            return plan(*qa, *rest)
        out = plan(*(a[None] for a in qa), *rest)
        return tuple(o if o.dim() == 0 else o[0] for o in out)
    return run


# ----------------------------------------------------------------------------
# the mesh: per-shard stats → cross-shard s4 bounds → local top-k → combine
# ----------------------------------------------------------------------------

def as_mesh_shard(shard) -> MeshShard:
    """``shard`` as a `MeshShard`: an `IndexShard` is a one-shard mesh on
    its own device."""
    if isinstance(shard, MeshShard):
        return shard
    return MeshShard(blocks=(shard,), mesh=(shard.key_hash.device,))


def _on(qa, device):
    """The query arrays on ``device`` (no copy when they are there)."""
    return tuple(a.to(device) for a in qa)


def _s4_bounds(stats, floor: float):
    """s4's normalisation bounds over every shard of one dispatch: each
    shard's ``[B, 1]`` min and max CI length over its eligible candidates,
    reduced on the first shard's device (min and max are exact, so any
    split of the candidates gives the one-shard bounds), then handed back
    to every shard."""
    local = [SC.ci_h_bounds(ci, m >= floor, keepdim=True) for _, m, ci in stats]
    dev = local[0][0].device
    lmin = torch.cat([lo.to(dev) for lo, _ in local], -1).amin(-1, keepdim=True)
    lmax = torch.cat([hi.to(dev) for _, hi in local], -1).amax(-1, keepdim=True)
    return [(lmin.to(r.device), lmax.to(r.device)) for r, _, _ in stats]


def score_shards(stats, scorer: str, floor: float) -> List[torch.Tensor]:
    """`score_stats` of every shard's (r, m, ci_len); under s4 the bounds
    are reduced across the shards before any shard scores, so its ranking
    does not depend on how the candidates are split."""
    bounds = (_s4_bounds(stats, floor) if scorer == "s4"
              else [None] * len(stats))
    return [score_stats(r, m, ci, scorer, floor, bounds=b)
            for (r, m, ci), b in zip(stats, bounds)]


def _total_order(s, g):
    """Per-row permutation of ``[B, L]`` strips into the total order score
    descending, then global id ascending (two stable sorts)."""
    by_id = torch.sort(g, dim=-1, stable=True).indices
    by_s = torch.sort(torch.take_along_dim(s, by_id, dim=-1), dim=-1,
                      descending=True, stable=True).indices
    return torch.take_along_dim(by_id, by_s, dim=-1)


def _topk_gathered(strips, k: int):
    """The ``"gather"`` combine: every shard's strip moves to the first
    shard's device, where the ``[B, D·kk]`` concatenation is ranked in the
    total order → top-k (scores, global ids, r, m) on that device."""
    dev = strips[0][0].device
    s, g, r, m = (torch.cat([x.to(dev) for x in xs], -1)
                  for xs in zip(*strips))
    pick = _total_order(s, g)[:, :k]
    return tuple(torch.take_along_dim(x, pick, dim=-1) for x in (s, g, r, m))


def combine_local_topk(s, g, r, m, k: int):
    """The ``"host"`` combine: merge the concatenated per-shard strips
    ``[B, D·kk]`` (numpy) into the top-k under score descending, global id
    ascending — the order of the ``"gather"`` combine and of the server's
    cross-segment merge."""
    s, g = np.asarray(s), np.asarray(g)
    pick = np.lexsort((g, -s), axis=-1)[..., :k]
    take = lambda x: np.take_along_axis(np.asarray(x), pick, axis=-1)
    return take(s), take(g), take(r), take(m)


def _rank(stats, gids, scorer: str, floor: float, k: int, host: bool):
    """Score every shard (`score_shards`), take each shard's top-k and
    combine the strips → (scores, global ids, r, m) ``[B, min(k, D·kk)]``:
    tensors on the first shard's device (gather) or on the CPU (host)."""
    strips = []
    for s, (r, m, _), g in zip(score_shards(stats, scorer, floor), stats,
                               gids):
        with D.on(s.device):
            # gids ascend along each shard's candidates, so topk's order
            # (score descending, position ascending) is the total order
            strips.append(topk(s, r, m, k, gids=g))
    if not host:
        return _topk_gathered(strips, k)
    cat = [np.concatenate([x.cpu().numpy() for x in xs], -1)
           for xs in zip(*strips)]
    return tuple(torch.from_numpy(x) for x in combine_local_topk(*cat, k))


@_single
def scan(q_kh, q_val, q_mask, q_cmin, q_cmax, shard, shape: ShapePolicy,
         ops: np.ndarray):
    """The full scan plan: query arrays ``[B, nq]`` (or one query's
    ``[nq]``) against ``shard`` (an `IndexShard` or a `MeshShard`) under
    the `request_operands` vector ``ops`` → top-``k_max`` (scores, ids, r,
    m), each ``[B, min(k_max, C)]`` (``[min(k_max, C)]``): every shard
    scans its own block."""
    ms = as_mesh_shard(shard)
    est, scorer, alpha, floor = _unpack(ops)
    qa = (q_kh, q_val, q_mask, q_cmin, q_cmax)
    stats, gids = [], []
    for d, (blk, dev) in enumerate(zip(ms.blocks, ms.mesh)):
        with D.on(dev):
            stats.append(_shard_stats(*_on(qa, dev), blk, shape.score_chunk,
                                      est, alpha))
        gids.append(torch.arange(ms.width, dtype=torch.int32, device=dev)
                    + ms.offset(d))
    return _rank(stats, gids, scorer, floor, shape.k_max,
                 _plan_combine(shape, len(ms.mesh)))


# ----------------------------------------------------------------------------
# two-stage retrieval: stage-1 probe, survivor filter, stage-2 scoring
# ----------------------------------------------------------------------------

def probe(q_kh, q_mask, shard: IndexShard):
    """Stage-1 scan: the exact sketch-intersection size of every query row
    with every candidate, ``[B, C]`` (one query ``[nq]``: ``[C]``) — by
    key distinctness the sketch-join sample size m the scan would compute,
    which is what makes ``prune="safe"`` lose no top-k column. One
    containment launch over all C: nothing ``[B, chunk, nq]``-sized is
    materialised."""
    if q_kh.dim() == 1:
        return K.containment_hits(q_kh, q_mask, shard.key_hash, shard.mask)
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


def _owned_stats(qa, ms: MeshShard, surv, valid, score_chunk: int,
                 est: str, alpha):
    """Stage 2 over a mesh: the survivor list ``surv [M]`` (global ids,
    ``valid`` flags the real ones; on any device) goes to every shard,
    which gathers the survivors it owns into a masked sub-shard and scores
    it — the others stay masked (−inf). → per shard (r, m, ci_len) ``[B,
    M]`` and the global ids ``surv`` on its device."""
    stats, gids = [], []
    for d, (blk, dev) in enumerate(zip(ms.blocks, ms.mesh)):
        g = surv.to(dev)
        loc = g.to(torch.int64) - ms.offset(d)
        ok = valid.to(dev) & (loc >= 0) & (loc < ms.width)
        with D.on(dev):
            stats.append(survivor_stats(*_on(qa, dev), blk,
                                        torch.clamp(loc, 0, ms.width - 1), ok,
                                        score_chunk, est, alpha))
        gids.append(g)
    return stats, gids


@_single
def pruned(q_kh, q_val, q_mask, q_cmin, q_cmax, shard, surv, valid,
           shape: ShapePolicy, ops: np.ndarray):
    """Gather + score + rank of ``M`` survivor columns (a rung of the
    ``prune_base · 2^i`` ladder, ``M ≥ k_max``; the filter ran on the
    host), each scored on the shard that owns it → top-``k_max`` (scores,
    index ids, r, m), for a batch or one query."""
    if shape.k_max > surv.shape[0]:
        raise ValueError(f"rung {surv.shape[0]} is below k_max={shape.k_max}")
    ms = as_mesh_shard(shard)
    est, scorer, alpha, floor = _unpack(ops)
    stats, gids = _owned_stats((q_kh, q_val, q_mask, q_cmin, q_cmax), ms,
                               surv, valid, shape.score_chunk, est, alpha)
    return _rank(stats, gids, scorer, floor, shape.k_max,
                 _plan_combine(shape, len(ms.mesh)))


def topm(q_kh, q_val, q_mask, q_cmin, q_cmax, shard, shape: ShapePolicy,
         ops: np.ndarray):
    """The ``prune="topm"`` plan on the scan source: every shard probes its
    block, and each row keeps its own M = ``prune_m`` best candidates of
    the shard by exact hits (ineligible ones last, ties to the lower id)
    and scores only those → top-``k_max`` (scores, index ids, r, m). With
    ``prune_m`` at least a row's eligible count per shard this scores every
    candidate that can score at all. Rows have their own candidate sets, so
    each row is scored by itself against its gathered ``[M, n]`` planes
    (in ascending id order); s4 normalises over the row's lists of every
    shard."""
    ms = as_mesh_shard(shard)
    est, scorer, alpha, floor = _unpack(ops)
    w = ms.width
    M = max(min(int(shape.prune_m), w), min(shape.k_max, w))
    stats, gids = [], []
    for d, (blk, dev) in enumerate(zip(ms.blocks, ms.mesh)):
        qk, qv, qm, qlo, qhi = _on((q_kh, q_val, q_mask, q_cmin, q_cmax), dev)
        with D.on(dev):
            hits = probe(qk, qm, blk)
            hits = torch.where(hits >= floor, hits, -1.0)
            ids = torch.sort(hits, dim=-1, descending=True,
                             stable=True).indices[:, :M]
            ids = torch.sort(ids, dim=-1).values
            rows = [_shard_stats(qk[b:b + 1], qv[b:b + 1], qm[b:b + 1],
                                 qlo[b:b + 1], qhi[b:b + 1],
                                 _gather_rows(blk, ids[b]), shape.score_chunk,
                                 est, alpha) for b in range(qk.shape[0])]
        stats.append(tuple(torch.cat(x) for x in zip(*rows)))
        gids.append(ids + ms.offset(d))
    return _rank(stats, gids, scorer, floor, shape.k_max,
                 _plan_combine(shape, len(ms.mesh)))


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


def inverted(q_kh, q_val, q_mask, q_cmin, q_cmax, shard, keys, cols,
             W: int, M: int, shape: ShapePolicy, ops: np.ndarray):
    """The fused inverted ``safe`` plan (DESIGN.md §11): postings probe →
    merge → device survivor select → gather → score → rank, with no
    ``[B, C]`` hit matrix and no host round trip inside → top-``k_max``
    (scores, index ids, r, m) and the exact survivor-union size ``n_surv``
    (a 0-d tensor). The probe, merge and select run where the postings
    are (the index's global ids, replicated for every shard); each shard
    then scores the survivors it owns. ``n_surv > M`` means the rung
    overflowed: the scored survivors are then the M smallest ids, and the
    caller re-dispatches on the covering rung."""
    if shape.k_max > M:
        raise ValueError(f"rung {M} is below k_max={shape.k_max}")
    ms = as_mesh_shard(shard)
    est, scorer, alpha, floor = _unpack(ops)
    qa = _on((q_kh, q_val, q_mask, q_cmin, q_cmax), keys.device)
    with D.on(keys.device):
        cand = postings_window_candidates(qa[0], qa[2], keys, cols, W)
        mcols, mcnt = K.postings_merge(cand, ms.num_columns)
        surv, valid, n_surv = K.postings_select(mcols, mcnt, floor, M,
                                                ms.num_columns)
    stats, gids = _owned_stats(qa, ms, surv, valid, shape.score_chunk, est,
                               alpha)
    return _rank(stats, gids, scorer, floor, shape.k_max,
                 _plan_combine(shape, len(ms.mesh))) + (n_surv,)


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


def prune_rung(n_survivors: int, base: int, C: int,
               ndev: int = 1) -> Optional[int]:
    """Smallest rung of the ladder ``base · 2^i`` holding ``n_survivors``,
    rounded up to a multiple of the shard count ``ndev``, or None when it
    would not beat the full scan (≥ the C padded columns) — the caller
    then scans."""
    r = max(int(base), 1)
    while r < max(n_survivors, 1):
        r *= 2
    r += (-r) % int(ndev)
    return None if r >= C else r


# ----------------------------------------------------------------------------
# plan builders: the reference's signatures over the plans above
# ----------------------------------------------------------------------------

def _builder_mesh(mesh, C_total: int, shape: ShapePolicy, with_prep: bool,
                  emit_tables: bool = False):
    """Check a plan builder's arguments → the mesh as a device tuple.
    ``with_prep`` and ``emit_tables`` name the reference's XLA probe and
    sort tables (`PreppedShard`, the bit tables stage 2 reuses): the
    port's kernels need neither, so it builds neither and refuses them."""
    if with_prep or emit_tables:
        raise ValueError("with_prep / emit_tables name the reference's XLA "
                         "prep and probe tables, which the port does not "
                         "build: its kernels take the index planes as they "
                         "are")
    mesh = MS.as_mesh(mesh)
    if C_total % len(mesh):
        raise ValueError(f"C_total={C_total} does not split over "
                         f"{len(mesh)} shards")
    _plan_combine(shape, len(mesh))
    return mesh


def _builder_call(q_kh, batch: Optional[int], shard, mesh, C_total: int,
                  n: int) -> MeshShard:
    """Check a built plan's call against what it was built for: one query
    (``batch=None``: ``[nq]`` arrays) or ``batch`` rows, and an index of
    ``C_total`` columns of sketch size ``n`` in as many shards as the
    mesh has devices."""
    if batch is None and q_kh.dim() != 1:
        raise ValueError(f"a single-query plan takes [nq] query arrays, "
                         f"not {tuple(q_kh.shape)}")
    if batch is not None and (q_kh.dim() != 2 or q_kh.shape[0] != batch):
        raise ValueError(f"a batch-{batch} plan takes [{batch}, nq] query "
                         f"arrays, not {tuple(q_kh.shape)}")
    ms = as_mesh_shard(shard)
    if (ms.num_columns, len(ms.mesh), ms.blocks[0].key_hash.shape[1]) != (
            C_total, len(mesh), n):
        raise ValueError(
            f"the plan was built for {C_total} columns of size {n} over "
            f"{len(mesh)} shards, not {ms.num_columns} of size "
            f"{ms.blocks[0].key_hash.shape[1]} over {len(ms.mesh)}")
    return ms


def make_scan_fn(mesh, C_total: int, n: int, shape: ShapePolicy,
                 batch: Optional[int] = None, with_prep: bool = False):
    """The full-scan plan (`scan`) for an index of ``C_total`` columns of
    sketch size ``n`` over ``mesh``: ``fn(q_kh, q_val, q_mask, q_cmin,
    q_cmax, shard, ops)`` → top-``k_max`` (scores, ids, r, m). ``batch=
    None`` takes one query (``[k_max]`` results), ``batch=B`` a ``[B, nq]``
    batch. A ``"host"`` combine returns the merged top-k (the reference
    returns the per-shard strips that `combine_local_topk` merges into
    it). ``with_prep`` raises (`_builder_mesh`)."""
    mesh = _builder_mesh(mesh, C_total, shape, with_prep)

    def fn(q_kh, q_val, q_mask, q_cmin, q_cmax, shard, ops):
        ms = _builder_call(q_kh, batch, shard, mesh, C_total, n)
        return scan(q_kh, q_val, q_mask, q_cmin, q_cmax, ms, shape, ops)
    return fn


def make_probe_fn(mesh, C_total: int, n: int, shape: ShapePolicy,
                  batch: Optional[int] = None, with_prep: bool = False,
                  emit_tables: bool = False):
    """The stage-1 plan (`probe` on every shard): ``fn(q_kh, q_val, q_mask,
    q_cmin, q_cmax, shard)`` → exact hit counts ``[B, C_total]`` (one
    query: ``[C_total]``) on the first shard's device, in global-id order.
    Request-independent: it takes no ``ops``. ``with_prep`` and
    ``emit_tables`` raise (`_builder_mesh`)."""
    mesh = _builder_mesh(mesh, C_total, shape, with_prep, emit_tables)

    def fn(q_kh, q_val, q_mask, q_cmin, q_cmax, shard):
        ms = _builder_call(q_kh, batch, shard, mesh, C_total, n)
        hits = []
        for blk, dev in zip(ms.blocks, ms.mesh):
            with D.on(dev):
                hits.append(probe(q_kh.to(dev), q_mask.to(dev), blk))
        return torch.cat([h.to(ms.mesh[0]) for h in hits], -1)
    return fn


def make_pruned_fn(mesh, C_total: int, n: int, shape: ShapePolicy, M: int,
                   batch: Optional[int] = None, with_prep: bool = False):
    """The stage-2 plan (`pruned`) at survivor rung ``M`` (≥ ``k_max``):
    ``fn(q_kh, q_val, q_mask, q_cmin, q_cmax, shard, surv, valid, ops)``,
    ``surv [M]`` global survivor ids and ``valid [M]`` the real ones →
    top-``k_max`` (scores, index ids, r, m). ``with_prep`` raises."""
    mesh = _builder_mesh(mesh, C_total, shape, with_prep)
    if shape.k_max > M:
        raise ValueError(f"rung {M} is below k_max={shape.k_max}")

    def fn(q_kh, q_val, q_mask, q_cmin, q_cmax, shard, surv, valid, ops):
        ms = _builder_call(q_kh, batch, shard, mesh, C_total, n)
        surv, valid = torch.as_tensor(surv), torch.as_tensor(valid)
        if surv.shape != (M,):
            raise ValueError(f"the plan scores a rung of {M}, not "
                             f"{tuple(surv.shape)}")
        return pruned(q_kh, q_val, q_mask, q_cmin, q_cmax, ms, surv,
                      valid.to(torch.bool), shape, ops)
    return fn


def make_topm_fn(mesh, C_total: int, n: int, shape: ShapePolicy, batch: int,
                 with_prep: bool = False):
    """The ``prune="topm"`` plan (`topm`) for ``[batch, nq]`` query arrays:
    ``fn(q_kh, q_val, q_mask, q_cmin, q_cmax, shard, ops)`` → top-
    ``k_max`` (scores, index ids, r, m). ``with_prep`` raises."""
    mesh = _builder_mesh(mesh, C_total, shape, with_prep)

    def fn(q_kh, q_val, q_mask, q_cmin, q_cmax, shard, ops):
        ms = _builder_call(q_kh, int(batch), shard, mesh, C_total, n)
        return topm(q_kh, q_val, q_mask, q_cmin, q_cmax, ms, shape, ops)
    return fn
