"""Request serving (DESIGN.md §6, §10): a static sketch index, or a live
index served segment by segment, on one device or column-sharded over a
device mesh (`repro_torch.launch.mesh`).

`Server` is the facade. Over a `SketchIndex` it runs one segment executor;
over a `repro_torch.engine.lifecycle.LiveIndex` it runs one per segment,
picks up mutations on `Server.refresh` and combines the segments' results
deterministically (score descending, then global id ascending; id −1 on
−inf rows), ids indexing `Server.names`. Each segment is placed over the
mesh when it is published (`engine.index.place_shard`): shard ``d`` scores
its own column block on ``mesh[d]`` and the shards' top-k strips combine
in the same order (`plans.ShapePolicy.combine`), so a sharded server
answers as a one-device server does. A segment executor does:

  * **batched sketch construction** — query columns are cut into
    fixed-length row chunks, all chunks are sketched in one batched
    `build_sketch`, and each query's chunks fold with the exact KMV merge
    (`build_query_sketches`);
  * **pad-to-bucket batching** — a batch of queries is covered by bucket
    dispatches; padding rows copy the last real query (the s4
    normalisation is per row, so they cannot perturb real rows) and are
    dropped before returning;
  * **measured-cost planning** — `warmup` builds and loads the kernels and
    times one dispatch of every bucket; `plan_batches` then covers a batch
    with the cheapest mix of buckets (exact DP over those timings);
  * **per-bucket score_chunk** — large buckets shrink the candidate block
    so the ``[B, chunk, nq]`` aligned tensors stay bounded;
  * **two-stage retrieval** (DESIGN.md §5, §7, §11) — ``prune="safe"``
    scores only candidates whose exact key-intersection size clears the
    eligibility floor, ``prune="topm"`` each row's M best by that size;
    stage 1 comes from the configured candidate source (containment scan
    or inverted postings). Through the inverted source, ``safe`` is one
    fused dispatch that adapts its survivor rung. Both fall back to the
    full scan when no rung below C holds the survivors (the reference's
    semantics), and every stage counts in ``throughput()["stages"]``;
  * **joinability search** — `stage1_hits` and `search_joinable` rank
    columns by containment, Jaccard, join size or hits (§2.1/§3.3).

Request semantics (k, estimator, scorer, prune mode, α, floor) are per
call; results come back as numpy ``[NQ, k]`` arrays (scores, ids, r, m).
`QueryServer` (and `repro_torch.engine.lifecycle.LiveQueryServer`) keep
the reference's deprecated servers: a legacy `QueryConfig`, its output
conventions and its warmup.
During a live index's delta phase the s4 CI normalisation spans one
segment's candidate list; s1 and s2 equal a static server's throughout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import containment as CT
from repro_torch.core import hashing
from repro_torch.core.sketch import (PAD_KEY, Agg, CorrelationSketch,
                                     build_sketch, merge)
from repro_torch.engine import candidates as CD
from repro_torch.engine import plans as PL
from repro_torch.engine import query as Q
from repro_torch.engine.index import (IndexShard, KeyMinima, Postings,
                                      SketchIndex, build_postings, key_minima,
                                      place_shard, query_arrays)
from repro_torch.kernels import ops as K
from repro_torch.launch import mesh as MS

#: rows (bucket B × candidates) of one scored block: bucket B scores
#: min(score_chunk, max(64, BLOCK_ROWS // B)) candidates at a time, which
#: bounds its [B, chunk, nq] aligned and hit planes
BLOCK_ROWS = 4096
#: timed dispatches per bucket in `Server.warmup`
COST_REPS = 2

#: per-stage telemetry vocabulary (DESIGN.md §11). Device stages: "stage1"
#: (candidate-source hit counts), "stage2" (pruned scoring), "scan" (full
#: scan — direct or fallback), "topm" (the scan-source top-M plan), "fused"
#: (the one-dispatch inverted safe plan); host stage: "select" (survivor
#: selection and rung choice)
_DEVICE_STAGES = ("stage1", "stage2", "scan", "topm", "fused")

#: metrics `search_joinable` can rank by (fields of JoinabilityEstimates)
JOIN_METRICS = ("containment", "jaccard", "join_size", "hits")

#: process-wide lock of sharded dispatches: one dispatch's per-shard
#: launches (and its cross-shard reductions) never interleave with another
#: thread's, so two scheduler workers serialise on a mesh; a one-device
#: executor does not take it
_MESH_DISPATCH_LOCK = threading.RLock()


def build_query_sketches(keys_list: Sequence[np.ndarray],
                         values_list: Sequence[np.ndarray], *, n: int,
                         agg: Agg = Agg.MEAN, chunk: int = 8192,
                         device: D.DeviceLike = None) -> CorrelationSketch:
    """Sketch a batch of query columns in one batched pass on ``device``.

    Every column is cut into ``chunk``-row blocks (the last one validity-
    masked); all blocks are sketched together, and each query's block
    sketches fold with the KMV merge — exact by the closure property, so
    each result equals sketching the column alone. Returns sketches with a
    leading ``[NQ]`` axis. Keys are 32-bit."""
    if not keys_list or len(keys_list) != len(values_list):
        raise ValueError("need one values column per key column, and at "
                         "least one query")
    dev = D.resolve(device)
    nq = len(keys_list)
    counts = [max(1, -(-len(k) // chunk)) for k in keys_list]
    starts = np.cumsum([0] + counts)
    total = int(starts[-1])
    keys = np.zeros((total, chunk), np.uint32)
    vals = np.zeros((total, chunk), np.float32)
    valid = np.zeros((total, chunk), bool)
    offs = np.zeros((total,), np.float32)
    for i, (k, v) in enumerate(zip(keys_list, values_list)):
        m, s, c = len(k), starts[i], counts[i]
        flat_k = np.zeros(c * chunk, np.uint32)
        flat_v = np.zeros(c * chunk, np.float32)
        flat_k[:m] = np.asarray(k, np.uint32)
        flat_v[:m] = np.asarray(v, np.float32)
        keys[s:s + c] = flat_k.reshape(c, chunk)
        vals[s:s + c] = flat_v.reshape(c, chunk)
        valid[s:s + c] = (np.arange(c * chunk) < m).reshape(c, chunk)
        offs[s:s + c] = np.arange(c, dtype=np.float32) * chunk
    parts = build_sketch(hashing.keys_tensor(keys, dev),
                         torch.from_numpy(vals).to(dev), n=n, agg=agg,
                         valid=torch.from_numpy(valid).to(dev),
                         order_offset=torch.from_numpy(offs).to(dev))

    # fold round j merges chunk j into every query that still has one;
    # exhausted queries keep their fold result
    out = parts.map(lambda a: a[torch.as_tensor(starts[:-1], device=dev)])
    for j in range(1, max(counts)):
        sel = torch.as_tensor([starts[i] + j if counts[i] > j else 0
                               for i in range(nq)], device=dev)
        has = torch.as_tensor([counts[i] > j for i in range(nq)], device=dev)
        merged = merge(out, parts.map(lambda a: a[sel]))
        pick = lambda new, old: torch.where(
            has.reshape((nq,) + (1,) * (old.dim() - 1)), new, old)
        out = CorrelationSketch(
            **{f.name: pick(getattr(merged, f.name), getattr(out, f.name))
               for f in dataclasses.fields(out) if f.name != "agg"},
            agg=agg)
    return out


@functools.lru_cache(maxsize=1024)
def _plan_cover(nq: int, buckets: tuple, costs: tuple) -> tuple:
    """Min-cost cover of ``nq`` queries by bucket dispatches: exact DP over
    per-dispatch ``costs`` (a tuple of (bucket, seconds) pairs)."""
    cost = dict(costs)
    best = [0.0] * (nq + 1)
    take = [0] * (nq + 1)
    for q in range(1, nq + 1):
        best[q], take[q] = min((best[max(0, q - b)] + cost[b], b)
                               for b in buckets)
    plan = []
    q = nq
    while q > 0:
        plan.append(take[q])
        q = max(0, q - take[q])
    return tuple(sorted(plan))


@dataclasses.dataclass(frozen=True)
class JoinabilityResult:
    """Top-k joinability search results (host numpy, all ``[NQ, k]``):
    ``ids`` index the server's catalog (−1 in empty tail slots), ``score``
    is the requested ranking metric, the rest are the per-result
    `repro_torch.core.containment.JoinabilityEstimates` fields."""
    ids: np.ndarray          # i32 [NQ, k]
    score: np.ndarray        # f32 [NQ, k] — the requested ranking metric
    hits: np.ndarray         # f32 [NQ, k]
    containment: np.ndarray  # f32 [NQ, k]
    ci_lo: np.ndarray        # f32 [NQ, k]
    ci_hi: np.ndarray        # f32 [NQ, k]
    jaccard: np.ndarray      # f32 [NQ, k]
    join_size: np.ndarray    # f32 [NQ, k]

    _FIELDS = ("ids", "score", "hits", "containment", "ci_lo", "ci_hi",
               "jaccard", "join_size")


def _host(out):
    """Device results → host numpy (the host waits for them)."""
    return tuple(o.cpu().numpy() for o in out)


def _stage_table(stage_s: Dict[str, float], stage_n: Dict[str, int]) -> dict:
    """``{stage: {count, total_s}}`` of per-stage accumulators."""
    return {name: dict(count=stage_n.get(name, 0),
                       total_s=stage_s.get(name, 0.0))
            for name in sorted(set(stage_n) | set(stage_s))}


def _drop_ineligible(s, g, r, m):
    """Id −1 where the score is −inf, so it never aliases a column."""
    return s, np.where(np.isfinite(s), g, -1).astype(np.int32), r, m


class _SegmentExec:
    """Serves queries against one resident index: a static index, or one
    segment of a live index, column-sharded over ``mesh`` (a one-device
    mesh is the plain case). `Server` is the facade over one or many.

    ``C`` is the padded column count (a multiple of the shard count);
    ``shape.k_max`` is clamped to it, so a small segment still serves, and
    ``candidates="auto"`` resolves against it. ``postings`` (a live
    segment's, maintained by its writes and tombstones) back the inverted
    source instead of a fresh build; the inverted probe runs on
    ``mesh[0]`` over global ids. ``batch_rows`` (default `BLOCK_ROWS`) is
    the block-row budget of `chunk_for`."""

    def __init__(self, shard: IndexShard, n: int, shape: PL.ShapePolicy, *,
                 request: PL.Request, buckets: Tuple[int, ...],
                 mesh: MS.Mesh, postings: Optional[Postings] = None,
                 batch_rows: Optional[int] = None):
        self.mesh = tuple(mesh)
        self.device = self.mesh[0]
        self.shard = place_shard(shard, self.mesh)
        self.n = int(n)
        self.batch_rows = int(batch_rows or BLOCK_ROWS)
        self.C = self.shard.num_columns
        shape = PL.resolve_shape(shape, self.mesh, num_columns=self.C)
        if shape.k_max > self.C:  # a corpus smaller than k_max still serves
            shape = dataclasses.replace(shape, k_max=self.C)
        self.shape = shape
        self.k_max = shape.k_max
        #: the concrete stage-1 source ("auto" resolved against C)
        self.candidates = shape.candidates
        self.request = request
        self.buckets = buckets
        self._postings = postings
        self._source = None
        #: KMV key-minima layout and its D̂_C estimates (built on first use)
        self._minima: Optional[KeyMinima] = None
        self._minima_dc: Optional[np.ndarray] = None
        #: last sufficient survivor rung of the fused inverted safe plan
        self._fused_rung: Optional[int] = None
        self.fused_safe = True
        #: measured seconds per dispatch for each bucket (filled by warmup)
        self._bucket_cost = {}
        #: guards the telemetry below: a racy ``+=`` loses updates
        self._tel_lock = threading.Lock()
        #: per-dispatch telemetry (bucket B, real queries, seconds), bounded
        self.dispatch_log: Deque[Tuple[int, int, float]] = deque(maxlen=4096)
        self._total_queries = 0
        self._total_dispatches = 0
        self._total_s = 0.0
        #: per-stage wall seconds and counts, keyed by stage name
        self._stage_s = {}
        self._stage_n = {}

    # -- shape policy per bucket ---------------------------------------------
    def chunk_for(self, B: int) -> int:
        """Bucket-B score_chunk: shrunk toward ``batch_rows`` rows (floored
        at 64, never raised above the configured value)."""
        return min(self.shape.score_chunk, max(64, self.batch_rows // B))

    def shape_for(self, B: int) -> PL.ShapePolicy:
        chunk = self.chunk_for(B)
        if chunk == self.shape.score_chunk:
            return self.shape
        return dataclasses.replace(self.shape, score_chunk=chunk)

    def prune_rungs(self) -> List[int]:
        """The survivor ladder ``prune_base · 2^i``, each rung rounded up to
        a multiple of the shard count: the rungs strictly below C and not
        below k_max (`PL.prune_rung` never picks those)."""
        ndev = len(self.mesh)
        rungs: List[int] = []
        r = max(int(self.shape.prune_base), 1)
        while True:
            ra = r + (-r) % ndev
            if ra >= self.C:
                return rungs
            if r >= self.k_max and ra not in rungs:
                rungs.append(ra)
            r *= 2

    def _rung(self, n_survivors: int) -> Optional[int]:
        """The rung of ``n_survivors`` (at least k_max), or None: scan."""
        return PL.prune_rung(max(n_survivors, self.k_max),
                             self.shape.prune_base, self.C, len(self.mesh))

    def _launch_lock(self):
        """`_MESH_DISPATCH_LOCK` on a sharded mesh, a no-op otherwise."""
        return (_MESH_DISPATCH_LOCK if len(self.mesh) > 1
                else contextlib.nullcontext())

    def source(self):
        """The stage-1 candidate source of the resolved ``candidates``
        choice (`repro_torch.engine.candidates`), built on first use; the
        inverted one builds its postings on the device."""
        if self._source is None:
            if self.candidates == "inverted":
                post = self._postings
                whole = self.shard.on(self.device)
                post = (build_postings(whole.key_hash, whole.mask)
                        if post is None else
                        Postings(keys=post.keys.to(self.device),
                                 cols=post.cols.to(self.device),
                                 used=post.used))
                self._source = CD.InvertedSource(post, C=self.C, n=self.n)
            else:
                self._source = CD.ScanSource(self.shard)
        return self._source

    # -- warmup --------------------------------------------------------------
    def _dummy_queries(self, B: int):
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=self.device)
        kh = torch.full((B, self.n), PAD_KEY - 2**32, dtype=torch.int32,
                        device=self.device)
        return kh, z(B, self.n), z(B, self.n), z(B), z(B)

    def warmup(self, modes: Optional[Sequence[str]] = None) -> None:
        """Build and load the kernels, run every plan of every requested
        prune mode (default: all) once per bucket — the scan, and for
        ``safe``/``topm`` the candidate source, every survivor rung of the
        pruned plan and, through the inverted source, of the fused plan —
        then time `COST_REPS` dispatches of each bucket (empty queries under
        the default request, in its prune mode when warmed) for
        `plan_batches`."""
        modes = tuple(modes) if modes is not None else PL.PRUNE_MODES
        for mode in modes:
            PL.request_operands(dataclasses.replace(self.request, prune=mode))
        for dev in set(self.mesh):
            K.load_kernels(dev)
        cost_req = (self.request if self.request.prune in modes else
                    dataclasses.replace(self.request, prune=modes[0]))
        ops = PL.request_operands(cost_req)
        inv = self.candidates == "inverted"
        for B in self.buckets:
            qa = self._dummy_queries(B)
            shape = self.shape_for(B)
            if "off" in modes or "safe" in modes or (inv and "topm" in modes):
                self._scan(qa, B, ops)
            if "topm" in modes and not inv:
                _host(PL.topm(*qa, self.shard, shape, ops))
            if "safe" in modes or "topm" in modes:
                src = self.source()
                src.warmup(B)
                for M in self.prune_rungs():
                    idx = torch.zeros((M,), dtype=torch.int32,
                                      device=self.device)
                    ok = torch.zeros((M,), dtype=torch.bool,
                                     device=self.device)
                    _host(PL.pruned(*qa, self.shard, idx, ok, shape, ops))
                    if "safe" in modes and inv:
                        _host(PL.inverted(*qa, self.shard, src.keys, src.cols,
                                          src.W, M, shape, ops))
            ts = []
            for _ in range(COST_REPS):
                t0 = time.perf_counter()
                self._serve(qa, B, B, cost_req, ops)
                ts.append(time.perf_counter() - t0)
            self._bucket_cost[B] = float(np.median(ts))

    # -- batching ------------------------------------------------------------
    def bucket_for(self, nq: int) -> int:
        """Smallest bucket covering ``nq`` queries (largest if none do)."""
        for b in self.buckets:
            if b >= nq:
                return b
        return self.buckets[-1]

    def plan_batches(self, nq: int) -> List[int]:
        """Cover ``nq`` queries with bucket dispatches of minimal measured
        cost; before `warmup`, greedy max-bucket slicing."""
        if not self._bucket_cost or nq <= 0:
            bmax = self.buckets[-1]
            full, tail = divmod(nq, bmax)
            return [bmax] * full + ([self.bucket_for(tail)] if tail else [])
        costs = tuple(sorted(self._bucket_cost.items()))
        return list(_plan_cover(nq, self.buckets, costs))

    # -- dispatch ------------------------------------------------------------
    def _stage(self, name: str, t0: float) -> None:
        """Count one run of stage ``name`` begun at ``t0`` (host clock)."""
        dt = time.perf_counter() - t0
        with self._tel_lock:
            self._stage_s[name] = self._stage_s.get(name, 0.0) + dt
            self._stage_n[name] = self._stage_n.get(name, 0) + 1

    def _scan(self, qa, B: int, ops):
        """The full scan of a bucket-B batch (direct, or the fallback of a
        survivor set no rung below C holds), as the plan gives it: ids of
        −inf rows are left as they are."""
        t0 = time.perf_counter()
        out = _host(PL.scan(*qa, self.shard, self.shape_for(B), ops))
        self._stage("scan", t0)
        return out

    def _serve(self, qa, nq: int, B: int, req: PL.Request, ops):
        """One padded bucket-B batch under ``req``'s prune mode; ``nq`` real
        rows. Results on the host; id −1 on −inf rows, except on the direct
        scan, which keeps the plan's ids (the reference's convention)."""
        inv = self.candidates == "inverted"
        if req.prune == "topm":
            if inv:
                return self._prune_and_score(qa, nq, B, req, ops, "topm")
            t0 = time.perf_counter()
            out = _host(PL.topm(*qa, self.shard, self.shape_for(B), ops))
            self._stage("topm", t0)
            return _drop_ineligible(*out)
        if req.prune == "safe":
            if inv and self.fused_safe:
                return self._dispatch_safe_fused(qa, B, ops)
            return self._prune_and_score(qa, nq, B, req, ops, "safe")
        return self._scan(qa, B, ops)

    def _prune_and_score(self, qa, nq: int, B: int, req: PL.Request, ops,
                         prune: str):
        """The two-dispatch path: source hit counts → host survivor
        selection over the ``nq`` real rows (bucket padding must not widen
        the set) → rung → pruned scoring, or the scan when no rung below C
        holds the survivors."""
        t0 = time.perf_counter()
        hits = self.source().hit_counts(qa)[:nq]
        self._stage("stage1", t0)
        t0 = time.perf_counter()
        surv = PL.select_survivors(hits, prune=prune,
                                   min_sample=req.min_sample,
                                   prune_m=self.shape.prune_m)
        rung = self._rung(len(surv))
        self._stage("select", t0)
        if rung is None:
            return _drop_ineligible(*self._scan(qa, B, ops))
        t0 = time.perf_counter()
        idx = np.zeros((rung,), np.int32)
        idx[:len(surv)] = surv
        valid = np.arange(rung) < len(surv)
        out = _host(PL.pruned(*qa, self.shard,
                              torch.from_numpy(idx).to(self.device),
                              torch.from_numpy(valid).to(self.device),
                              self.shape_for(B), ops))
        self._stage("stage2", t0)
        return _drop_ineligible(*out)

    def _dispatch_safe_fused(self, qa, B: int, ops):
        """``safe`` through the inverted source as one device dispatch
        (`PL.inverted`). It runs at the last sufficient rung (seeded at the
        base rung); when the survivor union overflows it (``n_surv > M``)
        it re-runs once at the exact covering rung — ``n_surv`` does not
        depend on M — and scans when the union outgrows the ladder.
        Bucket-padding rows copy the last real row, so they leave the
        union unchanged."""
        rungs = self.prune_rungs()
        if not rungs:
            return _drop_ineligible(*self._scan(qa, B, ops))
        src = self.source()
        M = self._fused_rung if self._fused_rung in rungs else rungs[0]
        for _ in range(2):
            t0 = time.perf_counter()
            *out, n = _host(PL.inverted(*qa, self.shard, src.keys, src.cols,
                                        src.W, M, self.shape_for(B), ops))
            self._stage("fused", t0)
            n = int(n)
            need = self._rung(n)
            if n <= M:
                self._fused_rung = need if need is not None else M
                return _drop_ineligible(*out)
            if need is None:
                break               # the union outgrew the ladder: scan
            self._fused_rung = M = need
        return _drop_ineligible(*self._scan(qa, B, ops))

    def _pad(self, qa, nq: int, B: int):
        """Pad a ≤B slice of query arrays to the bucket with copies of its
        last row (the s4 normalisation is per row, so they cannot perturb
        real rows)."""
        if B == nq:
            return qa
        return tuple(torch.cat([a, a[nq - 1:nq].expand((B - nq,) + a.shape[1:])])
                     for a in qa)

    def _dispatch(self, qa, nq: int, B: int, req: PL.Request, ops):
        """Pad a ≤B slice of queries to the bucket, serve, slice back. A
        two-stage request counts as one dispatch."""
        qa = self._pad(qa, nq, B)
        with self._launch_lock():
            t0 = time.perf_counter()
            out = self._serve(qa, nq, B, req, ops)
            dt = time.perf_counter() - t0
        with self._tel_lock:
            self.dispatch_log.append((B, nq, dt))
            self._total_queries += nq
            self._total_dispatches += 1
            self._total_s += dt
        return tuple(o[:nq] for o in out)

    # -- queries -------------------------------------------------------------
    def query_batch(self, sketches: CorrelationSketch, req: PL.Request):
        """Serve query sketches (leading [NQ] axis) under ``req`` →
        ``[NQ, min(req.k, k_max)]`` numpy (scores, shard-local ids, r, m),
        each row score descending then id ascending; id −1 where the score
        is −inf, except on the direct scan (`_serve`)."""
        ops = PL.request_operands(req)
        qa = tuple(a.to(self.device) for a in query_arrays(sketches))
        nq = int(qa[0].shape[0])
        k = min(int(req.k), self.k_max)
        parts, s = [], 0
        for B in self.plan_batches(nq):
            e = min(s + B, nq)
            parts.append(self._dispatch(tuple(a[s:e] for a in qa), e - s, B,
                                        req, ops))
            s = e
        if not parts:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32),
                    np.zeros((0, k), np.float32), np.zeros((0, k), np.float32))
        return tuple(np.concatenate(p)[:, :k] for p in zip(*parts))

    # -- joinability (stage 1 as a workload) ---------------------------------
    def key_minima(self) -> KeyMinima:
        """The index's KMV key-minima layout (`engine.index.key_minima`)
        and its D̂_C estimates, built on first use."""
        if self._minima is None:
            self._minima = key_minima(self.shard.on(self.device))
            self._minima_dc = CT.distinct_from_minima(
                self._minima.count, self._minima.tau, self.n)
        return self._minima

    def _hits(self, sketches: CorrelationSketch) -> np.ndarray:
        """Exact hit counts ``[NQ, C]`` (padding columns included) from the
        candidate source, in bucket-padded batches."""
        qa = tuple(a.to(self.device) for a in query_arrays(sketches))
        nq = int(qa[0].shape[0])
        rows, s = [np.zeros((0, self.C), np.float32)], 0
        while s < nq:
            B = self.bucket_for(min(nq - s, self.buckets[-1]))
            e = min(s + B, nq)
            part = self._pad(tuple(a[s:e] for a in qa), e - s, B)
            with self._launch_lock():
                t0 = time.perf_counter()
                rows.append(self.source().hit_counts(part)[:e - s])
                self._stage("stage1", t0)
            s = e
        return np.concatenate(rows, axis=0)

    def search_joinable_sketches(self, sketches: CorrelationSketch, *,
                                 k: int, metric: str, alpha: float
                                 ) -> JoinabilityResult:
        """Top-k joinable columns of pre-built query sketches: stage-1 hit
        counts → `repro_torch.core.containment` estimates with Hoeffding
        CIs at ``alpha`` → ranked by ``metric`` (descending; ties to the
        lower id). Columns with no key overlap never appear; short rows pad
        with id −1."""
        hits = self._hits(sketches)
        nq = hits.shape[0]
        minima = self.key_minima()
        q_kh = sketches.key_hash.cpu().numpy()
        q_mask = sketches.mask.cpu().numpy()
        out = {f: np.zeros((nq, k), np.float32)
               for f in JoinabilityResult._FIELDS}
        out["ids"] = np.full((nq, k), -1, np.int32)
        for i in range(nq):
            est = CT.joinability_estimates(
                hits[i], CT.query_minima(q_kh[i], q_mask[i]),
                minima.count, minima.tau, self.n,
                cand_distinct=self._minima_dc, alpha=alpha)
            score = np.asarray(getattr(est, metric), np.float32)
            ok = est.hits > 0
            order = np.lexsort((np.arange(score.shape[0]),
                                np.where(ok, -score, np.inf)))[:k]
            order = order[ok[order]]
            kk = order.shape[0]
            out["ids"][i, :kk] = order
            out["score"][i, :kk] = score[order]
            for f in JoinabilityResult._FIELDS[2:]:
                out[f][i, :kk] = np.asarray(getattr(est, f),
                                            np.float32)[order]
        return JoinabilityResult(**out)

    # -- telemetry -----------------------------------------------------------
    def stage_stats(self) -> Tuple[Dict[str, float], Dict[str, int]]:
        """A consistent copy of ``({stage: seconds}, {stage: count})``."""
        with self._tel_lock:
            return dict(self._stage_s), dict(self._stage_n)

    def throughput(self) -> dict:
        """Lifetime totals (queries, dispatches, seconds, qps), dispatch
        latency percentiles over the recent-dispatch window, and the
        per-stage breakdown: ``stages[name] = {count, total_s}`` and
        ``device_dispatches``, the count of device stages."""
        stage_s, stage_n = self.stage_stats()
        with self._tel_lock:
            log = list(self.dispatch_log)
            queries, dispatches = self._total_queries, self._total_dispatches
            total_s = self._total_s
        stages = _stage_table(stage_s, stage_n)
        devd = sum(stage_n.get(name, 0) for name in _DEVICE_STAGES)
        if not queries:
            return dict(queries=0, dispatches=0, total_s=0.0, qps=0.0,
                        dispatch_p50_ms=0.0, dispatch_p90_ms=0.0,
                        dispatch_p99_ms=0.0, per_query_ms=0.0,
                        stages=stages, device_dispatches=devd)
        lat_ms = np.array([t * 1e3 for _, _, t in log])
        return dict(
            queries=queries, dispatches=dispatches, total_s=total_s,
            qps=queries / max(total_s, 1e-12),
            dispatch_p50_ms=float(np.percentile(lat_ms, 50)),
            dispatch_p90_ms=float(np.percentile(lat_ms, 90)),
            dispatch_p99_ms=float(np.percentile(lat_ms, 99)),
            per_query_ms=1e3 * total_s / queries,
            stages=stages, device_dispatches=devd)


@dataclasses.dataclass(frozen=True)
class _SegEntry:
    """One segment of a published segment map. Frozen: `Server.refresh`
    never mutates an entry a dispatch may be reading; a segment whose
    global-id ``base`` moved is republished as a new entry sharing the old
    executor."""
    sid: int
    version: int
    base: int       # global-id offset (cumulative used slots before it)
    used: int
    exec: _SegmentExec


class Server:
    """Serves join-correlation queries against a `SketchIndex` (one
    segment), an already placed `IndexShard` or `MeshShard` (one segment;
    ``index`` gives its catalog, else `names` is empty) or a
    `repro_torch.engine.lifecycle.LiveIndex` (one executor per segment,
    `refresh` picking up its mutations).

    ``mesh`` (a sequence of devices, `repro_torch.launch.mesh`) shards
    every segment's columns over its devices; ``device`` means a one-device
    mesh and defaults to the CUDA card (raising when there is none).
    ``policy`` is the `ShapePolicy` (its mesh fields resolved against the
    mesh, `plans.resolve_shape`) or a legacy `repro_torch.engine.query.
    QueryConfig`, split by `plans.split_config` (its request is the
    default unless ``request`` is given); ``request`` the default
    `Request` — every query method takes a per-call ``request=`` override.
    ``batch_rows`` is each executor's block-row budget (`BLOCK_ROWS`).
    ``candidates="auto"`` resolves per segment against its column count.
    Results combine across segments deterministically (score descending,
    global id ascending, id −1 on −inf rows) into ``[NQ, request.k]``
    numpy arrays whose ids index `names`. Over a static index, the single
    executor's attributes (``shard``, ``C``, ``k_max``, ``candidates``,
    ``source()``, ``dispatch_log``, …) read through the facade.
    """

    def __init__(self, source, policy=None, *,
                 request: Optional[PL.Request] = None,
                 buckets: Sequence[int] = (1, 8, 32),
                 device: D.DeviceLike = None, mesh=None,
                 batch_rows: Optional[int] = None,
                 index: Optional[SketchIndex] = None):
        from repro_torch.engine import lifecycle as LC
        self.mesh = MS.as_mesh(mesh, device)
        self.device = self.mesh[0]
        if isinstance(policy, Q.QueryConfig):
            policy, req0 = PL.split_config(policy)
            request = request if request is not None else req0
        self.shape = PL.resolve_shape(
            policy if policy is not None else PL.ShapePolicy(), self.mesh)
        self._batch_rows = batch_rows
        self.request = request if request is not None else PL.Request()
        PL.request_operands(self.request)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f"buckets must be positive sizes: {buckets}")
        self._fused_safe = True
        #: the published segment map: an immutable tuple of frozen entries.
        #: Queries read it once per call, and `refresh` swaps in a complete
        #: replacement by one assignment, so a query sees one index version
        #: (global-id bases included), never a mixture.
        self._view: Tuple[_SegEntry, ...] = ()
        self.names: List[str] = []
        self._seen_version = -1
        #: serialises refresh; queries never take it
        self._refresh_lock = threading.RLock()
        #: guards the request counters and the retired executors' totals
        self._stats_lock = threading.Lock()
        #: measured bucket costs per segment capacity: a new executor of a
        #: known capacity plans with them without warming up
        self._cap_costs: Dict[int, Dict[int, float]] = {}
        self._q_total = 0
        self._q_seconds = 0.0
        self._retired_dispatches = 0
        self._retired_stage_s: Dict[str, float] = {}
        self._retired_stage_n: Dict[str, int] = {}
        #: the `repro_torch.engine.scheduler.AsyncScheduler` attached to
        #: this server, whose queue counters `throughput` reports
        self._scheduler = None
        if isinstance(source, LC.LiveIndex):
            self._live = source
            self.n = source.n
            self.refresh()
        else:
            self._live = None
            if isinstance(source, SketchIndex):
                index = index if index is not None else source
                shard = source.shard
            else:
                shard = source    # an IndexShard or MeshShard, placed
            self.n = int(PL.as_mesh_shard(shard).blocks[0].key_hash.shape[1])
            ex = self._make_exec(shard)
            used = len(index.names) if index is not None else ex.C
            self._view = (_SegEntry(sid=0, version=0, base=0, used=used,
                                    exec=ex),)
            self.names = list(index.names) if index is not None else []

    def __getattr__(self, name):
        # the single executor's attributes, for a static index
        view = self.__dict__.get("_view")
        if self.__dict__.get("_live", 0) is None and view:
            return getattr(view[0].exec, name)
        raise AttributeError(name)

    @property
    def fused_safe(self) -> bool:
        """Whether inverted ``safe`` requests take the fused one-dispatch
        plan (False: the two-dispatch path; the same survivors)."""
        return self._fused_safe

    @fused_safe.setter
    def fused_safe(self, value: bool) -> None:
        self._fused_safe = bool(value)
        for e in self._view:
            e.exec.fused_safe = self._fused_safe

    # -- segment sync --------------------------------------------------------
    def _make_exec(self, shard: IndexShard,
                   postings: Optional[Postings] = None) -> _SegmentExec:
        ex = _SegmentExec(shard, self.n, self.shape, request=self.request,
                          buckets=self.buckets, mesh=self.mesh,
                          postings=postings, batch_rows=self._batch_rows)
        ex._bucket_cost = dict(self._cap_costs.get(ex.C, {}))
        ex.fused_safe = self._fused_safe
        return ex

    def _padded(self, capacity: int) -> int:
        """A segment's column count once placed over the mesh."""
        return capacity + (-capacity) % len(self.mesh)

    def _inverted(self, capacity: int) -> bool:
        return PL.resolve_candidates(self.shape.candidates,
                                     self._padded(capacity)) == "inverted"

    def refresh(self) -> None:
        """Sync with a live index: place new and changed segments over the
        mesh, drop removed ones, rebuild the global-id catalog. A no-op
        for a static index, and free when the index's version has not
        moved. The index lock is held only to snapshot the changed
        segments' host state; placement happens after it is released."""
        if self._live is None or self._live.version == self._seen_version:
            return
        with self._refresh_lock:
            if self._live.version == self._seen_version:
                return
            old = {e.sid: e for e in self._view}
            with self._live._lock:
                ver = self._live.version
                snaps = []
                for seg in self._live._segs:
                    prev = old.get(seg.sid)
                    fresh = prev is None or prev.version != seg.version
                    inv = self._inverted(seg.capacity)
                    if fresh and inv:
                        seg.postings()   # maintained from here on
                    snaps.append((seg.sid, seg.version, seg.used,
                                  list(seg.names[:seg.used]),
                                  seg.host_snapshot() if fresh else None,
                                  inv))
            entries: List[_SegEntry] = []
            names: List[str] = []
            base = 0
            for sid, version, used, seg_names, snap, inv in snaps:
                if snap is None:
                    e = old[sid]
                    e = e if e.base == base else dataclasses.replace(
                        e, base=base)
                else:
                    e = _SegEntry(sid=sid, version=version, base=base,
                                  used=used, exec=self._make_exec(
                                      snap.to_index_shard(),
                                      snap.postings() if inv else None))
                entries.append(e)
                names.extend(seg_names)
                base += used
            kept = {id(e.exec) for e in entries}
            gone = [e.exec for e in old.values() if id(e.exec) not in kept]
            with self._stats_lock:
                for ex in gone:
                    self._retired_dispatches += ex._total_dispatches
                    ss, sn = ex.stage_stats()
                    for k, v in ss.items():
                        self._retired_stage_s[k] = \
                            self._retired_stage_s.get(k, 0.0) + v
                    for k, v in sn.items():
                        self._retired_stage_n[k] = \
                            self._retired_stage_n.get(k, 0) + v
            self.names = names
            self._view = tuple(entries)
            self._seen_version = ver

    # -- warmup --------------------------------------------------------------
    def warmup(self, modes: Optional[Sequence[str]] = None,
               include_ladder: bool = True) -> None:
        """Build and load the kernels and warm every segment's plans for
        the prune ``modes`` (default all), keeping each capacity's bucket
        costs. ``include_ladder`` (live index) also warms empty segments of
        the capacities the next mutations will bring: the delta capacity
        and the rung a `compact` would land on."""
        from repro_torch.engine import lifecycle as LC
        warmed = set()
        for e in self._view:
            e.exec.warmup(modes)
            self._cap_costs[e.exec.C] = dict(e.exec._bucket_cost)
            warmed.add(e.exec.C)
        if self._live is not None and include_ladder:
            ahead = {self._live.delta_cap,
                     LC.ladder_rung(self._live.live_columns(),
                                    self._live.delta_cap)}
            for cap in sorted(c for c in ahead
                              if self._padded(c) not in warmed):
                empty = LC.Segment.empty(-1, cap, self.n, self._live.agg,
                                         self._live.device)
                ex = self._make_exec(
                    empty.to_index_shard(),
                    empty.postings() if self._inverted(cap) else None)
                ex.warmup(modes)
                self._cap_costs[ex.C] = dict(ex._bucket_cost)

    # -- queries -------------------------------------------------------------
    def plan_batches(self, nq: int) -> List[int]:
        """The first segment's bucket cover of ``nq`` queries (every
        segment plans its own at dispatch time)."""
        view = self._view
        return view[0].exec.plan_batches(nq) if view else []

    def query_batch(self, sketches: CorrelationSketch, *,
                    request: Optional[PL.Request] = None,
                    refresh: bool = True):
        """Serve query sketches (leading [NQ] axis) against every segment
        → ``[NQ, k]`` numpy (scores, ids, r, m); ids index `names`, −1
        where the score is −inf; ties in score go to the lower id."""
        req = request if request is not None else self.request
        if req.k > self.shape.k_max:
            raise ValueError(f"request k={req.k} exceeds ShapePolicy.k_max="
                             f"{self.shape.k_max}; raise k_max or lower k")
        PL.request_operands(req)
        if refresh:
            self.refresh()
        t0 = time.perf_counter()
        view = self._view
        nq = int(sketches.key_hash.shape[0])
        k = int(req.k)
        out = (np.full((nq, k), -np.inf, np.float32),
               np.full((nq, k), -1, np.int32),
               np.zeros((nq, k), np.float32), np.zeros((nq, k), np.float32))
        parts = []
        for e in view:
            if e.used and nq:
                s, g, r, m = e.exec.query_batch(sketches, req)
                # slots past the used ones (a segment's free tail, the
                # mesh's pad columns) rank last and are never returned
                s = np.where(g < e.used, s, -np.inf).astype(np.float32)
                parts.append((s, g + e.base, r, m))
        if parts:
            sc, g, r, m = (np.concatenate(p, axis=1) for p in zip(*parts))
            pick = np.lexsort((g, -sc), axis=1)[:, :k]
            sc, g, r, m = (np.take_along_axis(x, pick, axis=1)
                           for x in (sc, g, r, m))
            kk = sc.shape[1]
            fin = np.isfinite(sc)
            out[0][:, :kk] = sc
            out[1][:, :kk] = np.where(fin, g, -1)
            out[2][:, :kk] = np.where(fin, r, 0.0)
            out[3][:, :kk] = np.where(fin, m, 0.0)
        with self._stats_lock:
            self._q_total += nq
            self._q_seconds += time.perf_counter() - t0
        return out

    def query_columns(self, keys_list, values_list, *, chunk: int = 8192,
                      request: Optional[PL.Request] = None,
                      refresh: bool = True):
        """Raw query columns → sketches on the server's device → top-k."""
        sks = build_query_sketches(keys_list, values_list, n=self.n,
                                   chunk=chunk, device=self.device)
        return self.query_batch(sks, request=request, refresh=refresh)

    # -- joinability (stage 1 as a workload) ---------------------------------
    def stage1_hits(self, sketches: CorrelationSketch, *,
                    refresh: bool = True) -> np.ndarray:
        """Exact per-candidate sketch-intersection sizes ``[NQ, C]`` of
        query sketches over every segment's used slots (ids index
        `names`; tombstoned columns count 0)."""
        if refresh:
            self.refresh()
        parts = [e.exec._hits(sketches)[:, :e.used] for e in self._view]
        nq = int(sketches.key_hash.shape[0])
        return (np.concatenate(parts, axis=1) if parts
                else np.zeros((nq, 0), np.float32))

    def search_joinable_sketches(self, sketches: CorrelationSketch, *,
                                 k: Optional[int] = None,
                                 metric: str = "containment",
                                 request: Optional[PL.Request] = None,
                                 refresh: bool = True) -> JoinabilityResult:
        """Top-k joinable columns of pre-built query sketches across every
        segment: per-segment stage-1 counts → `repro_torch.core.
        containment` estimates with Hoeffding CIs (at the request's α) →
        ranked by ``metric`` (one of `JOIN_METRICS`, descending; ties to
        the lower global id). Columns with no key overlap, tombstoned ones
        among them, never appear; short rows pad with id −1."""
        if metric not in JOIN_METRICS:
            raise ValueError(f"unknown joinability metric {metric!r}: "
                             f"use one of {JOIN_METRICS}")
        req = request if request is not None else self.request
        if refresh:
            self.refresh()
        k = int(k or req.k)
        nq = int(sketches.key_hash.shape[0])
        fields = JoinabilityResult._FIELDS
        parts = []
        for e in self._view:
            if e.used:
                res = e.exec.search_joinable_sketches(
                    sketches, k=k, metric=metric, alpha=req.alpha)
                parts.append(dataclasses.replace(res, ids=np.where(
                    res.ids >= 0, res.ids + e.base, -1).astype(np.int32)))
        if not parts:
            out = {f: np.zeros((nq, k), np.float32) for f in fields}
            out["ids"] = np.full((nq, k), -1, np.int32)
            return JoinabilityResult(**out)
        cat = {f: np.concatenate([getattr(p, f) for p in parts], axis=1)
               for f in fields}
        ok = cat["ids"] >= 0
        pick = np.lexsort((np.where(ok, cat["ids"], np.iinfo(np.int32).max),
                           np.where(ok, -cat["score"], np.inf)),
                          axis=1)[:, :k]
        valid = np.take_along_axis(ok, pick, axis=1)
        out = {}
        for f in fields:
            taken = np.take_along_axis(cat[f], pick, axis=1)
            out[f] = (np.where(valid, taken, -1).astype(np.int32)
                      if f == "ids" else np.where(valid, taken, 0.0))
        return JoinabilityResult(**out)

    def search_joinable(self, keys_list, *, k: Optional[int] = None,
                        metric: str = "containment", chunk: int = 8192,
                        request: Optional[PL.Request] = None,
                        refresh: bool = True) -> JoinabilityResult:
        """Top-k joinable columns for raw query key columns (joinability
        needs no values)."""
        values = [np.zeros((len(kz),), np.float32) for kz in keys_list]
        sks = build_query_sketches(keys_list, values, n=self.n, chunk=chunk,
                                   device=self.device)
        return self.search_joinable_sketches(sks, k=k, metric=metric,
                                             request=request,
                                             refresh=refresh)

    # -- telemetry -----------------------------------------------------------
    def throughput(self) -> dict:
        """Serving telemetry. A static index reports its executor's
        dispatch-level numbers (latency percentiles included). A live index
        counts logical queries (one per query, however many segments it
        fans out to) in ``queries``/``qps`` and the segment dispatches of
        live and retired executors in ``dispatches`` and ``stages``. With
        a scheduler attached, its ``queue_depth`` and ``deadline_misses``
        join them."""
        out = (self._view[0].exec.throughput() if self._live is None
               else self._live_throughput())
        sched = self._scheduler
        if sched is not None:
            out.update(sched.queue_stats())
        return out

    def _live_throughput(self) -> dict:
        view = self._view
        with self._stats_lock:
            q_total, q_seconds = self._q_total, self._q_seconds
            dispatches = self._retired_dispatches
            stage_s = dict(self._retired_stage_s)
            stage_n = dict(self._retired_stage_n)
        for e in view:
            ss, sn = e.exec.stage_stats()
            for k, v in ss.items():
                stage_s[k] = stage_s.get(k, 0.0) + v
            for k, v in sn.items():
                stage_n[k] = stage_n.get(k, 0) + v
            dispatches += e.exec._total_dispatches
        return dict(queries=q_total, dispatches=dispatches,
                    total_s=q_seconds, qps=q_total / max(q_seconds, 1e-12),
                    segments=len(view), stages=_stage_table(stage_s, stage_n),
                    device_dispatches=sum(stage_n.get(name, 0)
                                          for name in _DEVICE_STAGES))


# ----------------------------------------------------------------------------
# deprecated alias: the reference's single-index server
# ----------------------------------------------------------------------------

class QueryServer(Server):
    """Deprecated alias of `Server` for a static, already placed
    `IndexShard` or `MeshShard` under a legacy `repro_torch.engine.query.
    QueryConfig`, with the reference's conventions: `query_batch` returns
    the executor's raw output (no cross-segment combine; on the full scan
    the ids of −inf rows are the plan's, not −1), `warmup` warms only
    ``qcfg.prune``, and ``qcfg_for`` / ``query_fn`` / ``stage1_fn`` /
    ``stage2_fn`` / ``topm_fn`` give the per-bucket config and plans.
    ``mesh`` is a sequence of devices (None: the one-device mesh of
    ``device``, the CUDA card by default); ``index`` gives the catalog.
    The reference's ``cache=`` and ``prep=`` name its compiled-program
    cache and XLA sort tables, which the port does not have: the
    constructor does not take them, so passing one raises TypeError."""

    def __init__(self, mesh, shard, qcfg, buckets: Sequence[int] = (1, 8, 32),
                 *, index: Optional[SketchIndex] = None,
                 batch_rows: Optional[int] = None,
                 device: D.DeviceLike = None):
        warnings.warn(
            "repro_torch.engine.serve.QueryServer is deprecated; use "
            "repro_torch.engine.serve.Server (one facade for static and "
            "live indexes, per-request semantics)",
            DeprecationWarning, stacklevel=2)
        super().__init__(shard, qcfg, buckets=buckets, mesh=mesh,
                         device=device, batch_rows=batch_rows, index=index)
        self.qcfg = qcfg

    @property
    def _exec(self) -> _SegmentExec:
        return self._view[0].exec

    def qcfg_for(self, B: int):
        """The bucket-B config: ``score_chunk`` as `chunk_for` sets it."""
        chunk = self._exec.chunk_for(B)
        if chunk == self.qcfg.score_chunk:
            return self.qcfg
        return dataclasses.replace(self.qcfg, score_chunk=chunk)

    def query_fn(self, B: int):
        """The bucket-B scan plan (`plans.make_scan_fn`)."""
        return PL.make_scan_fn(self.mesh, self.C, self.n,
                               self._exec.shape_for(B), batch=B)

    def stage1_fn(self, B: int, emit_tables: bool = False):
        """The bucket-B stage-1 plan (`plans.make_probe_fn`)."""
        return PL.make_probe_fn(self.mesh, self.C, self.n,
                                self._exec.shape_for(B), batch=B,
                                emit_tables=emit_tables)

    def stage2_fn(self, B: int, M: int):
        """The bucket-B stage-2 plan at rung ``M`` (`plans.make_pruned_fn`)."""
        return PL.make_pruned_fn(self.mesh, self.C, self.n,
                                 self._exec.shape_for(B), M, batch=B)

    def topm_fn(self, B: int):
        """The bucket-B ``topm`` plan (`plans.make_topm_fn`)."""
        return PL.make_topm_fn(self.mesh, self.C, self.n,
                               self._exec.shape_for(B), batch=B)

    def warmup(self, modes: Optional[Sequence[str]] = None) -> None:
        """Warm ``modes`` (default: only the config's prune mode)."""
        super().warmup(modes=modes if modes is not None
                       else (self.request.prune,))

    def query_batch(self, sketches: CorrelationSketch, *,
                    request: Optional[PL.Request] = None):
        """The executor's raw ``[NQ, min(k, k_max)]`` numpy results (ids of
        −inf rows as the full scan gives them; −1 on the pruned paths)."""
        return self._exec.query_batch(
            sketches, request if request is not None else self.request)

    def query_columns(self, keys_list, values_list, *, chunk: int = 8192,
                      request: Optional[PL.Request] = None):
        sks = build_query_sketches(keys_list, values_list, n=self.n,
                                   chunk=chunk, device=self.device)
        return self.query_batch(sks, request=request)

    def stage1_hits(self, sketches: CorrelationSketch) -> np.ndarray:
        """Exact hit counts ``[NQ, C]`` over every (padded) column."""
        return self._exec._hits(sketches)
