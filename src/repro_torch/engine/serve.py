"""Request serving over a static sketch index on one device (DESIGN.md §6).

`Server` answers join-correlation queries against one `SketchIndex`:

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
    so the ``[B, chunk, nq]`` aligned tensors stay bounded.

Request semantics (k, estimator, scorer, α, floor) are per call; results
come back as numpy ``[NQ, k]`` arrays (scores, ids into ``names``, r, m),
ordered score descending then id ascending, with id −1 where no candidate
is eligible.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import hashing
from repro_torch.core.sketch import (PAD_KEY, Agg, CorrelationSketch,
                                     build_sketch, merge)
from repro_torch.engine import plans as PL
from repro_torch.engine.index import SketchIndex, query_arrays
from repro_torch.kernels import ops as K

#: rows (bucket B × candidates) of one scored block: bucket B scores
#: min(score_chunk, max(64, BLOCK_ROWS // B)) candidates at a time, which
#: bounds its [B, chunk, nq] aligned and hit planes
BLOCK_ROWS = 4096
#: timed dispatches per bucket in `Server.warmup`
COST_REPS = 2


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


class Server:
    """Serves join-correlation queries against one static index.

    ``device`` defaults to the CUDA card (raising when there is none); the
    index planes are moved there once. ``policy`` is the `ShapePolicy`,
    ``request`` the default `Request` — every query method takes a per-call
    ``request=`` override.
    """

    def __init__(self, index: SketchIndex,
                 policy: Optional[PL.ShapePolicy] = None, *,
                 request: Optional[PL.Request] = None,
                 buckets: Sequence[int] = (1, 8, 32),
                 device: D.DeviceLike = None):
        self.device = D.resolve(device)
        self.shard = index.shard.to(self.device)
        self.names = list(index.names)
        self.n = index.n
        self.C = self.shard.num_columns
        shape = policy if policy is not None else PL.ShapePolicy()
        if shape.k_max > self.C:  # a corpus smaller than k_max still serves
            shape = dataclasses.replace(shape, k_max=self.C)
        self.shape = shape
        self.k_max = shape.k_max
        self.request = request if request is not None else PL.Request()
        PL.request_operands(self.request)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f"buckets must be positive sizes: {buckets}")
        #: measured seconds per dispatch for each bucket (filled by warmup)
        self._bucket_cost = {}
        #: per-dispatch telemetry (bucket B, real queries, seconds), bounded
        self.dispatch_log: Deque[Tuple[int, int, float]] = deque(maxlen=4096)
        self._total_queries = 0
        self._total_dispatches = 0
        self._total_s = 0.0

    # -- shape policy per bucket ---------------------------------------------
    def chunk_for(self, B: int) -> int:
        """Bucket-B score_chunk: shrunk toward `BLOCK_ROWS` (floored at 64,
        never raised above the configured value)."""
        return min(self.shape.score_chunk, max(64, BLOCK_ROWS // B))

    def shape_for(self, B: int) -> PL.ShapePolicy:
        chunk = self.chunk_for(B)
        if chunk == self.shape.score_chunk:
            return self.shape
        return dataclasses.replace(self.shape, score_chunk=chunk)

    # -- warmup --------------------------------------------------------------
    def _dummy_queries(self, B: int):
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=self.device)
        kh = torch.full((B, self.n), PAD_KEY - 2**32, dtype=torch.int32,
                        device=self.device)
        return kh, z(B, self.n), z(B, self.n), z(B), z(B)

    def warmup(self) -> None:
        """Build and load the kernels, run every bucket once, then time
        `COST_REPS` dispatches of each (empty queries under the default
        request) for `plan_batches`."""
        K.load_kernels(self.device)
        ops = PL.request_operands(self.request)
        for B in self.buckets:
            qa = self._dummy_queries(B)
            self._run(qa, B, ops)
            ts = []
            for _ in range(COST_REPS):
                t0 = time.perf_counter()
                self._run(qa, B, ops)
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
    def _run(self, qa, B: int, ops):
        """One bucket-B scan, results on the host (which waits for it)."""
        out = PL.scan(*qa, self.shard, self.shape_for(B), ops)
        return tuple(o.cpu().numpy() for o in out)

    def _dispatch(self, qa, nq: int, B: int, ops):
        """Pad a ≤B slice of queries to the bucket, scan, slice back."""
        pad = B - nq
        if pad:
            qa = tuple(torch.cat([a, a[nq - 1:nq].expand((pad,) + a.shape[1:])])
                       for a in qa)
        t0 = time.perf_counter()
        out = self._run(qa, B, ops)
        dt = time.perf_counter() - t0
        self.dispatch_log.append((B, nq, dt))
        self._total_queries += nq
        self._total_dispatches += 1
        self._total_s += dt
        return tuple(o[:nq] for o in out)

    # -- queries -------------------------------------------------------------
    def query_batch(self, sketches: CorrelationSketch, *,
                    request: Optional[PL.Request] = None):
        """Serve query sketches (leading [NQ] axis) → ``[NQ, k]`` numpy
        (scores, ids, r, m); ids index `names`, −1 where the score is −inf."""
        req = request if request is not None else self.request
        if req.k > self.shape.k_max:
            raise ValueError(f"request k={req.k} exceeds ShapePolicy.k_max="
                             f"{self.shape.k_max}; raise k_max or lower k")
        ops = PL.request_operands(req)
        qa = tuple(a.to(self.device) for a in query_arrays(sketches))
        nq = int(qa[0].shape[0])
        k = int(req.k)
        out = (np.full((nq, k), -np.inf, np.float32),
               np.full((nq, k), -1, np.int32),
               np.zeros((nq, k), np.float32), np.zeros((nq, k), np.float32))
        if nq == 0:
            return out
        parts, s = [], 0
        for B in self.plan_batches(nq):
            e = min(s + B, nq)
            parts.append(self._dispatch(tuple(a[s:e] for a in qa), e - s, B,
                                        ops))
            s = e
        sc, g, r, m = (np.concatenate(p)[:, :k] for p in zip(*parts))
        kk = sc.shape[1]
        fin = np.isfinite(sc)
        out[0][:, :kk] = sc
        out[1][:, :kk] = np.where(fin, g, -1)
        out[2][:, :kk] = np.where(fin, r, 0.0)
        out[3][:, :kk] = np.where(fin, m, 0.0)
        return out

    def query_columns(self, keys_list, values_list, *, chunk: int = 8192,
                      request: Optional[PL.Request] = None):
        """Raw query columns → sketches on the server's device → top-k."""
        sks = build_query_sketches(keys_list, values_list, n=self.n,
                                   chunk=chunk, device=self.device)
        return self.query_batch(sks, request=request)

    # -- telemetry -----------------------------------------------------------
    def throughput(self) -> dict:
        """Lifetime totals (queries, dispatches, seconds, qps) and dispatch
        latency percentiles over the recent-dispatch window."""
        if not self._total_queries:
            return dict(queries=0, dispatches=0, total_s=0.0, qps=0.0,
                        dispatch_p50_ms=0.0, dispatch_p90_ms=0.0,
                        dispatch_p99_ms=0.0, per_query_ms=0.0)
        lat_ms = np.array([t * 1e3 for _, _, t in self.dispatch_log])
        return dict(
            queries=self._total_queries, dispatches=self._total_dispatches,
            total_s=self._total_s,
            qps=self._total_queries / max(self._total_s, 1e-12),
            dispatch_p50_ms=float(np.percentile(lat_ms, 50)),
            dispatch_p90_ms=float(np.percentile(lat_ms, 90)),
            dispatch_p99_ms=float(np.percentile(lat_ms, 99)),
            per_query_ms=1e3 * self._total_s / self._total_queries)
