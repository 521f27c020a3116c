"""Index ingest: sketch the columns of many ingest sources in batched
device launches (the §3.4 streaming build).

A source is a `Table` (one column) or a `TableGroup` (C columns sharing one
join-key column). Consecutive sources are packed into one ``[columns, rows]``
batch, each padded to the batch's longest row count with invalid rows, and
sketched chunk by chunk, the chunk sketches folded with `merge`. Each
column's sketch equals what `build_sketch_streaming` gives for it alone:
padding rows are invalid, and chunks see the same global row order — so
which sources share a batch changes no result.

Two engines build a chunk, bit-identical to each other:

* ``"fused"`` (the default, the reference's fused ingest) — a source's
  32-bit join keys are hashed once for all its columns by the `hash_build`
  kernel (`repro_torch.kernels.ops.hash_build`; 64-bit keys by
  `hashing.murmur3_32`), and each chunk of a key column is sorted once by
  (Fibonacci hash, row order) for all its columns
  (`core.sketch._build_cols_from_hashed`);
* ``"loop"`` — the per-column path: every column sorts its own chunk
  (`build_sketch`).

`tree_merge` folds stacked partial sketches in log₂(P) rounds: the fold of
the live index's compaction, and of `distributed_build_table`, the
row-sharded build over a device mesh.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import hashing
from repro_torch.core.sketch import (Agg, CorrelationSketch,
                                     _build_cols_from_hashed, build_sketch,
                                     merge)
from repro_torch.data.pipeline import TableGroup
from repro_torch.kernels import ops as K

#: the ingest engines (`sketch_source`)
ENGINES = ("fused", "loop")
#: chunk rows per build step (the paper's streaming granularity)
DEFAULT_CHUNK = 65536

#: column × row elements per batched build: bounds the device memory of one
#: batch (a few hundred bytes per element across the sort intermediates)
BUILD_ELEMS = 1 << 24


def source_names(t, index: int = 0) -> List[str]:
    """Column names contributed by one ingest source; positional defaults
    use the global source index so ids never collide."""
    if isinstance(t, TableGroup):
        return [t.column_name(c) for c in range(t.num_columns)]
    return [t.name or f"col{index}"]


def _values_2d(t) -> np.ndarray:
    v = np.asarray(t.values, np.float32)
    return v if isinstance(t, TableGroup) else v[None, :]


def _key_width(t) -> int:
    return 8 if np.asarray(t.keys).dtype.itemsize == 8 else 4


def _batches(sources: Sequence) -> List[List]:
    """Greedy packing of consecutive sources of equal key width into
    batches of at most `BUILD_ELEMS` padded elements (a larger source
    forms a batch of its own)."""
    out: List[List] = []
    cur: List = []
    cols = rows = 0
    for t in sources:
        c, m = _values_2d(t).shape
        if cur and (_key_width(t) != _key_width(cur[0])
                    or (cols + c) * max(rows, m) > BUILD_ELEMS):
            out.append(cur)
            cur, cols, rows = [], 0, 0
        cur.append(t)
        cols += c
        rows = max(rows, m)
    if cur:
        out.append(cur)
    return out


def check_engine(engine: str) -> None:
    """Raise unless ``engine`` is one of `ENGINES`."""
    if engine not in ENGINES:
        raise ValueError(f"unknown ingest engine {engine!r}: use one of "
                         f"{ENGINES}")


#: the tensor fields of a `CorrelationSketch`
_FIELDS = ("key_hash", "acc", "cnt", "order", "mask", "col_min", "col_max",
           "rows")

#: the fold operator of stacked sketches (the reference's name): `merge`,
#: the KMV ⊕ of §2.1, is already elementwise over leading axes
merge_cols = merge


def _sketch_batch(batch: Sequence, *, n: int, agg: Agg, chunk: int,
                  device: torch.device, engine: str,
                  order_offset: int = 0) -> CorrelationSketch:
    """One batch of sources → stacked ``[columns, n]`` sketches. Row ``i``
    of a source takes the global order ``order_offset + i``."""
    vals = [_values_2d(t) for t in batch]
    L = max(v.shape[1] for v in vals)
    if L == 0:
        raise ValueError("empty input")
    width = _key_width(batch[0])
    key_dt = np.int64 if width == 8 else np.int32
    keys = np.zeros((len(batch), L), key_dt)
    row_ok = np.zeros((len(batch), L), bool)
    src = np.concatenate([np.full(v.shape[0], i) for i, v in enumerate(vals)])
    values = np.zeros((src.shape[0], L), np.float32)
    c0 = 0
    for i, (t, v) in enumerate(zip(batch, vals)):
        m = v.shape[1]
        if m == 0:
            raise ValueError("empty input")
        keys[i, :m] = np.asarray(t.keys).view(key_dt)
        row_ok[i, :m] = True
        values[c0:c0 + v.shape[0], :m] = v
        c0 += v.shape[0]
    src_d = torch.from_numpy(src).to(device)
    keys_d = torch.from_numpy(keys).to(device)
    ok = torch.from_numpy(row_ok).to(device)
    vals_d = torch.from_numpy(values).to(device)
    if engine == "fused":
        if width == 4:
            h, fib, _ = K.hash_build(keys_d)
            kh, fib = hashing.from_pattern(h), hashing.from_pattern(fib)
        else:  # the reference has no kernel for two-block keys
            kh = hashing.murmur3_32(keys_d)
            fib = hashing.fibonacci_u32(kh)
    else:
        kh, ok = hashing.murmur3_32(keys_d)[src_d], ok[src_d]
    sk = None
    for s in range(0, L, chunk):
        e = min(s + chunk, L)
        if engine == "fused":
            order = (torch.arange(e - s, dtype=torch.float32, device=device)
                     + float(s + order_offset)).expand(len(batch), e - s)
            part = _build_cols_from_hashed(kh[:, s:e], fib[:, s:e],
                                           vals_d[:, s:e], ok[:, s:e], order,
                                           src_d, n, agg)
        else:
            part = build_sketch(kh[:, s:e], vals_d[:, s:e], n=n, agg=agg,
                                valid=ok[:, s:e],
                                order_offset=float(s + order_offset),
                                pre_hashed=True)
        sk = part if sk is None else merge(sk, part)
    return sk


def sketch_sources(sources: Sequence, *, n: int, agg: Agg = Agg.MEAN,
                   chunk: int = DEFAULT_CHUNK, device: torch.device,
                   engine: str = "fused",
                   order_offset: int = 0) -> CorrelationSketch:
    """Sketch every column of ``sources`` → stacked ``[C_total, n]``
    sketches in source order, built on ``device`` by ``engine``. Each
    source's rows take the global order ``order_offset + row``."""
    check_engine(engine)
    parts = [_sketch_batch(b, n=n, agg=agg, chunk=chunk, device=device,
                           engine=engine, order_offset=order_offset)
             for b in _batches(sources)]
    return CorrelationSketch(
        **{f: torch.cat([getattr(p, f) for p in parts]) for f in _FIELDS},
        agg=agg)


def sketch_source(t, *, n: int, agg: Agg = Agg.MEAN,
                  chunk: int = DEFAULT_CHUNK, device: torch.device,
                  engine: str = "fused",
                  order_offset: int = 0) -> CorrelationSketch:
    """Sketch one ingest source into a stacked ``[C, n]`` sketch — the
    entry point shared by `build_index` and the live index's append, so a
    table sketched at append time equals the same table sketched at build
    time."""
    return sketch_sources([t], n=n, agg=agg, chunk=chunk, device=device,
                          engine=engine, order_offset=order_offset)


def sketch_table(keys, values, *, n: int = 256, agg: Agg = Agg.MEAN,
                 chunk: int = DEFAULT_CHUNK, device: torch.device
                 ) -> CorrelationSketch:
    """Sketch every column of one table with the fused engine: ``keys
    [m]`` is its join-key column, ``values [C, m]`` (or ``[m]``) its
    numeric columns → ``[C, n]`` sketches, bit-identical per column to
    `build_sketch_streaming` on that column."""
    values = np.asarray(values, np.float32)
    return sketch_source(TableGroup(keys=np.asarray(keys),
                                    values=np.atleast_2d(values)),
                         n=n, agg=agg, chunk=chunk, device=device)


def tree_merge(parts: CorrelationSketch) -> CorrelationSketch:
    """Fold P partial sketches (leading ``[P]`` axis) in log₂(P) rounds of
    pairwise merges (the KMV merge closure). Keys, masks and counts do not
    depend on the tree's shape; a key held by several partials may sum its
    values in another order than a linear fold, so they can differ in the
    last bit. Compaction's partials are disjoint, so there it is exact.
    Pairs merge one at a time: the peak memory is that of one merge."""
    level = [parts.map(lambda x, i=i: x[i])
             for i in range(parts.key_hash.shape[0])]
    while len(level) > 1:
        nxt = [merge(level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def distributed_build_table(keys, values, mesh, *, n: int = 256,
                            agg: Agg = Agg.MEAN,
                            chunk: int = DEFAULT_CHUNK) -> CorrelationSketch:
    """Row-sharded fused build of one table over a device mesh (the
    distributed §3.4 construction, DESIGN.md §2): device ``d`` of ``mesh``
    sketches the ``d``-th row block of every column with the fused engine
    (so `hash_build` runs on each device), its rows keeping their global
    order; the ``[C, n]`` partials go to ``mesh[0]`` and `tree_merge` folds
    them there. ``keys [m]`` and ``values [C, m]`` (or ``[m]``) are numpy,
    m divisible by the shard count. Traffic between devices is D partials of ``[C, n]``, whatever
    m is."""
    mesh = tuple(torch.device(d) for d in mesh)
    ndev = len(mesh)
    keys = np.asarray(keys)
    values = np.atleast_2d(np.asarray(values, np.float32))
    m = keys.shape[0]
    if m % ndev:
        raise ValueError(f"{m} rows do not split over {ndev} shards")
    step = m // ndev
    parts = []
    for d, dev in enumerate(mesh):
        with D.on(dev):
            parts.append(sketch_source(
                TableGroup(keys=keys[d * step:(d + 1) * step],
                           values=values[:, d * step:(d + 1) * step]),
                n=n, agg=agg, chunk=chunk, device=dev,
                order_offset=d * step))
    stacked = CorrelationSketch(
        **{f: torch.stack([getattr(p, f).to(mesh[0]) for p in parts])
           for f in _FIELDS}, agg=agg)
    return tree_merge(stacked)
