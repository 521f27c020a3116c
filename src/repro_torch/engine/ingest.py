"""Index ingest: sketch the columns of many ingest sources in batched
device launches (the §3.4 streaming build).

A source is a `Table` (one column) or a `TableGroup` (C columns sharing one
join-key column). Consecutive sources are packed into one ``[columns, rows]``
batch, each padded to the batch's longest row count with invalid rows, and
sketched by one batched `build_sketch` per row chunk, folded with `merge`.
Each column's sketch equals what `build_sketch_streaming` gives for it alone:
padding rows are invalid, and chunks see the same global row order.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.sketch import (Agg, CorrelationSketch, build_sketch,
                                     merge)
from repro_torch.data.pipeline import TableGroup

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


def _sketch_batch(batch: Sequence, *, n: int, agg: Agg, chunk: int,
                  device: torch.device) -> CorrelationSketch:
    """One batch of sources → stacked ``[columns, n]`` sketches."""
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
    kh = hashing.murmur3_32(torch.from_numpy(keys).to(device))[src_d]
    ok = torch.from_numpy(row_ok).to(device)[src_d]
    vals_d = torch.from_numpy(values).to(device)
    sk = None
    for s in range(0, L, chunk):
        e = min(s + chunk, L)
        part = build_sketch(kh[:, s:e], vals_d[:, s:e], n=n, agg=agg,
                            valid=ok[:, s:e], order_offset=float(s),
                            pre_hashed=True)
        sk = part if sk is None else merge(sk, part)
    return sk


def sketch_sources(sources: Sequence, *, n: int, agg: Agg = Agg.MEAN,
                   chunk: int = 65536, device: torch.device
                   ) -> CorrelationSketch:
    """Sketch every column of ``sources`` → stacked ``[C_total, n]``
    sketches in source order, built on ``device``."""
    parts = [_sketch_batch(b, n=n, agg=agg, chunk=chunk, device=device)
             for b in _batches(sources)]
    fields = ("key_hash", "acc", "cnt", "order", "mask", "col_min",
              "col_max", "rows")
    return CorrelationSketch(
        **{f: torch.cat([getattr(p, f) for p in parts]) for f in fields},
        agg=agg)
