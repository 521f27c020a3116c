"""The sketch index: a device-resident columnar store of correlation
sketches (DESIGN.md §3). Sketches are fixed-size, so the index is dense
planes scanned brute force:

    key_hash  i32[C, n]  (the 32-bit hash's bit pattern; PAD_KEY in padding)
    values    f32[C, n]    mask  f32[C, n]
    col_min, col_max, rows  f32[C]
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch import device as D
from repro_torch.core import hashing
from repro_torch.core.sketch import PAD_KEY, Agg, CorrelationSketch
from repro_torch.engine import ingest

#: PAD_KEY as the int32 bit pattern the planes hold
PAD_PATTERN = PAD_KEY - 2**32


@dataclasses.dataclass(frozen=True)
class IndexShard:
    """Stacked sketches of one device (leading axis = columns)."""

    key_hash: torch.Tensor   # i32 [C, n]
    values: torch.Tensor     # f32 [C, n]
    mask: torch.Tensor       # f32 [C, n]
    col_min: torch.Tensor    # f32 [C]
    col_max: torch.Tensor    # f32 [C]
    rows: torch.Tensor       # f32 [C]

    @property
    def num_columns(self) -> int:
        return self.key_hash.shape[0]

    def to(self, device) -> "IndexShard":
        return IndexShard(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


@dataclasses.dataclass
class SketchIndex:
    """Device planes + column catalog (``names`` excludes pad_to padding)."""
    shard: IndexShard
    names: List[str]
    n: int

    @property
    def num_columns(self) -> int:
        return len(self.names)


def query_arrays(sk: CorrelationSketch):
    """Flatten query sketches into the (kh, val, mask, cmin, cmax) tuple the
    scan takes: key planes as int32 bit patterns, masks as float32."""
    return (hashing.to_pattern(sk.key_hash), sk.values(),
            sk.mask.to(torch.float32), sk.col_min, sk.col_max)


def build_index(tables: Sequence, *, n: int = 256, agg: Agg = Agg.MEAN,
                chunk: int = 65536, pad_to: Optional[int] = None,
                device: D.DeviceLike = None) -> SketchIndex:
    """Sketch every column of ``tables`` (`Table`s and `TableGroup`s) on
    ``device`` and stack them into an index. ``pad_to`` rounds the column
    count up with masked padding columns."""
    dev = D.resolve(device)
    names: List[str] = []
    for i, t in enumerate(tables):
        names.extend(ingest.source_names(t, i))
    sk = ingest.sketch_sources(tables, n=n, agg=agg, chunk=chunk, device=dev)
    C = len(names)
    pad = (pad_to - C) if pad_to and pad_to > C else 0

    def fill(x, value):
        if not pad:
            return x
        return torch.cat([x, torch.full((pad,) + x.shape[1:], value,
                                        dtype=x.dtype, device=dev)])

    shard = IndexShard(key_hash=fill(hashing.to_pattern(sk.key_hash),
                                     PAD_PATTERN),
                       values=fill(sk.values(), 0.0),
                       mask=fill(sk.mask.to(torch.float32), 0.0),
                       col_min=fill(sk.col_min, 0.0),
                       col_max=fill(sk.col_max, 0.0),
                       rows=fill(sk.rows, 0.0))
    return SketchIndex(shard=shard, names=names, n=n)
