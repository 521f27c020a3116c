"""The sketch index: a device-resident columnar store of correlation
sketches (DESIGN.md §3). Sketches are fixed-size, so the index is dense
planes scanned brute force:

    key_hash  i32[C, n]  (the 32-bit hash's bit pattern; PAD_KEY in padding)
    values    f32[C, n]    mask  f32[C, n]
    col_min, col_max, rows  f32[C]

Beside it, two derived layouts serve stage 1 of two-stage retrieval
(DESIGN.md §5, §7): `KeyMinima` (per-column KMV count and threshold, for
the joinability estimates) and `Postings` (the inverted key index).

Over a device mesh (`repro_torch.launch.mesh`) the planes are column-
sharded (DESIGN.md §10): `place_shard` pads C to a multiple of the shard
count with fully masked columns and lays the columns out as contiguous
blocks, one per mesh device (`MeshShard`). `distributed_build` sketches a
row-sharded column on the mesh and folds the partials.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
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

    def columns(self, s: int, e: int) -> "IndexShard":
        """The columns ``[s, e)``."""
        return IndexShard(*(getattr(self, f.name)[s:e]
                            for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class MeshShard:
    """An `IndexShard` column-sharded over a mesh: ``blocks[d]`` holds the
    global columns ``[d · width, (d + 1) · width)`` on ``mesh[d]``. The
    column count is padded to a multiple of the shard count, so it depends
    only on (C, D)."""
    blocks: Tuple[IndexShard, ...]
    mesh: Tuple[torch.device, ...]

    @property
    def width(self) -> int:
        """Columns per shard."""
        return self.blocks[0].num_columns

    @property
    def num_columns(self) -> int:
        """Padded column count of the whole index."""
        return self.width * len(self.blocks)

    def offset(self, d: int) -> int:
        """Global id of shard ``d``'s first column."""
        return d * self.width

    # the whole planes on the first shard's device, as an `IndexShard`
    # reads them (a copy across shards; none on a one-shard mesh)
    key_hash = property(lambda self: self.on(self.mesh[0]).key_hash)
    values = property(lambda self: self.on(self.mesh[0]).values)
    mask = property(lambda self: self.on(self.mesh[0]).mask)
    col_min = property(lambda self: self.on(self.mesh[0]).col_min)
    col_max = property(lambda self: self.on(self.mesh[0]).col_max)
    rows = property(lambda self: self.on(self.mesh[0]).rows)

    def on(self, device) -> IndexShard:
        """The whole index on ``device``, columns in global-id order."""
        if len(self.blocks) == 1:
            return self.blocks[0].to(device)
        return IndexShard(*(torch.cat([getattr(b, f.name).to(device)
                                       for b in self.blocks])
                            for f in dataclasses.fields(IndexShard)))


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
                chunk: int = ingest.DEFAULT_CHUNK,
                pad_to: Optional[int] = None, engine: str = "fused",
                device: D.DeviceLike = None) -> SketchIndex:
    """Sketch every column of ``tables`` (`Table`s and `TableGroup`s) on
    ``device`` and stack them into an index. ``engine`` is the ingest
    engine (`ingest.ENGINES`: "fused" hashes and sorts each key column once
    for all its columns, "loop" sorts per column); the two give identical
    planes. ``pad_to`` rounds the column count up with masked padding
    columns."""
    dev = D.resolve(device)
    names: List[str] = []
    for i, t in enumerate(tables):
        names.extend(ingest.source_names(t, i))
    sk = ingest.sketch_sources(tables, n=n, agg=agg, chunk=chunk, device=dev,
                               engine=engine)
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


#: wide-table corpora read most naturally as a list of groups
build_index_groups = build_index


@dataclasses.dataclass(frozen=True)
class KeyMinima:
    """Per-candidate KMV key-minima layout (host numpy, O(C) scalars): the
    stored-minima count ``k_C`` and the threshold ``τ_C`` (the k_C-th
    smallest Fibonacci value, raw uint32). With a stage-1 hit count they
    give the `repro_torch.core.containment` estimates without reading the
    ``[C, n]`` planes again."""
    count: np.ndarray   # int32 [C]
    tau: np.ndarray     # uint32 [C]


def key_minima(shard: IndexShard) -> KeyMinima:
    """The `KeyMinima` of an index shard: one host pass over its key and
    mask planes (τ is the largest valid Fibonacci value)."""
    from repro_torch.core.containment import fib_u32_np
    kh = shard.key_hash.cpu().numpy()
    mask = shard.mask.cpu().numpy() > 0
    fib = np.where(mask, fib_u32_np(kh), 0)
    return KeyMinima(count=mask.sum(-1).astype(np.int32),
                     tau=fib.max(-1).astype(np.uint32))


@dataclasses.dataclass
class Postings:
    """Inverted key index (DESIGN.md §7): every stored ``(key hash →
    column)`` pair of the index, key-sorted into two flat device arrays

        keys  i64 [E]   32-bit hashes in [0, 2³²), ascending; PAD_KEY in
                        the [used, E) tail, which sorts last
        cols  i32 [E]   owning column id per entry; −1 in the tail

    with ``E = capacity × n``. Keys are held as ``int64`` values, not as the
    planes' ``int32`` bit patterns: signed order would put PAD (pattern −1)
    among the keys, and the window probe searches this order. An equal-key
    run lists every column holding that key (in column order).

    Mutable for the live index: `insert_cols` / `remove_cols` keep the
    layout equal to `build_postings` of the changed planes — the same keys
    and the same (key → column) multiset — under appends and tombstones.
    E never changes, so a segment's probe shapes survive its mutations."""
    keys: torch.Tensor
    cols: torch.Tensor
    used: int

    @property
    def E(self) -> int:
        return int(self.keys.shape[0])

    def max_run(self) -> int:
        """Longest equal-key run among live entries (the lower bound on the
        probe's gather window W); 1 for an empty index."""
        if self.used == 0:
            return 1
        _, runs = torch.unique_consecutive(self.keys[:self.used],
                                           return_counts=True)
        return int(runs.max())

    def _set_prefix(self, keys: torch.Tensor, cols: torch.Tensor) -> None:
        """Make ``(keys, cols)`` the live prefix and re-pad the tail."""
        used = int(keys.shape[0])
        if used > self.E:
            raise ValueError(f"postings capacity overflow: {used} entries "
                             f"for E = {self.E}")
        self.keys[:used] = keys
        self.cols[:used] = cols
        self.keys[used:max(used, self.used)] = PAD_KEY
        self.cols[used:max(used, self.used)] = -1
        self.used = used

    def remove_cols(self, cols) -> None:
        """Drop every entry of the columns ``cols`` (a tombstone: they can
        never surface as candidates)."""
        live_cols = self.cols[:self.used]
        keep = ~torch.isin(live_cols, torch.as_tensor(
            cols, dtype=torch.int32, device=live_cols.device))
        if bool(keep.all()):
            return
        self._set_prefix(self.keys[:self.used][keep], live_cols[keep])

    def remove_col(self, col: int) -> None:
        self.remove_cols([int(col)])

    def insert_cols(self, col0: int, key_hash: torch.Tensor,
                    mask: torch.Tensor) -> None:
        """Merge the valid keys of columns ``col0, col0 + 1, …`` (``[C, n]``
        int32 key patterns and masks, on any device) into the sorted
        layout, dropping stale entries of those columns first. One stable
        sort of the prefix with the new pairs: new columns append after
        every existing column of an equal-key run, as in `build_postings`
        when their ids are the highest."""
        C = key_hash.shape[0]
        self.remove_cols(range(col0, col0 + C))
        kh = hashing.from_pattern(key_hash.to(self.keys.device))
        live = (mask.to(self.keys.device) > 0) & (kh != PAD_KEY)
        new_cols = (torch.arange(C, dtype=torch.int32, device=kh.device)
                    + col0)[:, None].expand(kh.shape)[live]
        keys = torch.cat([self.keys[:self.used], kh[live]])
        cols = torch.cat([self.cols[:self.used], new_cols])
        keys, order = torch.sort(keys, stable=True)
        self._set_prefix(keys, cols[order])

    def insert_col(self, col: int, key_hash: torch.Tensor,
                   mask: torch.Tensor) -> None:
        """`insert_cols` of one column (``[n]`` planes)."""
        self.insert_cols(int(col), key_hash[None], mask[None])

    def copy(self) -> "Postings":
        return Postings(keys=self.keys.clone(), cols=self.cols.clone(),
                        used=self.used)


def build_postings(key_hash: torch.Tensor, mask: torch.Tensor,
                   capacity: Optional[int] = None) -> Postings:
    """The `Postings` of ``[C, n]`` key planes (int32 patterns) and masks,
    on their device: one stable sort of the valid keys, so equal keys keep
    column order. ``capacity`` (default C) sets E = capacity · n."""
    kh = hashing.from_pattern(key_hash)
    C, n = kh.shape
    cap = C if capacity is None else int(capacity)
    if cap < C:
        raise ValueError(f"capacity {cap} is below the {C} columns")
    live = (mask > 0) & (kh != PAD_KEY)
    cols_idx = torch.arange(C, dtype=torch.int32,
                            device=kh.device)[:, None].expand(C, n)[live]
    keys, order = torch.sort(kh[live], stable=True)
    used = int(keys.shape[0])
    out_keys = torch.full((cap * n,), PAD_KEY, dtype=torch.int64,
                          device=kh.device)
    out_cols = torch.full((cap * n,), -1, dtype=torch.int32,
                          device=kh.device)
    out_keys[:used] = keys
    out_cols[:used] = cols_idx[order]
    return Postings(keys=out_keys, cols=out_cols, used=used)


def place_shard(shard, mesh) -> MeshShard:
    """Column-pad ``shard`` to a multiple of the mesh's shard count and
    place one contiguous block on each mesh device (DESIGN.md §10). Pad
    columns are fully masked — PAD keys, mask 0, rows 0, ``col_min`` and
    ``col_max`` 0 — so they never match and are never eligible; the padded
    count depends only on C and the shard count. Shared by the static path
    (`shard_for_mesh`) and the per-segment placement of a live index. A
    `MeshShard` of as many shards as the mesh has devices is placed
    already and comes back as it is; one of another count is gathered on
    the mesh's first device and placed again."""
    mesh = tuple(torch.device(d) for d in mesh)
    ndev = len(mesh)
    if isinstance(shard, MeshShard):
        if len(shard.blocks) == ndev:
            return shard
        shard = shard.on(mesh[0])
    C = shard.num_columns
    pad = (-C) % ndev
    if pad:
        fill = lambda x, v: torch.cat([x, torch.full(
            (pad,) + x.shape[1:], v, dtype=x.dtype, device=x.device)])
        shard = IndexShard(key_hash=fill(shard.key_hash, PAD_PATTERN),
                           values=fill(shard.values, 0.0),
                           mask=fill(shard.mask, 0.0),
                           col_min=fill(shard.col_min, 0.0),
                           col_max=fill(shard.col_max, 0.0),
                           rows=fill(shard.rows, 0.0))
    w = (C + pad) // ndev
    return MeshShard(blocks=tuple(shard.columns(d * w, (d + 1) * w).to(dev)
                                  for d, dev in enumerate(mesh)),
                     mesh=mesh)


def shard_for_mesh(index: SketchIndex, mesh) -> MeshShard:
    """The index's planes column-sharded over ``mesh`` (`place_shard`)."""
    return place_shard(index.shard, mesh)


def distributed_build(keys, values, mesh, *, n: int = 256,
                      agg: Agg = Agg.MEAN) -> CorrelationSketch:
    """One sketch of a row-sharded column: device ``d`` of ``mesh`` sketches
    the ``d``-th row block (its rows keep their global order), the partial
    sketches go to ``mesh[0]`` and fold there one by one. Exact by the KMV
    merge closure. ``keys [m]`` (uint32 numpy or int32-pattern tensor) and
    ``values [m]``, m divisible by the shard count."""
    from repro_torch.core.sketch import build_sketch, merge
    mesh = tuple(torch.device(d) for d in mesh)
    ndev = len(mesh)
    if isinstance(keys, np.ndarray):
        keys = hashing.keys_tensor(keys)
    values = torch.as_tensor(values, dtype=torch.float32)
    m = keys.shape[0]
    if m % len(mesh):
        raise ValueError(f"{m} rows do not split over {len(mesh)} shards")
    step = m // len(mesh)
    parts = []
    for d, dev in enumerate(mesh):
        with D.on(dev):
            parts.append(build_sketch(keys[d * step:(d + 1) * step].to(dev),
                                      values[d * step:(d + 1) * step].to(dev),
                                      n=n, agg=agg,
                                      order_offset=float(d * step)))
    out = parts[0]
    for p in parts[1:]:
        out = merge(out, p.map(lambda t: t.to(mesh[0])))
    return out
