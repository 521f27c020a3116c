"""The live index: streaming appends, tombstone deletes, compaction and
snapshots over the sketch index — a data lake's corpus grows and its
tables are replaced while queries keep coming.

A miniature LSM tree over column sketches:

* **delta segments** — `LiveIndex.append` sketches tables with the ingest
  engine (`engine.ingest.sketch_sources`, the path of `build_index`) on the
  index's device and writes the ``[C, n]`` stacks into the active
  fixed-capacity `Segment`, sealing it and opening a new one as it fills.
  Appends never touch sealed segments.
* **tombstones** — `delete` resets a table's slots to the merge identity
  (mask cleared, keys PAD). A tombstoned column joins nothing, so it is
  never eligible and never ranks; the postings drop it at once.
* **compaction** — `compact` places every segment's live columns at their
  global offsets in a ladder-capacity stack (`core.sketch.place_cols`,
  empty slots are merge identities) and folds the stacks with
  `engine.ingest.tree_merge` on the device. ``sketch ⊕ identity == sketch``
  bit for bit, so appends followed by a compaction equal a one-shot
  `build_index` over the surviving tables.
* **capacity ladder** — capacities come from ``delta_cap · 2^i``
  (`ladder_rung`), so the serving layer sees few segment shapes.
* **snapshots** — `save` / `LiveIndex.load` persist the full mergeable
  state as npz + a json manifest, in the JAX package's format (the same
  file names, array keys and ``format=1``): a snapshot saved by either
  package loads in the other.

Segments keep their state in host numpy arrays (key hashes as ``uint32``,
as in the reference); each keeps its inverted `Postings` on the index's
device once built, maintained through writes and tombstones. The read side
is `engine.serve.Server`, which serves a `LiveIndex` segment by segment
and places each segment over its device mesh when `refresh` publishes it
(`engine.index.place_shard`, DESIGN.md §10): the live index itself holds
no sharding. `LiveQueryServer` is the reference's deprecated alias of it.
During the delta phase the s4 CI normalisation spans one segment's
candidate list, so s4 results equal a static server's only after
`compact` leaves one segment; s1 and s2 are exact throughout.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core.sketch import (PAD_KEY, Agg, CorrelationSketch,
                                     finalize_values, place_cols,
                                     stack_sketches)
from repro_torch.engine import ingest
from repro_torch.engine import serve as SV
from repro_torch.engine.index import IndexShard, Postings, build_postings

#: snapshot file names (under the directory passed to save/load)
MANIFEST_FILE = "manifest.json"
ARRAYS_FILE = "segments.npz"
#: per-segment persisted arrays, in manifest order
_SEG_FIELDS = ("kh", "acc", "cnt", "order", "mask", "cmin", "cmax", "rows",
               "live")


@dataclasses.dataclass
class Segment:
    """One fixed-capacity stack of column sketches, held on the host.

    It keeps the full mergeable state (acc/cnt/order, not finalised
    values) so compaction can fold it exactly; `to_index_shard` gives the
    serving view. Slots in ``[used, capacity)`` hold the merge identity and
    tombstoned slots are reset to it; ``live[slot]`` is the authoritative
    flag. ``device`` is where its postings live."""
    sid: int
    n: int
    agg: Agg
    capacity: int
    kh: np.ndarray       # u32  [cap, n]
    acc: np.ndarray      # f32  [cap, n]
    cnt: np.ndarray      # f32  [cap, n]
    order: np.ndarray    # f32  [cap, n]
    mask: np.ndarray     # bool [cap, n]
    cmin: np.ndarray     # f32  [cap]
    cmax: np.ndarray     # f32  [cap]
    rows: np.ndarray     # f32  [cap]
    names: List[str]     # per used slot
    tables: List[str]    # per used slot: owning table id
    live: np.ndarray     # bool [cap]; False for unused and tombstoned slots
    used: int = 0
    sealed: bool = False
    version: int = 0     # bumped on every mutation; serving keys off it
    device: torch.device = torch.device("cpu")
    #: inverted postings, built on first use and then maintained by
    #: write/tombstone; never persisted (a rebuild equals them)
    _postings: Optional[Postings] = None

    @classmethod
    def empty(cls, sid: int, capacity: int, n: int, agg: Agg,
              device=torch.device("cpu")) -> "Segment":
        """A fresh segment, every slot the merge identity."""
        return cls(
            sid=sid, n=n, agg=agg, capacity=capacity,
            kh=np.full((capacity, n), PAD_KEY, np.uint32),
            acc=np.zeros((capacity, n), np.float32),
            cnt=np.zeros((capacity, n), np.float32),
            order=np.zeros((capacity, n), np.float32),
            mask=np.zeros((capacity, n), bool),
            cmin=np.full((capacity,), np.inf, np.float32),
            cmax=np.full((capacity,), -np.inf, np.float32),
            rows=np.zeros((capacity,), np.float32),
            names=[], tables=[], live=np.zeros((capacity,), bool),
            device=torch.device(device))

    @property
    def free(self) -> int:
        """Unwritten slots left before this segment seals."""
        return self.capacity - self.used

    def live_count(self) -> int:
        """Slots that are written and not tombstoned."""
        return int(self.live.sum())

    def write(self, sk: CorrelationSketch, names: Sequence[str],
              table_id: str) -> None:
        """Copy ``len(names)`` columns of a stacked sketch (any device) into
        the next free slots."""
        C = len(names)
        if C > self.free or sk.key_hash.shape[0] != C:
            raise ValueError(f"cannot write {sk.key_hash.shape[0]} columns "
                             f"as {C} names into {self.free} free slots")
        sl = slice(self.used, self.used + C)
        host = lambda t: t.detach().cpu().numpy()
        self.kh[sl] = host(sk.key_hash).astype(np.uint32)
        self.acc[sl] = host(sk.acc)
        self.cnt[sl] = host(sk.cnt)
        self.order[sl] = host(sk.order)
        self.mask[sl] = host(sk.mask)
        self.cmin[sl] = host(sk.col_min)
        self.cmax[sl] = host(sk.col_max)
        self.rows[sl] = host(sk.rows)
        self.live[sl] = True
        self.names.extend(names)
        self.tables.extend([table_id] * C)
        if self._postings is not None:
            self._postings.insert_cols(
                sl.start, torch.from_numpy(self.kh[sl].view(np.int32)),
                torch.from_numpy(self.mask[sl]))
        self.used += C
        if self.used == self.capacity:
            self.sealed = True
        self.version += 1

    def host_snapshot(self) -> "Segment":
        """A consistent copy of the mutable state, taken under the index
        lock so a reader can finalise and place it after the lock is
        released."""
        return dataclasses.replace(
            self, kh=self.kh.copy(), acc=self.acc.copy(),
            cnt=self.cnt.copy(), order=self.order.copy(),
            mask=self.mask.copy(), cmin=self.cmin.copy(),
            cmax=self.cmax.copy(), rows=self.rows.copy(),
            names=list(self.names), tables=list(self.tables),
            live=self.live.copy(),
            _postings=(self._postings.copy()
                       if self._postings is not None else None))

    def tombstone(self, slots) -> None:
        """Reset slot(s) to the merge identity: never eligible at scoring
        time, gone from the postings, skipped by compaction."""
        slots = np.atleast_1d(np.asarray(slots, np.int64))
        self.live[slots] = False
        self.kh[slots] = PAD_KEY
        self.acc[slots] = 0.0
        self.cnt[slots] = 0.0
        self.order[slots] = 0.0
        self.mask[slots] = False
        self.cmin[slots] = np.inf
        self.cmax[slots] = -np.inf
        self.rows[slots] = 0.0
        if self._postings is not None:
            self._postings.remove_cols(slots.tolist())
        self.version += 1

    def postings(self) -> Postings:
        """This segment's inverted postings on its device, built on first
        use from the current slots and maintained by `write`/`tombstone`
        from then on. E = capacity · n for the segment's lifetime."""
        if self._postings is None:
            self._postings = build_postings(
                torch.from_numpy(self.kh.view(np.int32)).to(self.device),
                torch.from_numpy(self.mask).to(self.device),
                capacity=self.capacity)
        return self._postings

    def as_sketch(self, slots: Optional[np.ndarray] = None,
                  device=None) -> CorrelationSketch:
        """Stacked sketch of (a subset of) this segment's slots on
        ``device`` (default the segment's)."""
        dev = self.device if device is None else device
        take = (lambda a: a) if slots is None else (lambda a: a[slots])
        t = lambda a: torch.from_numpy(np.ascontiguousarray(take(a))).to(dev)
        return CorrelationSketch(
            key_hash=t(self.kh).to(torch.int64), acc=t(self.acc),
            cnt=t(self.cnt), order=t(self.order), mask=t(self.mask),
            col_min=t(self.cmin), col_max=t(self.cmax), rows=t(self.rows),
            agg=self.agg)

    def to_index_shard(self) -> IndexShard:
        """Serving view (CPU tensors) in the static index's conventions:
        dead and unused slots look like `build_index` padding (zero
        statistics, PAD keys, empty mask), live slots carry finalised
        values."""
        values = finalize_values(torch.from_numpy(self.acc),
                                 torch.from_numpy(self.cnt), self.agg,
                                 torch.from_numpy(self.mask)).numpy()
        dead = ~self.live
        kh = self.kh.copy()
        kh[dead] = PAD_KEY
        f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return IndexShard(
            key_hash=torch.from_numpy(kh.view(np.int32)),
            values=f32(np.where(dead[:, None], 0.0, values)),
            mask=f32(np.where(dead[:, None], 0.0, self.mask)),
            col_min=f32(np.where(dead, 0.0, self.cmin)),
            col_max=f32(np.where(dead, 0.0, self.cmax)),
            rows=f32(np.where(dead, 0.0, self.rows)))


def ladder_rung(c: int, base: int) -> int:
    """Smallest capacity on the ladder ``base · 2^i`` holding c columns."""
    cap = int(base)
    while cap < c:
        cap *= 2
    return cap


class LiveIndex:
    """A mutable sketch index: append / delete / compact / save / load.
    Exactness rests on the KMV merge closure (§2.1).

    Ingest and compaction run on ``device`` (the CUDA card unless the
    caller names another; raises without a card). Mutations hold an
    internal lock and bump ``version``, so a server can snapshot a
    consistent segment list at any time and pick up mutations on its next
    `refresh`."""

    def __init__(self, *, n: int = 256, agg: Agg = Agg.MEAN,
                 chunk: int = ingest.DEFAULT_CHUNK, delta_cap: int = 64,
                 engine: str = "fused", device: D.DeviceLike = None):
        if delta_cap <= 0:
            raise ValueError(f"delta_cap must be positive, got {delta_cap}")
        ingest.check_engine(engine)
        self.device = D.resolve(device)
        self.n = int(n)
        self.agg = agg
        self.chunk = int(chunk)
        self.delta_cap = int(delta_cap)
        self.engine = engine
        self._segs: List[Segment] = []
        #: the live slots of each table id, so an upsert or a delete finds
        #: a table's columns without scanning every slot of the index
        self._owners: Dict[str, List[Tuple[Segment, int]]] = {}
        self._next_sid = 0
        #: lifetime count of appended sources: unnamed tables take their
        #: global source position as `build_index` does, so ids never
        #: collide across append calls
        self._n_sources = 0
        self._lock = threading.RLock()
        self.version = 0

    # -- introspection -------------------------------------------------------
    def segments(self) -> List[Segment]:
        """Ordered snapshot of the segment list."""
        with self._lock:
            return list(self._segs)

    def names(self) -> List[str]:
        """Column names by global id: the segments' used slots in order,
        tombstoned ones included, so ids stay dense per snapshot."""
        with self._lock:
            return [nm for seg in self._segs for nm in seg.names[:seg.used]]

    def live_columns(self) -> int:
        """Live (written, not tombstoned) columns across segments."""
        with self._lock:
            return sum(seg.live_count() for seg in self._segs)

    def stats(self) -> dict:
        """Segment, occupancy and version counters."""
        with self._lock:
            return dict(
                segments=len(self._segs),
                sealed=sum(1 for s in self._segs if s.sealed),
                capacity=sum(s.capacity for s in self._segs),
                used=sum(s.used for s in self._segs),
                live=sum(s.live_count() for s in self._segs),
                dead=sum(s.used - s.live_count() for s in self._segs),
                version=self.version)

    # -- mutation ------------------------------------------------------------
    def _set_segments(self, segs: Sequence[Segment]) -> None:
        """Make ``segs`` the segment list and rebuild the table → slots
        map from their live slots."""
        self._segs = list(segs)
        self._owners = {}
        for seg in self._segs:
            for slot in np.nonzero(seg.live[:seg.used])[0]:
                self._owners.setdefault(seg.tables[slot], []).append(
                    (seg, int(slot)))

    def _active(self) -> Segment:
        if not self._segs or self._segs[-1].sealed:
            self._segs.append(Segment.empty(self._next_sid, self.delta_cap,
                                            self.n, self.agg, self.device))
            self._next_sid += 1
        return self._segs[-1]

    def append(self, tables: Sequence) -> List[str]:
        """Sketch and add tables (visible to a server's next `refresh`).
        A named table whose id is already live is upserted: its old columns
        are tombstoned first. All tables are sketched in the batched build
        of `build_index`. Returns the column names added."""
        tables = list(tables)
        if not tables:
            return []
        with self._lock:
            first = self._n_sources
            self._n_sources += len(tables)
        names = [ingest.source_names(t, first + i)
                 for i, t in enumerate(tables)]
        sk = ingest.sketch_sources(tables, n=self.n, agg=self.agg,
                                   chunk=self.chunk, device=self.device,
                                   engine=self.engine)
        sk = sk.map(lambda a: a.cpu())
        added: List[str] = []
        c0 = 0
        with self._lock:
            for t, nm in zip(tables, names):
                table_id = t.name or nm[0]
                if t.name:
                    self._tombstone_table(table_id)
                # columns may span a seal boundary: write capacity-sized
                # slices, rolling to a fresh delta segment as each fills
                row = 0
                while row < len(nm):
                    seg = self._active()
                    take = min(seg.free, len(nm) - row)
                    s, slot = c0 + row, seg.used
                    seg.write(sk.map(lambda a: a[s:s + take]),
                              nm[row:row + take], table_id)
                    self._owners.setdefault(table_id, []).extend(
                        (seg, j) for j in range(slot, slot + take))
                    row += take
                c0 += len(nm)
                added.extend(nm)
                self.version += 1
        return added

    def _tombstone_table(self, table_id: str) -> int:
        owned = self._owners.pop(table_id, [])
        by_seg: Dict[int, Tuple[Segment, List[int]]] = {}
        for seg, slot in owned:
            by_seg.setdefault(id(seg), (seg, []))[1].append(slot)
        for seg, slots in by_seg.values():
            seg.tombstone(slots)
        return len(owned)

    def delete(self, table_id: str) -> int:
        """Tombstone every live column of ``table_id``: out of scoring at a
        server's next refresh, reclaimed by `compact`. Returns the number
        of columns tombstoned."""
        with self._lock:
            count = self._tombstone_table(table_id)
            if count:
                self.version += 1
        return count

    # -- compaction ----------------------------------------------------------
    def compact(self) -> Segment:
        """Fold all segments into one sealed base segment with
        `ingest.tree_merge` over offset-placed, ladder-capacity stacks on
        the device; dead slots are reclaimed. The lock is held end to end,
        so no mutation slips between the snapshot and the swap; readers
        keep serving the old segments until their next refresh."""
        with self._lock:
            placements: List[Tuple[Segment, np.ndarray]] = []
            total = 0
            for seg in self._segs:
                slots = np.nonzero(seg.live)[0]
                if slots.size:
                    placements.append((seg, slots))
                    total += int(slots.size)
            cap = ladder_rung(total, self.delta_cap)
            base = Segment.empty(self._next_sid, cap, self.n, self.agg,
                                 self.device)
            self._next_sid += 1
            if placements:
                staged, offset = [], 0
                for seg, slots in placements:
                    staged.append(place_cols(seg.as_sketch(slots), cap,
                                             offset))
                    offset += int(slots.size)
                merged = ingest.tree_merge(stack_sketches(staged))
                del staged
                base.write(merged.map(lambda a: a[:total]),
                           [seg.names[s] for seg, slots in placements
                            for s in slots], table_id="")
                base.tables = [seg.tables[s] for seg, slots in placements
                               for s in slots]
            base.sealed = True
            self._set_segments([base])
            self.version += 1
        return base

    # -- snapshots -----------------------------------------------------------
    def save(self, path: str) -> None:
        """Persist the full mergeable state to ``path/`` (npz + manifest),
        in the JAX package's snapshot format. Arrays round-trip bit for
        bit."""
        with self._lock:
            segs = list(self._segs)
            manifest = dict(
                format=1, n=self.n, agg=self.agg.value, chunk=self.chunk,
                delta_cap=self.delta_cap, engine=self.engine,
                next_sid=self._next_sid, n_sources=self._n_sources,
                version=self.version,
                segments=[dict(sid=s.sid, capacity=s.capacity, used=s.used,
                               sealed=s.sealed, names=list(s.names),
                               tables=list(s.tables)) for s in segs])
            # copies: the writes below run outside the lock
            arrays = {f"s{s.sid}_{f}": getattr(s, f).copy()
                      for s in segs for f in _SEG_FIELDS}
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, ARRAYS_FILE), **arrays)
        with open(os.path.join(path, MANIFEST_FILE), "w") as f:
            json.dump(manifest, f, indent=1)

    @classmethod
    def load(cls, path: str, device: D.DeviceLike = None) -> "LiveIndex":
        """Rehydrate a `save` snapshot (of either package) onto ``device``:
        the same mergeable state, so serving and later compactions behave
        as if it had never been persisted."""
        device = D.resolve(device)
        with open(os.path.join(path, MANIFEST_FILE)) as f:
            manifest = json.load(f)
        if manifest.get("format") != 1:
            raise ValueError(f"unknown snapshot format "
                             f"{manifest.get('format')!r}")
        idx = cls(n=manifest["n"], agg=Agg(manifest["agg"]),
                  chunk=manifest["chunk"], delta_cap=manifest["delta_cap"],
                  engine=manifest["engine"], device=device)
        idx._next_sid = manifest["next_sid"]
        idx._n_sources = manifest["n_sources"]
        idx.version = manifest["version"]
        with np.load(os.path.join(path, ARRAYS_FILE)) as data:
            idx._set_segments([Segment(
                sid=m["sid"], n=idx.n, agg=idx.agg, capacity=m["capacity"],
                names=list(m["names"]), tables=list(m["tables"]),
                used=m["used"], sealed=m["sealed"], device=idx.device,
                **{f: data[f"s{m['sid']}_{f}"] for f in _SEG_FIELDS})
                for m in manifest["segments"]])
        return idx


# ----------------------------------------------------------------------------
# deprecated alias: the reference's segment-aware server
# ----------------------------------------------------------------------------

class LiveQueryServer(SV.Server):
    """Deprecated alias of `repro_torch.engine.serve.Server` over a
    `LiveIndex` under a legacy `repro_torch.engine.query.QueryConfig`,
    with the reference's constructor (``mesh`` first), the positional
    ``refresh`` of `query_batch`, the `live` property, and a `warmup` of
    only the configured ``qcfg.prune``. The reference's ``cache=`` is not
    taken: passing it raises TypeError."""

    def __init__(self, mesh, live: LiveIndex, qcfg,
                 buckets: Sequence[int] = (1, 8, 32), *,
                 batch_rows: Optional[int] = None,
                 device: D.DeviceLike = None):
        warnings.warn(
            "repro_torch.engine.lifecycle.LiveQueryServer is deprecated; use "
            "repro_torch.engine.serve.Server (one facade for static and live "
            "indexes, per-request semantics)",
            DeprecationWarning, stacklevel=2)
        super().__init__(live, qcfg, buckets=buckets, mesh=mesh,
                         device=device, batch_rows=batch_rows)
        self.qcfg = qcfg

    @property
    def live(self) -> LiveIndex:
        return self._live

    def query_batch(self, sketches: CorrelationSketch, refresh: bool = True,
                    *, request=None):
        # the reference's signature: ``refresh`` positional
        return super().query_batch(sketches, request=request,
                                   refresh=refresh)

    def warmup(self, include_ladder: bool = True,
               modes: Optional[Sequence[str]] = None) -> None:
        """Warm ``modes`` (default: only the config's prune mode)."""
        super().warmup(modes=modes if modes is not None
                       else (self.request.prune,),
                       include_ladder=include_ladder)
