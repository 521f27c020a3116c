"""Correlation Sketches (paper §3), in PyTorch.

A `CorrelationSketch` keeps the ``n`` tuples ``⟨h(k), x_k⟩`` with the
smallest Fibonacci hash, the repeated-key aggregation state and the column
statistics (count, min, max) the §4.3 Hoeffding bounds need. Sketches build
from row chunks and combine with `merge`; the KMV closure property makes
``merge(sketch(A), sketch(B)) == sketch(A ⊎ B)``, including the repeated-key
aggregation.

Every function works on the last axis and treats leading axes as a batch:
``[..., m]`` rows in, ``[..., n]`` sketches out. That batch axis is how the
index build and the query path sketch many columns in one set of device
launches. Key hashes are ``int64`` in [0, 2³²) (see `repro_torch.core.
hashing`); ties in every sort are broken stably, as the JAX reference's
``lexsort``/``top_k`` do.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import hashing

#: Sentinel key hash of padding slots (the mask is authoritative).
PAD_KEY = hashing.SENTINEL_HASH
#: Sentinel Fibonacci value of padding: +inf in the bottom-n order.
PAD_FIB = hashing.SENTINEL_HASH

_INF = float("inf")


class Agg(enum.Enum):
    """Streaming aggregation for repeated keys (paper §3.1)."""

    MEAN = "mean"
    SUM = "sum"
    COUNT = "count"
    MIN = "min"
    MAX = "max"
    FIRST = "first"
    LAST = "last"


@dataclasses.dataclass(frozen=True)
class CorrelationSketch:
    """Fixed-size mergeable correlation sketch; leading axes are a batch.

    Slots are sorted by Fibonacci hash, ascending, so the valid prefix is
    the bottom-n set.
    """

    key_hash: torch.Tensor  # int64 [..., n], h(k); PAD_KEY in padding slots
    acc: torch.Tensor       # float32 [..., n], aggregation accumulator
    cnt: torch.Tensor       # float32 [..., n], per-key multiplicity
    order: torch.Tensor     # float32 [..., n], row order for first/last
    mask: torch.Tensor      # bool [..., n], slot validity
    col_min: torch.Tensor   # float32 [...], min over the full column
    col_max: torch.Tensor   # float32 [...], max over the full column
    rows: torch.Tensor      # float32 [...], rows consumed
    agg: Agg = Agg.MEAN

    @property
    def n(self) -> int:
        """Sketch capacity: the paper's budget parameter n (§3.1)."""
        return self.key_hash.shape[-1]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "CorrelationSketch":
        """Apply ``fn`` to every tensor field (indexing, device moves)."""
        return CorrelationSketch(
            key_hash=fn(self.key_hash), acc=fn(self.acc), cnt=fn(self.cnt),
            order=fn(self.order), mask=fn(self.mask),
            col_min=fn(self.col_min), col_max=fn(self.col_max),
            rows=fn(self.rows), agg=self.agg)

    def values(self) -> torch.Tensor:
        """Finalised aggregated value x_k per slot (padding slots → 0)."""
        return finalize_values(self.acc, self.cnt, self.agg, self.mask)


def finalize_values(acc, cnt, agg: Agg, mask) -> torch.Tensor:
    """Finalise the aggregation state into x_k (§3.1): MEAN divides the
    carried (sum, count), COUNT reads the multiplicity. Padding → 0."""
    if agg == Agg.MEAN:
        v = acc / torch.clamp(cnt, min=1.0)
    elif agg == Agg.COUNT:
        v = cnt
    else:  # SUM / MIN / MAX / FIRST / LAST keep the accumulator directly
        v = acc
    return torch.where(mask, v, 0.0)


# ----------------------------------------------------------------------------
# segment combination of duplicate keys
# ----------------------------------------------------------------------------

def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(x, idx, dim=-1)


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Indices that sort the last axis by (primary, secondary), stably —
    numpy's ``lexsort((secondary, primary))``."""
    i1 = torch.sort(secondary, dim=-1, stable=True).indices
    i2 = torch.sort(_take(primary, i1), dim=-1, stable=True).indices
    return _take(i1, i2)


def _seg(x: torch.Tensor, seg: torch.Tensor, reduce: str, fill: float):
    """Segment reduction along the last axis (``seg`` ids in [0, m)).
    Min and max do not depend on the order of their operands, and neither
    does a sum of integer-valued floats below 2²⁴ (counts); a sum of values
    goes through `_seg_sum_ordered`."""
    out = torch.full_like(x, fill)
    return out.scatter_reduce_(-1, seg, x, reduce=reduce, include_self=True)


def _seg_sum_ordered(x: torch.Tensor, seg: torch.Tensor,
                     starts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Segment sums along the last axis, each segment's ``valid`` rows added
    in row order onto 0.0 — what a sequential scatter-add (the CPU's, and
    the reference's) gives, bit for bit, on every device; CUDA's
    scatter-add is atomic and adds in no fixed order. ``seg`` are
    nondecreasing segment ids in [0, m) and ``starts`` flags the first row
    of each segment. Rows outside ``valid`` hold 0.0 or lie in segments no
    caller reads; skipping them changes no sum, since a sum begun at 0.0 is
    never −0.0 and adding 0.0 to it is exact.

    Round j adds the j-th valid row of every segment that has one, so the
    work is O(rows) and the rounds are as many as the longest segment's
    valid rows."""
    m = x.shape[-1]
    pos = torch.arange(m, device=x.device)
    cv = torch.cumsum(valid.to(torch.int64), dim=-1)
    head = torch.cummax(torch.where(starts, pos, 0), dim=-1).values
    k = cv - 1 - _take(cv - valid.to(torch.int64), head)
    rows = x.numel() // max(m, 1)
    gseg = (seg + torch.arange(rows, device=x.device).reshape(
        seg.shape[:-1] + (1,)) * m).reshape(-1)
    r = torch.nonzero(valid.reshape(-1)).squeeze(-1)
    xf, kf, gseg = x.reshape(-1)[r], k.reshape(-1)[r], gseg[r]
    out = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
    kmax = int(kf.max()) if kf.numel() else -1
    if kmax == 0:  # one valid row a segment: 0.0 + x, placed once
        out[gseg] = xf + 0.0
    elif kmax > 0:
        perm = torch.sort(kf, stable=True).indices
        s = 0
        for c in torch.bincount(kf).tolist():
            p = perm[s:s + c]
            tgt = gseg[p]   # distinct: a segment has one j-th row at most
            out[tgt] = out[tgt] + xf[p]
            s += c
    return out.reshape(x.shape)


def _combine_duplicates(key_hash, acc, cnt, order, valid, agg: Agg):
    """Sort by key hash and fold duplicate keys into one slot each.

    Same-length outputs where each distinct valid key holds exactly one
    valid slot (the first row of its segment)."""
    kh = torch.where(valid, key_hash, PAD_KEY)
    # padding sorts last, also within a key segment (order = +inf)
    order = torch.where(valid, order, _INF)
    idx = _lexsort(kh, order)
    kh_s, acc_s, cnt_s = _take(kh, idx), _take(acc, idx), _take(cnt, idx)
    ord_s, val_s = _take(order, idx), _take(valid, idx)

    starts = torch.ones_like(val_s)
    starts[..., 1:] = kh_s[..., 1:] != kh_s[..., :-1]
    seg = torch.cumsum(starts.to(torch.int64), dim=-1) - 1

    if agg in (Agg.MEAN, Agg.SUM, Agg.COUNT):
        acc_c = _seg_sum_ordered(acc_s, seg, starts, val_s)
    elif agg == Agg.MIN:
        acc_c = _seg(torch.where(val_s, acc_s, _INF), seg, "amin", _INF)
    elif agg == Agg.MAX:
        acc_c = _seg(torch.where(val_s, acc_s, -_INF), seg, "amax", -_INF)
    elif agg in (Agg.FIRST, Agg.LAST):
        # keep the accumulator of the minimal (maximal) order in the segment
        if agg == Agg.FIRST:
            pick = _seg(torch.where(val_s, ord_s, _INF), seg, "amin", _INF)
        else:
            pick = _seg(torch.where(val_s, ord_s, -_INF), seg, "amax", -_INF)
        is_pick = val_s & (ord_s == _take(pick, seg))
        acc_c = _seg_sum_ordered(acc_s, seg, starts, is_pick)
    else:  # pragma: no cover
        raise ValueError(agg)

    cnt_c = _seg(torch.where(val_s, cnt_s, 0.0), seg, "sum", 0.0)
    if agg == Agg.FIRST:
        ord_c = _seg(torch.where(val_s, ord_s, _INF), seg, "amin", _INF)
    else:
        ord_c = _seg(torch.where(val_s, ord_s, -_INF), seg, "amax", -_INF)

    is_rep = starts & val_s
    return (torch.where(is_rep, kh_s, PAD_KEY),
            torch.where(is_rep, _take(acc_c, seg), 0.0),
            torch.where(is_rep, _take(cnt_c, seg), 0.0),
            torch.where(is_rep, _take(ord_c, seg), 0.0),
            is_rep)


def _bottom_n(key_hash, acc, cnt, order, valid, n: int):
    """Select the n slots with smallest Fibonacci hash; output fib-sorted.

    A stable ascending sort of the Fibonacci values is the reference's
    ``top_k`` on the flipped value ``SENTINEL_HASH − fib``: valid values are
    distinct, and ties among padding land on masked slots."""
    m = key_hash.shape[-1]
    if m < n:  # fewer rows than the sketch: pad up
        pad = lambda x, v: torch.nn.functional.pad(x, (0, n - m), value=v)
        key_hash, acc, cnt = pad(key_hash, PAD_KEY), pad(acc, 0.0), pad(cnt, 0.0)
        order, valid = pad(order, 0.0), pad(valid, False)
    fib = torch.where(valid, hashing.fibonacci_u32(key_hash), PAD_FIB)
    idx = torch.sort(fib, dim=-1, stable=True).indices[..., :n]
    sel = _take(valid, idx)
    return (torch.where(sel, _take(key_hash, idx), PAD_KEY),
            torch.where(sel, _take(acc, idx), 0.0),
            torch.where(sel, _take(cnt, idx), 0.0),
            torch.where(sel, _take(order, idx), 0.0),
            sel)


# ----------------------------------------------------------------------------
# fused multi-column combination (columns sharing a key column)
# ----------------------------------------------------------------------------

def _combine_bottom_cols(kh, fib, order, live, acc, cnt, valid, src,
                         n: int, agg: Agg):
    """Fused `_combine_duplicates` + `_bottom_n` for columns sharing key
    columns.

    ``kh``/``fib``/``order``/``live`` are ``[S, m]`` key rows; ``acc``/
    ``cnt``/``valid`` are ``[R, m]`` value columns, column r keyed by row
    ``src[r]``. Each key row is sorted once by (Fibonacci hash, row order)
    — the O(m log m) step — and its columns reuse that permutation, so
    per-column work is gathers, segment reductions and a rank gather. The
    sort is fib-ascending, so the bottom-n selection is "the first n
    segments holding a valid row of this column": a cumulative rank and a
    ``searchsorted``, not a per-column sort. Output is bit-identical to
    `_combine_duplicates` → `_bottom_n` per column (the reference's
    ``_combine_bottom_cols``)."""
    m = kh.shape[-1]
    fib = torch.where(live, fib, PAD_FIB)
    ordm = torch.where(live, order, _INF)
    sort_idx = _lexsort(fib, ordm)
    kh_s = _take(torch.where(live, kh, PAD_KEY), sort_idx)
    ord_s = _take(ordm, sort_idx)
    starts = torch.ones_like(live)
    starts[..., 1:] = kh_s[..., 1:] != kh_s[..., :-1]
    seg = torch.cumsum(starts.to(torch.int64), dim=-1) - 1
    # the key rows' permutation and segments, per column
    idx, seg, starts, kh_s, ord_s = (t[src] for t in
                                     (sort_idx, seg, starts, kh_s, ord_s))
    val_s, acc_s, cnt_s = _take(valid, idx), _take(acc, idx), _take(cnt, idx)

    if agg in (Agg.MEAN, Agg.SUM, Agg.COUNT):
        acc_g = _seg_sum_ordered(acc_s, seg, starts, val_s)
    elif agg == Agg.MIN:
        acc_g = _seg(torch.where(val_s, acc_s, _INF), seg, "amin", _INF)
    elif agg == Agg.MAX:
        acc_g = _seg(torch.where(val_s, acc_s, -_INF), seg, "amax", -_INF)
    elif agg in (Agg.FIRST, Agg.LAST):
        if agg == Agg.FIRST:
            pick = _seg(torch.where(val_s, ord_s, _INF), seg, "amin", _INF)
        else:
            pick = _seg(torch.where(val_s, ord_s, -_INF), seg, "amax", -_INF)
        is_pick = val_s & (ord_s == _take(pick, seg))
        acc_g = _seg_sum_ordered(acc_s, seg, starts, is_pick)
    else:  # pragma: no cover
        raise ValueError(agg)
    cnt_g = _seg(torch.where(val_s, cnt_s, 0.0), seg, "sum", 0.0)
    if agg == Agg.FIRST:
        ord_g = _seg(torch.where(val_s, ord_s, _INF), seg, "amin", _INF)
    else:
        ord_g = _seg(torch.where(val_s, ord_s, -_INF), seg, "amax", -_INF)
    has = _seg(val_s.to(torch.float32), seg, "sum", 0.0) > 0
    rep = starts & _take(has, seg)       # this column's representatives
    # slot j holds the j-th representative: a binary search of the
    # (monotone) cumulative count, on int64
    rank = torch.cumsum(rep.to(torch.int64), dim=-1)
    want = torch.arange(1, n + 1, device=kh.device).expand(
        rank.shape[:-1] + (n,)).contiguous()
    pos = torch.searchsorted(rank, want)
    ok = torch.arange(n, device=kh.device) < rank[..., -1:]
    posc = torch.clamp(pos, 0, m - 1)
    segp = _take(seg, posc)
    return (torch.where(ok, _take(kh_s, posc), PAD_KEY),
            torch.where(ok, _take(acc_g, segp), 0.0),
            torch.where(ok, _take(cnt_g, segp), 0.0),
            torch.where(ok, _take(ord_g, segp), 0.0),
            ok)


def _build_cols_from_hashed(kh, fib, values, row_valid, order, src,
                            n: int, agg: Agg) -> CorrelationSketch:
    """Stacked ``[R, n]`` sketches of one chunk: ``values [R, m]`` keyed by
    the ``[S, m]`` key rows ``kh`` (murmur3 hashes, int64) with Fibonacci
    values ``fib``; column r uses key row ``src[r]``. ``row_valid [S, m]``
    masks chunk padding, ``order [S, m]`` is the global row index. NaN
    values leave their column's sketch and statistics; a key on a sentinel
    leaves every column's sketch but stays in the statistics."""
    safe = hashing.sentinel_safe(kh, fib)
    live = row_valid & safe
    values = values.to(torch.float32)
    valid = row_valid[src] & torch.isfinite(values)
    slot_valid = valid & safe[src]
    if agg == Agg.COUNT:
        acc = torch.zeros_like(values)
    else:
        acc = torch.where(slot_valid, values, 0.0)
    cnt = slot_valid.to(torch.float32)
    kh_b, acc_b, cnt_b, ord_b, mask_b = _combine_bottom_cols(
        kh, fib, order, live, acc, cnt, slot_valid, src, n, agg)
    return CorrelationSketch(
        key_hash=kh_b, acc=acc_b, cnt=cnt_b, order=ord_b, mask=mask_b,
        col_min=torch.where(valid, values, _INF).amin(-1),
        col_max=torch.where(valid, values, -_INF).amax(-1),
        rows=valid.to(torch.float32).sum(-1), agg=agg)


def build_sketch_cols(keys: torch.Tensor, values: torch.Tensor, *, n: int,
                      agg: Agg = Agg.MEAN,
                      valid: Optional[torch.Tensor] = None,
                      order_offset=0.0, pre_hashed: bool = False
                      ) -> CorrelationSketch:
    """Sketch all C columns of tables at once against their key columns
    (the §3.4 build fused at table granularity).

    ``keys`` is ``[..., m]`` (`hashing.keys_tensor` patterns, or murmur3
    hashes with ``pre_hashed=True``), ``values`` is ``[..., C, m]``,
    ``valid`` (default all rows) is ``[..., m]`` and ``order_offset`` a
    scalar or ``[...]``. Each key column is hashed and sorted once for its C
    columns (`_combine_bottom_cols`). Returns ``[..., C, n]`` sketches,
    bit-identical per column to C `build_sketch` calls."""
    lead, (C, m) = values.shape[:-2], values.shape[-2:]
    dev = values.device
    S = int(np.prod(lead)) if lead else 1
    kh = (keys.to(torch.int64) & hashing.MASK32 if pre_hashed
          else hashing.murmur3_32(keys)).reshape(S, m)
    if valid is None:
        valid = torch.ones((S, m), dtype=torch.bool, device=dev)
    offset = torch.as_tensor(order_offset, dtype=torch.float32, device=dev)
    order = (torch.arange(m, dtype=torch.float32, device=dev)
             + offset.reshape(-1, 1)).expand(S, m)
    src = torch.arange(S, device=dev).repeat_interleave(C)
    sk = _build_cols_from_hashed(kh, hashing.fibonacci_u32(kh),
                                 values.reshape(S * C, m),
                                 valid.reshape(S, m), order, src, n, agg)
    return sk.map(lambda t: t.reshape(lead + (C,) + t.shape[1:]))


def empty_sketch_cols(C: int, n: int, agg: Agg = Agg.MEAN,
                      device=None) -> CorrelationSketch:
    """The identity element of `merge` (the KMV ⊕ of §2.1), stacked
    ``[C, n]``."""
    full = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=device)
    return CorrelationSketch(
        key_hash=full((C, n), PAD_KEY, torch.int64),
        acc=full((C, n), 0.0, torch.float32),
        cnt=full((C, n), 0.0, torch.float32),
        order=full((C, n), 0.0, torch.float32),
        mask=full((C, n), False, torch.bool),
        col_min=full((C,), _INF, torch.float32),
        col_max=full((C,), -_INF, torch.float32),
        rows=full((C,), 0.0, torch.float32), agg=agg)


def place_cols(sk: CorrelationSketch, capacity: int,
               offset: int = 0) -> CorrelationSketch:
    """Embed a stacked ``[C, n]`` sketch into a ``[capacity, n]`` stack at
    row ``offset``, every other slot the `merge` identity. Stacks whose
    occupied slots are disjoint merge element-wise into their union
    (sketch ⊕ identity == sketch, bit for bit): the fold of compaction."""
    C = sk.key_hash.shape[0]
    if offset < 0 or offset + C > capacity:
        raise ValueError(f"cannot place {C} columns at offset {offset} "
                         f"in capacity {capacity}")
    out = empty_sketch_cols(capacity, sk.n, sk.agg, device=sk.key_hash.device)
    for f in ("key_hash", "acc", "cnt", "order", "mask", "col_min",
              "col_max", "rows"):
        getattr(out, f)[offset:offset + C] = getattr(sk, f)
    return out


# ----------------------------------------------------------------------------
# construction
# ----------------------------------------------------------------------------

def build_sketch(keys: torch.Tensor, values: torch.Tensor, *, n: int,
                 agg: Agg = Agg.MEAN, valid: Optional[torch.Tensor] = None,
                 order_offset=0.0, pre_hashed: bool = False
                 ) -> CorrelationSketch:
    """Build sketches from chunks of ``(key, value)`` rows (paper §3.1).

    ``values`` is ``[..., m]``; ``keys`` and ``valid`` broadcast against it
    (one key column may serve several value columns). ``keys`` are key bit
    patterns (`hashing.keys_tensor`) or, with ``pre_hashed=True``, murmur3
    hashes. ``order_offset`` (scalar or ``[...]``) is the global row index
    of the chunk start, used by FIRST/LAST. NaN values are missing data:
    they leave the sketch and the column statistics.
    """
    values = values.to(torch.float32)
    shape, m, dev = values.shape, values.shape[-1], values.device
    if valid is None:
        valid = torch.ones(m, dtype=torch.bool, device=dev)
    valid = valid & torch.isfinite(values)
    kh = (keys.to(torch.int64) & hashing.MASK32 if pre_hashed
          else hashing.murmur3_32(keys)).expand(shape)
    offset = torch.as_tensor(order_offset, dtype=torch.float32, device=dev)
    order = (torch.arange(m, dtype=torch.float32, device=dev)
             + offset[..., None]).expand(shape)
    if agg == Agg.COUNT:
        acc = torch.zeros(shape, dtype=torch.float32, device=dev)
    else:
        acc = torch.where(valid, values, 0.0)
    cnt = valid.to(torch.float32)
    # a key hashing onto a sentinel may not hold a KMV slot; its row still
    # counts toward the column statistics
    slot_valid = valid & hashing.sentinel_safe(kh)
    parts = _combine_duplicates(kh, acc, cnt, order, slot_valid, agg)
    kh_b, acc_b, cnt_b, ord_b, mask_b = _bottom_n(*parts, n)
    return CorrelationSketch(
        key_hash=kh_b, acc=acc_b, cnt=cnt_b, order=ord_b, mask=mask_b,
        col_min=torch.where(valid, values, _INF).amin(-1),
        col_max=torch.where(valid, values, -_INF).amax(-1),
        rows=cnt.sum(-1), agg=agg)


def merge(a: CorrelationSketch, b: CorrelationSketch) -> CorrelationSketch:
    """Combine two partial sketches (the KMV ⊕ of §2.1 plus the
    aggregation merge), elementwise over the batch axes."""
    if a.agg != b.agg:
        raise ValueError(f"cannot merge sketches with different aggs: "
                         f"{a.agg} vs {b.agg}")
    cat = lambda x, y: torch.cat([x, y], dim=-1)
    parts = _combine_duplicates(cat(a.key_hash, b.key_hash),
                                cat(a.acc, b.acc), cat(a.cnt, b.cnt),
                                cat(a.order, b.order), cat(a.mask, b.mask),
                                a.agg)
    kh_b, acc_b, cnt_b, ord_b, mask_b = _bottom_n(*parts, a.n)
    return CorrelationSketch(
        key_hash=kh_b, acc=acc_b, cnt=cnt_b, order=ord_b, mask=mask_b,
        col_min=torch.minimum(a.col_min, b.col_min),
        col_max=torch.maximum(a.col_max, b.col_max),
        rows=a.rows + b.rows, agg=a.agg)


def build_sketch_streaming(keys: torch.Tensor, values: torch.Tensor, *,
                           n: int, agg: Agg = Agg.MEAN, chunk: int = 65536,
                           pre_hashed: bool = False) -> CorrelationSketch:
    """Out-of-core construction: one pass over row chunks, each sketched
    and merged into the running sketch."""
    m = keys.shape[-1]
    if m == 0:
        raise ValueError("empty input")
    sk = None
    for s in range(0, m, chunk):
        part = build_sketch(keys[..., s:s + chunk], values[..., s:s + chunk],
                            n=n, agg=agg, order_offset=float(s),
                            pre_hashed=pre_hashed)
        sk = part if sk is None else merge(sk, part)
    return sk


def stack_sketches(sketches) -> CorrelationSketch:
    """Stack same-(n, agg) sketches along a new leading axis."""
    agg = sketches[0].agg
    if any(s.agg != agg for s in sketches):
        raise ValueError("all sketches in a stack must share the aggregation")
    fields = ("key_hash", "acc", "cnt", "order", "mask", "col_min",
              "col_max", "rows")
    return CorrelationSketch(
        **{f: torch.stack([getattr(s, f) for s in sketches]) for f in fields},
        agg=agg)
