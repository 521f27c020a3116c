"""Carry state from the JAX engine into the port.

The state of this system is its index (its planes, and the inverted
postings beside them) and, for a query, its sketches — not weights. These take the reference's arrays as numpy — any object with
the named attributes, such as ``repro.engine.index.IndexShard`` or a
``repro.core.sketch.CorrelationSketch`` — so both engines can serve the
same index.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core.sketch import Agg, CorrelationSketch
from repro_torch.engine.index import IndexShard, Postings, SketchIndex


def _f32(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(dev)


def _u32_as_int64(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64)).to(dev)


def index_from_reference(shard, names: Sequence[str], n: int,
                         device: D.DeviceLike = None) -> SketchIndex:
    """The port's `SketchIndex` for reference index planes: ``shard`` has
    ``key_hash`` (u32 [C, n]), ``values``, ``mask``, ``col_min``,
    ``col_max`` and ``rows``."""
    dev = D.resolve(device)
    kh = np.asarray(shard.key_hash, np.uint32).view(np.int32)
    return SketchIndex(
        shard=IndexShard(key_hash=torch.from_numpy(kh.copy()).to(dev),
                         values=_f32(shard.values, dev),
                         mask=_f32(shard.mask, dev),
                         col_min=_f32(shard.col_min, dev),
                         col_max=_f32(shard.col_max, dev),
                         rows=_f32(shard.rows, dev)),
        names=list(names), n=int(n))


def postings_from_reference(keys, cols, used: int,
                            device: D.DeviceLike = None) -> Postings:
    """The port's `Postings` for a reference layout: ``keys`` u32 [E]
    (ascending, PAD_KEY tail), ``cols`` i32 [E] and the live prefix
    ``used`` — such as ``repro.engine.index.Postings``'s fields."""
    dev = D.resolve(device)
    return Postings(keys=_u32_as_int64(keys, dev),
                    cols=torch.from_numpy(np.array(cols, np.int32)).to(dev),
                    used=int(used))


def sketches_from_reference(sk, device: D.DeviceLike = None
                            ) -> CorrelationSketch:
    """The port's `CorrelationSketch` for a (batch of) reference sketches:
    ``sk`` has ``key_hash`` (u32), ``acc``, ``cnt``, ``order``, ``mask``,
    ``col_min``, ``col_max``, ``rows`` and ``agg`` (an enum whose
    ``value`` names the aggregation)."""
    dev = D.resolve(device)
    return CorrelationSketch(
        key_hash=_u32_as_int64(sk.key_hash, dev),
        acc=_f32(sk.acc, dev), cnt=_f32(sk.cnt, dev),
        order=_f32(sk.order, dev),
        mask=torch.from_numpy(np.array(sk.mask, bool)).to(dev),
        col_min=_f32(sk.col_min, dev), col_max=_f32(sk.col_max, dev),
        rows=_f32(sk.rows, dev), agg=Agg(sk.agg.value))
