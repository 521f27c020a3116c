"""Carry state from the JAX engine into the port.

The state of this system is its index (its planes, and the inverted
postings beside them; for a live index, its segments' mergeable state) and,
for a query, its sketches — not weights. These take the reference's arrays
as numpy — any object with the named attributes, such as
``repro.engine.index.IndexShard``, a ``repro.core.sketch.
CorrelationSketch`` or a ``repro.engine.lifecycle.LiveIndex`` — so both
engines can serve the same index. The LM substrate's state is its
weights, `lm_params_from_reference`, and in training its optimizer state
too, `train_state_from_reference`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core.sketch import Agg, CorrelationSketch
from repro_torch.engine.index import IndexShard, Postings, SketchIndex
from repro_torch.engine.lifecycle import LiveIndex, Segment
from repro_torch.train import optimizer as OPT
from repro_torch.train.train_step import TrainState


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


def live_index_from_reference(live, device: D.DeviceLike = None
                              ) -> LiveIndex:
    """The port's `LiveIndex` for a reference live index: its segments'
    mergeable state (``kh`` u32, ``acc``, ``cnt``, ``order``, ``mask``,
    ``cmin``, ``cmax``, ``rows``, ``live``), names, owning tables, seal
    flags and versions, and the index's counters (next segment id, source
    count, version). Ingest and compaction of the result run on
    ``device``."""
    idx = LiveIndex(n=live.n, agg=Agg(live.agg.value), chunk=live.chunk,
                    delta_cap=live.delta_cap, engine=live.engine,
                    device=device)
    with live._lock:
        idx._next_sid = int(live._next_sid)
        idx._n_sources = int(live._n_sources)
        idx.version = int(live.version)
        idx._set_segments([Segment(
            sid=int(seg.sid), n=int(seg.n), agg=idx.agg,
            capacity=int(seg.capacity),
            kh=np.array(seg.kh, np.uint32),
            acc=np.array(seg.acc, np.float32),
            cnt=np.array(seg.cnt, np.float32),
            order=np.array(seg.order, np.float32),
            mask=np.array(seg.mask, bool),
            cmin=np.array(seg.cmin, np.float32),
            cmax=np.array(seg.cmax, np.float32),
            rows=np.array(seg.rows, np.float32),
            names=list(seg.names), tables=list(seg.tables),
            live=np.array(seg.live, bool), used=int(seg.used),
            sealed=bool(seg.sealed), version=int(seg.version),
            device=idx.device) for seg in live._segs])
    return idx


def lm_params_from_reference(tree, device: D.DeviceLike = None) -> dict:
    """The port's LM parameters for a reference parameter pytree (nested
    dicts of arrays, such as ``repro.models.params.init_params`` returns,
    as numpy or anything ``np.asarray`` takes): the same keys, each tensor
    a bit-for-bit copy in its own dtype."""
    dev = D.resolve(device)
    return {k: (lm_params_from_reference(v, dev) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)).to(dev))
            for k, v in tree.items()}


def train_state_from_reference(state, device: D.DeviceLike = None) -> TrainState:
    """The port's `TrainState` for a reference ``TrainState`` (``params``,
    ``opt.mu``, ``opt.nu``, ``opt.step``, ``step``; arrays as numpy or
    anything ``np.asarray`` takes): every tensor a bit-for-bit copy, the
    step counts host integers."""
    dev = D.resolve(device)
    return TrainState(
        params=lm_params_from_reference(state.params, dev),
        opt=OPT.AdamWState(mu=lm_params_from_reference(state.opt.mu, dev),
                           nu=lm_params_from_reference(state.opt.nu, dev),
                           step=int(np.asarray(state.opt.step))),
        step=int(np.asarray(state.step)))
