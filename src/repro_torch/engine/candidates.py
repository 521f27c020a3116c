"""Stage-1 candidate sources (DESIGN.md §7).

Stage 1 of two-stage retrieval answers, per query: which columns share keys
with it, and how many — the exact sketch-intersection sizes that drive
``prune="safe"`` eligibility, ``topm`` selection, `Server.stage1_hits` and
`Server.search_joinable`. Two sources give the same exact counts:

  * `ScanSource` — the containment kernel over every resident column
    (`plans.probe`, one launch per shard of a mesh), O(C) per query;
  * `InvertedSource` — the inverted key index (`engine.index.Postings`):
    one ``searchsorted`` per query key, a W-wide window gather and the
    postings-merge kernel, O(n·(W + log E)) per query whatever C is.

Each (key, column) pair is stored once and query keys are distinct within
a sketch, so both count the same pairs, and the ``safe`` guarantee holds
through either. These are plain objects: there is nothing to compile, and
``warmup`` builds and loads the kernels and runs each shape once. Both
satisfy the `CandidateSource` protocol.
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core.sketch import PAD_KEY
from repro_torch.engine import plans as PL
from repro_torch.engine.index import Postings
from repro_torch.kernels import ops as K

#: the concrete candidate sources (`plans.ShapePolicy.candidates` also
#: takes "auto")
CANDIDATE_SOURCES = ("scan", "inverted")

#: base rung of the gather-window ladder ``WINDOW_BASE · 2^i``
WINDOW_BASE = 8


def window_rung(max_run: int, base: int = WINDOW_BASE) -> int:
    """Smallest window on the ladder ``base · 2^i`` covering the longest
    equal-key postings run."""
    w = int(base)
    while w < max_run:
        w *= 2
    return w


@runtime_checkable
class CandidateSource(Protocol):
    """Stage-1 candidate generation as exact intersection hit counts.

    ``hit_counts`` takes the query tuple ``qa = (q_kh, q_val, q_mask,
    q_cmin, q_cmax)`` of ``B`` rows (``B``, the reference's bucket
    argument, may be passed too) and returns host ``f32 [B, C]`` counts:
    ``hits[b, c]`` is the exact size of the stored-key intersection of
    query ``b`` and column ``c`` (the sketch-join sample size m). Every
    source gives the same counts — the ``safe`` filter reads them as
    ground truth. ``kind`` names the source."""
    kind: str

    def hit_counts(self, qa, B: Optional[int] = None) -> np.ndarray: ...

    def warmup(self, B: int) -> None: ...


def _rows(qa, B: Optional[int]) -> None:
    if B is not None and int(B) != qa[0].shape[0]:
        raise ValueError(f"B={B} but the query tuple holds "
                         f"{qa[0].shape[0]} rows")


def _dummy_keys(B: int, n: int, device):
    """Empty query key planes (PAD patterns, zero masks)."""
    return (torch.full((B, n), PAD_KEY - 2**32, dtype=torch.int32,
                       device=device),
            torch.zeros((B, n), dtype=torch.float32, device=device))


def dense_hit_counts(cols: np.ndarray, counts: np.ndarray,
                     C: int) -> np.ndarray:
    """Scatter merged postings output (``[B, L]`` ids and counts, each live
    id once per row) into dense ``f32 [B, C]`` hit rows. Off the fused
    ``safe`` path; it serves the workloads that want all-candidate counts
    (`stage1_hits`, `search_joinable`, inverted ``topm``) and is the tests'
    oracle for the fused select."""
    B = cols.shape[0]
    hits = np.zeros((B, C), np.float32)
    b, s = np.nonzero(cols >= 0)
    hits[b, cols[b, s]] = counts[b, s]
    return hits


class ScanSource:
    """The containment scan over every resident column: each shard of the
    index (an `IndexShard` or a `MeshShard`) probes its own block."""

    kind = "scan"

    def __init__(self, shard):
        self.shard = PL.as_mesh_shard(shard)

    def hit_counts(self, qa, B: Optional[int] = None) -> np.ndarray:
        """Host ``f32 [B, C]`` exact hit counts of the query tuple
        ``qa = (q_kh, q_val, q_mask, q_cmin, q_cmax)``, in global-id
        order."""
        _rows(qa, B)
        rows = []
        for blk, dev in zip(self.shard.blocks, self.shard.mesh):
            with D.on(dev):
                rows.append(PL.probe(qa[0].to(dev), qa[2].to(dev), blk))
        return np.concatenate([h.cpu().numpy() for h in rows], axis=1)

    def warmup(self, B: int) -> None:
        for blk, dev in zip(self.shard.blocks, self.shard.mesh):
            with D.on(dev):
                PL.probe(*_dummy_keys(B, blk.key_hash.shape[1], dev), blk)


class InvertedSource:
    """The inverted key index as a candidate source: holds the `Postings`
    planes on the device and the window ``W`` their longest run needs."""

    kind = "inverted"

    def __init__(self, postings: Postings, *, C: int, n: int):
        self.C = int(C)
        self.n = int(n)
        self.E = postings.E
        self.W = window_rung(postings.max_run())
        self.keys = postings.keys
        self.cols = postings.cols

    def merged(self, q_kh, q_mask):
        """Device (cols, counts) ``[B, n·W]`` of the postings probe."""
        cand = PL.postings_window_candidates(q_kh, q_mask, self.keys,
                                             self.cols, self.W)
        return K.postings_merge(cand, self.C)

    def hit_counts(self, qa, B: Optional[int] = None) -> np.ndarray:
        _rows(qa, B)
        cols, counts = self.merged(qa[0], qa[2])
        return dense_hit_counts(cols.cpu().numpy(), counts.cpu().numpy(),
                                self.C)

    def warmup(self, B: int) -> None:
        self.merged(*_dummy_keys(B, self.n, self.keys.device))
