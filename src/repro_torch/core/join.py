"""Sketch joins (paper §3.2): align two sketches on their hashed keys.

The joined sketch ``L_{X⋈Y}`` keeps one row per key hash present in both
sketches; by Theorem 1 its value pairs are a uniform random sample of the
full join ``T_{X⋈Y}``, so any sample statistic applies downstream.

Also the KMV set-operation estimators of §2.1/§3.3: join cardinality
(Eq. 1) and Jaccard similarity — the same sketch answers joinability and
correlation queries.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hashing
from repro_torch.core.sketch import PAD_FIB, PAD_KEY, CorrelationSketch


@dataclasses.dataclass(frozen=True)
class SketchJoin:
    """Aligned value pairs of two sketches plus joinability statistics
    (paper Fig. 2, right table, and the §2.1/§3.3 estimators). Leading
    axes are the candidate batch of the join."""

    a: torch.Tensor          # f32 [..., n], X values aligned on common keys
    b: torch.Tensor          # f32 [..., n], Y values aligned on common keys
    mask: torch.Tensor       # bool [..., n], matches compacted to the front
    m: torch.Tensor          # int32 [...], |L_{X⋈Y}|
    union_kth: torch.Tensor  # f32 [...], U(k) of the combined KMV synopsis
    union_k: torch.Tensor    # int32 [...], k of the combined synopsis
    inter_k: torch.Tensor    # int32 [...], K_∩ (matches in the bottom-k)
    c_low: torch.Tensor      # f32 [...], range over the full columns (§4.3)
    c_high: torch.Tensor

    def join_size_estimate(self) -> torch.Tensor:
        """|K_X ∩ K_Y| estimate, Eq. (1): (K_∩/k) · (k−1)/U(k)."""
        k = self.union_k.to(torch.float32)
        est = ((self.inter_k.to(torch.float32) / torch.clamp(k, min=1.0))
               * (k - 1.0) / torch.clamp(self.union_kth, min=1e-30))
        return torch.where(k > 0, est, 0.0)

    def jaccard_estimate(self) -> torch.Tensor:
        """Jaccard(K_X, K_Y) ≈ K_∩ / k."""
        return (self.inter_k.to(torch.float32)
                / torch.clamp(self.union_k.to(torch.float32), min=1.0))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(x, idx, dim=-1)


def sketch_join(x: CorrelationSketch, y: CorrelationSketch) -> SketchJoin:
    """Join sketch ``x`` with every sketch of ``y`` on ``h(k)`` (paper
    Fig. 2, right table). ``y``'s leading axes are a batch of candidates;
    ``x`` is one sketch or a batch that broadcasts against it.

    Sort each candidate's keys, probe them with x's keys, compact the hits
    to the front (stably), then take the combined KMV bottom-k of the
    distinct union of both key sets for U(k) and K_∩. Plain PyTorch: the
    engine's ``sketch_join`` kernel computes moments, not these pairs."""
    n = max(x.n, y.n)
    lead = torch.broadcast_shapes(x.key_hash.shape[:-1], y.key_hash.shape[:-1])
    xv = x.values().expand(*lead, x.n)
    yv = y.values().expand(*lead, y.n)
    ymask = y.mask.expand(*lead, y.n)
    xmask = x.mask.expand(*lead, x.n)

    # sort y's keys for membership probes; pads (PAD_KEY) sort last
    ykh = torch.where(ymask, y.key_hash, PAD_KEY)
    ysort = torch.argsort(ykh, dim=-1, stable=True)
    ykh_s = _take(ykh, ysort)
    yv_s = _take(yv, ysort)
    ymask_s = _take(ymask, ysort)

    xkh = torch.where(xmask, x.key_hash, PAD_KEY).contiguous()
    pos = torch.clamp(torch.searchsorted(ykh_s.contiguous(), xkh), 0, y.n - 1)
    hit = xmask & _take(ymask_s, pos) & (_take(ykh_s, pos) == xkh)

    a = torch.where(hit, xv, 0.0)
    b = torch.where(hit, _take(yv_s, pos), 0.0)
    hit0 = hit
    if x.n != n:  # pad to the common size
        pad = lambda t: torch.nn.functional.pad(t, (0, n - x.n))
        a, b, hit = pad(a), pad(b), pad(hit)
    m = hit.sum(-1).to(torch.int32)

    # compact matches to the front, stably, so estimators see a dense prefix
    perm = torch.argsort((~hit).to(torch.int8), dim=-1, stable=True)
    a, b, hit = _take(a, perm), _take(b, perm), _take(hit, perm)

    # combined KMV synopsis: the k = min(k_x, k_y) smallest Fibonacci values
    # of the distinct union of the two key sets (Beyer et al.'s ⊕)
    k = torch.minimum(xmask.sum(-1), ymask.sum(-1))
    skh = torch.sort(torch.cat([xkh, ykh], dim=-1), dim=-1).values
    first = torch.ones_like(skh, dtype=torch.bool)
    first[..., 1:] = skh[..., 1:] != skh[..., :-1]
    distinct = first & (skh != PAD_KEY)
    fib_all = torch.where(distinct, hashing.fibonacci_u32(skh), PAD_FIB)
    fib_sorted = torch.sort(fib_all, dim=-1).values
    kth_fib = _take(fib_sorted, torch.clamp(k - 1, min=0)[..., None])[..., 0]
    union_kth = hashing.unit_interval(kth_fib)
    # K_∩: matched keys whose Fibonacci value ranks in the union's bottom-k
    matched_fib = torch.where(hit0, hashing.fibonacci_u32(xkh), PAD_FIB)
    inter_k = (hit0 & (matched_fib <= kth_fib[..., None])).sum(-1)

    return SketchJoin(
        a=a, b=b, mask=hit, m=m, union_kth=union_kth,
        union_k=k.to(torch.int32), inter_k=inter_k.to(torch.int32),
        c_low=torch.minimum(x.col_min, y.col_min).expand(lead),
        c_high=torch.maximum(x.col_max, y.col_max).expand(lead))
