"""The legacy query API of the engine, over the port's plans.

The serving core is `repro_torch.engine.plans`: a `ShapePolicy` (what
shapes a dispatch) and a `Request` (the query's semantics). This module
keeps the reference's older surface on top of it:

  * `QueryConfig` — the all-in-one config of the reference, every field
    and default kept; `plans.split_config` splits it into the pair.
  * `make_query_fn` / `make_stage1_fn` / `make_pruned_query_fn` /
    `make_topm_query_fn` — deprecated wrappers that build the matching
    plan (`plans.make_scan_fn` …) and bind the config's request operands,
    so they run the very plans `repro_torch.engine.serve.Server` runs.
  * `score_shard` / `_scores_from_stats` — the scan's stages specialised
    on one config (scorer math in `plans.score_stats`).
  * `query` — one query against an index shard on a mesh.

Each takes an `IndexShard` or a column-sharded `MeshShard`
(`engine.index.shard_for_mesh`); on a mesh, s4's normalisation bounds
are reduced across the shards (`plans._s4_bounds`), where the reference
reduces them over its mesh axes (``axis_names``). The port names no mesh
axes, so an ``axis_names`` other than None raises.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch import device as D
from repro_torch.core.bounds import hoeffding_eligibility_floor
from repro_torch.engine import plans as PL
from repro_torch.engine.index import MeshShard, place_shard, query_arrays
from repro_torch.kernels.ops import KernelConfig
from repro_torch.launch import mesh as MS

# the reference re-exports the rung helper from here
from repro_torch.engine.plans import prune_rung  # noqa: F401


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """The reference's query config (paper Defn. 3, DESIGN.md §5): the
    query model — ``k``, ``estimator``, ``scorer``, ``alpha``,
    ``min_sample``, ``prune`` — and the engine's shape knobs in one.
    `plans.split_config` maps it onto a (`ShapePolicy`, `Request`) pair;
    new code builds those directly."""
    k: int = 10
    estimator: str = "pearson"      # pearson | spearman | rin | qn
    scorer: str = "s4"              # s1 | s2 | s4  (s3 = bootstrap: host path)
    alpha: float = 0.05
    min_sample: int = 3
    #: the reference's kernel backend; picks no path here (`KernelConfig`)
    kernels: KernelConfig = KernelConfig()
    #: candidates scored per step; bounds the [B, chunk, nq] aligned tensors
    score_chunk: int = 512
    #: the reference's XLA intersect, "sortmerge" or "eqmatrix"; the port
    #: has one intersect, the kernel (`plans.split_config`)
    intersect: str = "sortmerge"
    #: two-stage retrieval: "off" (full scan), "safe" (only candidates whose
    #: exact stage-1 intersection reaches ``min_sample``), "topm" (each
    #: row's ``prune_m`` best by that intersection)
    prune: str = "off"              # off | safe | topm
    #: "topm" survivors per query row
    prune_m: int = 128
    #: base rung of the survivor ladder ``prune_base · 2^i``
    prune_base: int = 64


def _static_scorer(qcfg: QueryConfig) -> str:
    # every scorer outside {s1, s2} scores as s4, as in the reference
    return qcfg.scorer if qcfg.scorer in ("s1", "s2") else "s4"


def _split(qcfg: QueryConfig):
    """(ShapePolicy, request operand vector) of a config, with the
    reference's scorer/estimator leniency (`plans.split_config`)."""
    shape, req = PL.split_config(qcfg)
    return shape, PL.request_operands(req)


def _deprecated(name: str, replacement: str):
    warnings.warn(
        f"repro_torch.engine.query.{name} is deprecated; use "
        f"repro_torch.engine.plans.{replacement} (a ShapePolicy and a "
        "Request: per-request semantics are run-time arguments)",
        DeprecationWarning, stacklevel=3)


def _no_axes(axis_names) -> None:
    if axis_names is not None:
        raise ValueError("the port names no mesh axes: pass the shard as a "
                         "MeshShard (engine.index.shard_for_mesh) and s4's "
                         "bounds are reduced across its shards")


# ----------------------------------------------------------------------------
# the scan's stages, specialised on one config
# ----------------------------------------------------------------------------

def score_shard(q_kh, q_val, q_mask, q_cmin, q_cmax, shard,
                qcfg: QueryConfig, axis_names=None):
    """Score every candidate of ``shard`` (an `IndexShard` or a
    `MeshShard`): estimator → Hoeffding CI → scorer (§4) → (scores, r, m,
    ci_len), each ``[C]`` for one query (``q_kh [nq]``) or ``[B, C]`` for a
    batch, in global-id order on the first shard's device. s4 normalises
    each query row over every shard's eligible candidates. The reference's
    ``prep=`` (its XLA sort tables) is not taken: passing it raises
    TypeError."""
    _no_axes(axis_names)
    ms = PL.as_mesh_shard(shard)
    single = q_kh.dim() == 1
    qa = (q_kh, q_val, q_mask, q_cmin, q_cmax)
    if single:
        qa = tuple(a[None] for a in qa)
    shape, req = PL.split_config(qcfg)
    floor = float(hoeffding_eligibility_floor(req.min_sample))
    stats = []
    for blk, dev in zip(ms.blocks, ms.mesh):
        with D.on(dev):
            stats.append(PL._shard_stats(*PL._on(qa, dev), blk,
                                         shape.score_chunk, req.estimator,
                                         req.alpha))
    scores = PL.score_shards(stats, _static_scorer(qcfg), floor)
    dev0 = ms.mesh[0]
    out = tuple(torch.cat([x.to(dev0) for x in xs], -1)
                for xs in (scores, *zip(*stats)))
    return tuple(o[0] for o in out) if single else out


def _scores_from_stats(r, m, ci_len, qcfg: QueryConfig, axis_names=None):
    """Deprecated: the scoring tail of (r, m, ci_len) under the config's
    scorer — `plans.score_stats`."""
    _no_axes(axis_names)
    return PL.score_stats(r, m, ci_len, _static_scorer(qcfg),
                          float(hoeffding_eligibility_floor(qcfg.min_sample)))


def select_survivors(hits, qcfg: QueryConfig):
    """Host stage-1 → stage-2 selection under the config's prune mode
    (`plans.select_survivors`)."""
    return PL.select_survivors(hits, prune=qcfg.prune,
                               min_sample=qcfg.min_sample,
                               prune_m=qcfg.prune_m)


# ----------------------------------------------------------------------------
# deprecated plan builders
# ----------------------------------------------------------------------------

def _bind(fn, ops):
    return lambda *args: fn(*args, ops)


def make_query_fn(mesh, C_total: int, n: int, qcfg: QueryConfig,
                  batch: Optional[int] = None, with_prep: bool = False):
    """Deprecated: the full-scan plan of one config, ``fn(q_kh, q_val,
    q_mask, q_cmin, q_cmax, shard)`` → top-k (scores, ids, r, m)
    (`plans.make_scan_fn` with the config's operands bound)."""
    _deprecated("make_query_fn", "make_scan_fn")
    shape, ops = _split(qcfg)
    return _bind(PL.make_scan_fn(mesh, C_total, n, shape, batch=batch,
                                 with_prep=with_prep), ops)


def make_stage1_fn(mesh, C_total: int, n: int, qcfg: QueryConfig,
                   batch: Optional[int] = None, with_prep: bool = False,
                   emit_tables: bool = False):
    """Deprecated: the stage-1 plan, ``fn(q_kh, q_val, q_mask, q_cmin,
    q_cmax, shard)`` → exact hit counts (`plans.make_probe_fn`;
    request-independent, nothing to bind)."""
    _deprecated("make_stage1_fn", "make_probe_fn")
    shape, _ = _split(qcfg)
    return PL.make_probe_fn(mesh, C_total, n, shape, batch=batch,
                            with_prep=with_prep, emit_tables=emit_tables)


def make_pruned_query_fn(mesh, C_total: int, n: int, qcfg: QueryConfig,
                         M: int, batch: Optional[int] = None,
                         with_prep: bool = False):
    """Deprecated: the stage-2 plan at rung ``M``, ``fn(q_kh, q_val,
    q_mask, q_cmin, q_cmax, shard, surv, valid)`` (`plans.make_pruned_fn`
    with the config's operands bound)."""
    _deprecated("make_pruned_query_fn", "make_pruned_fn")
    shape, ops = _split(qcfg)
    return _bind(PL.make_pruned_fn(mesh, C_total, n, shape, M, batch=batch,
                                   with_prep=with_prep), ops)


def make_topm_query_fn(mesh, C_total: int, n: int, qcfg: QueryConfig,
                       batch: int, with_prep: bool = False):
    """Deprecated: the ``prune="topm"`` plan, ``fn(q_kh, q_val, q_mask,
    q_cmin, q_cmax, shard)`` (`plans.make_topm_fn` with the config's
    operands bound)."""
    _deprecated("make_topm_query_fn", "make_topm_fn")
    shape, ops = _split(qcfg)
    return _bind(PL.make_topm_fn(mesh, C_total, n, shape, batch=batch,
                                 with_prep=with_prep), ops)


def _placed(shard, mesh):
    """``shard`` over ``mesh``: a `MeshShard` as it is (its shard count
    must be the mesh's); an `IndexShard` as a one-shard mesh on its own
    device when the mesh has one device, else placed over the mesh
    (`engine.index.place_shard`)."""
    if isinstance(shard, MeshShard):
        if len(shard.mesh) != len(mesh):
            raise ValueError(f"a {len(shard.mesh)}-shard index on a "
                             f"{len(mesh)}-device mesh")
        return shard
    if len(mesh) == 1:
        return PL.as_mesh_shard(shard)
    return place_shard(shard, mesh)


def query(index_shard, query_sketch, mesh, qcfg: QueryConfig):
    """One query (paper Defn. 3): the full scan of ``index_shard`` (an
    `IndexShard` or a `MeshShard`) over ``mesh`` (a sequence of devices,
    `repro_torch.launch.mesh`; None: the CUDA card) for one query sketch
    → top-``qcfg.k`` (scores, ids, r, m), each ``[min(k, C)]`` tensors on
    the first shard's device; ids are positions of the padded index."""
    mesh = MS.as_mesh(mesh)
    ms = _placed(index_shard, mesh)
    shape, ops = _split(qcfg)
    fn = PL.make_scan_fn(mesh, ms.num_columns, ms.blocks[0].key_hash.shape[1],
                         shape)
    return fn(*query_arrays(query_sketch), ms, ops)

