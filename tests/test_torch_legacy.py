"""The port's legacy query API against the JAX package's, on the same numpy
inputs from a seed: `QueryConfig` and `plans.split_config`, `score_shard`,
the four deprecated `make_*_query_fn` builders and `query()` (on one
device, and on a 4-shard CPU mesh against one shard), `QueryServer` and
`LiveQueryServer`, the `CandidateSource` protocol, `joined_truth`, and
the port of the augmentation example's discovery step
(`repro_torch.train_augmented`).

Tolerances are the slices': integers (m, hits, survivors) exactly, floats
within 5e-5, top-k ids exactly except where a neighbour's reference score
is within 5e-5. The corpus: 5 `multi_column_group` tables × 7 columns
(C = 35) at n = 64; queries are the latent columns of tables 0–2 with
noise, cut to 500 rows.
"""
import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.engine import index as JI
from repro.engine import lifecycle as JL
from repro.engine import plans as JPL
from repro.engine import query as JQ
from repro.engine import serve as JSV
from repro_torch import convert
from repro_torch.data import pipeline as TP
from repro_torch.engine import candidates as TCD
from repro_torch.engine import index as TI
from repro_torch.engine import lifecycle as TL
from repro_torch.engine import plans as TPL
from repro_torch.engine import query as TQ
from repro_torch.engine import serve as TSV
from repro_torch.launch.mesh import make_host_mesh

_ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 5e-5
N = 64
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    groups = [JP.multi_column_group(np.random.default_rng(10 + i), n_cols=7,
                                    n_max=1200, name=f"g{i}", keep_latent=True)
              for i in range(5)]
    jidx = JI.build_index(groups, n=N)          # C = 35 = 5 · 7
    rng = np.random.default_rng(3)
    keys = [g.keys[:500] for g in groups[:3]]
    vals = [g.meta["latent"][:500] + 0.5 * rng.normal(size=500).astype(np.float32)
            for g in groups[:3]]
    jsk = JSV.build_query_sketches(keys, vals, n=N, chunk=256)
    tidx = convert.index_from_reference(jidx.shard, jidx.names, N, device=CPU)
    tsk = convert.sketches_from_reference(jsk, device=CPU)
    jmesh = jax.make_mesh((1,), ("shard",))
    return dict(groups=groups, keys=keys, vals=vals, jidx=jidx, tidx=tidx,
                jsk=jsk, tsk=tsk, qa_j=JSV.query_arrays(jsk),
                qa_t=TI.query_arrays(tsk), jmesh=jmesh,
                jshard=JI.shard_for_mesh(jidx, jmesh), tmesh=(CPU,))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _agree(want, got):
    """(scores, ids, r, m) at the slices' tolerances, rows ``[.., k]``."""
    ws, wi, wr, wm = (np.atleast_2d(_np(x)) for x in want)
    gs, gi, gr, gm = (np.atleast_2d(_np(x)) for x in got)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gr, wr, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(gm, wm)
    for q, p in zip(*np.nonzero(gi != wi)):
        row = ws[q]
        near = [abs(row[p] - row[j]) <= TOL for j in (p - 1, p + 1)
                if 0 <= j < row.shape[0]]
        assert any(near), (q, p, wi[q], gi[q], row)


def _same(a, b):
    """Bit for bit, output by output."""
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(x), _np(y))


def _one(qa, row):
    return tuple(a[row] for a in qa)


# ----------------------------------------------------------------------------
# the config and its split
# ----------------------------------------------------------------------------

def test_query_config_fields_and_defaults():
    """Every field of the reference's `QueryConfig`, in order, with its
    default; `KernelConfig`'s backend and properties likewise."""
    jf = [(f.name, f.default) for f in dataclasses.fields(JQ.QueryConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TQ.QueryConfig)]
    assert [n for n, _ in tf] == [n for n, _ in jf]
    for (name, td), (_, jd) in zip(tf, jf):
        if name == "kernels":
            assert td.backend == jd.backend
        else:
            assert td == jd, name
    from repro.kernels.ops import KernelConfig as JKC
    for b in ("xla", "pallas", "interpret"):
        t, j = TQ.KernelConfig(b), JKC(b)
        assert (t.interpret, t.use_pallas) == (j.interpret, j.use_pallas)


@pytest.mark.parametrize("cfg", [
    dict(), dict(k=7, estimator="spearman", scorer="s2", alpha=0.1,
                 min_sample=5, score_chunk=33, prune="safe", prune_m=9,
                 prune_base=4),
    dict(estimator="rin", scorer="s1", prune="topm"), dict(estimator="qn"),
    dict(intersect="eqmatrix"), dict(intersect="bitset"),
    # the leniency cases: unknown scorer → s4, unknown estimator → pearson
    dict(scorer="s3", estimator="kendall"), dict(scorer="s9"),
])
def test_split_config_matches_reference(cfg):
    tshape, treq = TPL.split_config(TQ.QueryConfig(**cfg))
    jshape, jreq = JPL.split_config(JQ.QueryConfig(**cfg))
    assert dataclasses.asdict(treq) == dataclasses.asdict(jreq)
    for f in dataclasses.fields(TPL.ShapePolicy):
        assert getattr(tshape, f.name) == getattr(jshape, f.name), f.name
    np.testing.assert_array_equal(TPL.request_operands(treq),
                                  JPL.request_operands(jreq))


def test_split_config_unknown_prune_raises_on_both_sides():
    with pytest.raises(ValueError, match="prune"):
        JPL.split_config(JQ.QueryConfig(prune="sometimes"))
    with pytest.raises(ValueError, match="prune"):
        TPL.split_config(TQ.QueryConfig(prune="sometimes"))
    with pytest.raises(ValueError, match="prune"):
        TSV.Server(TI.SketchIndex(shard=None, names=[], n=N),
                   TQ.QueryConfig(prune="sometimes"), device="cpu")


# ----------------------------------------------------------------------------
# score_shard and the scoring tail
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("est", TPL.ESTIMATORS)
@pytest.mark.parametrize("chunk", [7, 16])   # 35 = 5 · 7; 35 % 16 != 0
def test_score_shard_matches_reference(setup, est, chunk):
    """A batch of 3 queries for each scorer against the reference's
    `score_shard`; each query alone equals its row of the batch bit for
    bit, and (s4) the reference's single-query call."""
    qa_t, qa_j = setup["qa_t"], setup["qa_j"]
    for sc in TPL.FAST_SCORERS:
        cfg = dict(k=5, estimator=est, scorer=sc, score_chunk=chunk)
        got = TQ.score_shard(*qa_t, setup["tidx"].shard, TQ.QueryConfig(**cfg))
        want = JQ.score_shard(*qa_j, setup["jidx"].shard, JQ.QueryConfig(**cfg))
        assert got[0].shape == (3, 35)
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            fin = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), fin)
            np.testing.assert_allclose(g[fin], w[fin], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[2].max() >= 20       # the planted columns joined
        for row in range(3):
            one = TQ.score_shard(*_one(qa_t, row), setup["tidx"].shard,
                                 TQ.QueryConfig(**cfg))
            _same(one, (x[row] for x in got))
        if sc == "s4":
            jone = JQ.score_shard(*_one(qa_j, 1), setup["jidx"].shard,
                                  JQ.QueryConfig(**cfg))
            for g, w in zip((x[1] for x in got), jone):
                w = np.asarray(w)
                fin = np.isfinite(w)
                np.testing.assert_allclose(g.numpy()[fin], w[fin], rtol=TOL,
                                           atol=TOL)


def test_scores_from_stats_and_axis_names(setup):
    rng = np.random.default_rng(5)
    r = rng.uniform(-1, 1, size=(2, 8)).astype(np.float32)
    m = rng.integers(0, 9, size=(2, 8)).astype(np.float32)
    ci = rng.uniform(0.1, 5.0, size=(2, 8)).astype(np.float32)
    for sc in ("s1", "s2", "s4", "s3"):
        got = TQ._scores_from_stats(*(torch.from_numpy(x) for x in (r, m, ci)),
                                    TQ.QueryConfig(scorer=sc))
        want = JQ._scores_from_stats(*(jax.numpy.asarray(x) for x in (r, m, ci)),
                                     JQ.QueryConfig(scorer=sc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    with pytest.raises(ValueError, match="axes"):
        TQ.score_shard(*setup["qa_t"], setup["tidx"].shard, TQ.QueryConfig(),
                       axis_names=("shard",))
    with pytest.raises(TypeError):
        TQ.score_shard(*setup["qa_t"], setup["tidx"].shard, TQ.QueryConfig(),
                       prep=None)


# ----------------------------------------------------------------------------
# the deprecated builders and query()
# ----------------------------------------------------------------------------

def test_builders_match_reference(setup):
    """The four `make_*_query_fn` builders at B = 3 and their single-query
    forms, against the reference's on a one-device mesh; each warns."""
    qcfg_kw = dict(k=5, scorer="s4", prune_base=4, score_chunk=16)
    tq, jq = TQ.QueryConfig(**qcfg_kw), JQ.QueryConfig(**qcfg_kw)
    qa_t, qa_j = setup["qa_t"], setup["qa_j"]
    tshard, jshard = setup["tidx"].shard, setup["jshard"]
    tm, jm = setup["tmesh"], setup["jmesh"]
    C = 35

    with pytest.warns(DeprecationWarning, match="repro_torch.engine.plans"):
        tfn = TQ.make_query_fn(tm, C, N, tq, batch=3)
    with pytest.warns(DeprecationWarning):
        jfn = JQ.make_query_fn(jm, C, N, jq, batch=3)
    got = tfn(*qa_t, tshard)
    _agree(jfn(*qa_j, jshard), got)
    with pytest.warns(DeprecationWarning):
        tone = TQ.make_query_fn(tm, C, N, tq)
        jone = JQ.make_query_fn(jm, C, N, jq)
    for row in range(3):
        one = tone(*_one(qa_t, row), tshard)
        assert one[0].shape == (5,)
        _same(one, (x[row] for x in got))
        _agree(jone(*_one(qa_j, row), jshard), one)

    with pytest.warns(DeprecationWarning, match="make_probe_fn"):
        t1 = TQ.make_stage1_fn(tm, C, N, tq, batch=3)
    with pytest.warns(DeprecationWarning):
        j1 = JQ.make_stage1_fn(jm, C, N, jq, batch=3)
    hits = t1(*qa_t, tshard).numpy()
    np.testing.assert_array_equal(hits, np.asarray(j1(*qa_j, jshard)))
    with pytest.warns(DeprecationWarning):
        t1one = TQ.make_stage1_fn(tm, C, N, tq)
    np.testing.assert_array_equal(t1one(*_one(qa_t, 2), tshard).numpy(),
                                  hits[2])

    safe_t = dataclasses.replace(tq, prune="safe")
    surv = TQ.select_survivors(hits, safe_t)
    np.testing.assert_array_equal(
        surv, JQ.select_survivors(hits, dataclasses.replace(jq, prune="safe")))
    rung = TQ.prune_rung(max(len(surv), tq.k), tq.prune_base, C, 1)
    assert rung == JQ.prune_rung(max(len(surv), jq.k), jq.prune_base, C, 1)
    assert 0 < len(surv) < C and rung is not None
    idx_v = np.zeros((rung,), np.int32)
    idx_v[:len(surv)] = surv
    valid = np.arange(rung) < len(surv)
    with pytest.warns(DeprecationWarning, match="make_pruned_fn"):
        tp = TQ.make_pruned_query_fn(tm, C, N, tq, rung, batch=3)
    with pytest.warns(DeprecationWarning):
        jp = JQ.make_pruned_query_fn(jm, C, N, jq, rung, batch=3)
    got_p = tp(*qa_t, tshard, idx_v, valid)
    _agree(jp(*qa_j, jshard, jax.numpy.asarray(idx_v), jax.numpy.asarray(valid)),
           got_p)
    _agree(got, got_p)      # safe loses no top-k column
    with pytest.warns(DeprecationWarning):
        tpone = TQ.make_pruned_query_fn(tm, C, N, tq, rung)
    _same(tpone(*_one(qa_t, 0), tshard, idx_v, valid), (x[0] for x in got_p))

    with pytest.warns(DeprecationWarning, match="make_topm_fn"):
        tt = TQ.make_topm_query_fn(tm, C, N, tq, batch=3)
    with pytest.warns(DeprecationWarning):
        jt = JQ.make_topm_query_fn(jm, C, N, jq, batch=3)
    _agree(jt(*qa_j, jshard), tt(*qa_t, tshard))

    # the XLA-only tables are refused, and a call must match the build
    for fn in (lambda: TQ.make_query_fn(tm, C, N, tq, batch=3, with_prep=True),
               lambda: TQ.make_stage1_fn(tm, C, N, tq, batch=3,
                                         emit_tables=True)):
        with pytest.warns(DeprecationWarning), pytest.raises(ValueError,
                                                             match="prep"):
            fn()
    with pytest.raises(ValueError, match="batch-3"):
        tfn(*_one(qa_t, 0), tshard)
    with pytest.warns(DeprecationWarning):
        wrong = TQ.make_query_fn(tm, 36, N, tq, batch=3)
    with pytest.raises(ValueError, match="built for"):
        wrong(*qa_t, tshard)


@pytest.mark.parametrize("est,sc", [("pearson", "s4"), ("spearman", "s1"),
                                    ("rin", "s2"), ("qn", "s4")])
def test_query_matches_reference_and_four_shards(setup, est, sc):
    """`query()` for one query sketch against the reference's; over a
    4-shard CPU mesh (`shard_for_mesh`, C padded to 36) equal to one shard
    bit for bit, and an `IndexShard` on that mesh is placed over it."""
    qcfg_kw = dict(k=10, estimator=est, scorer=sc, score_chunk=16)
    tsk = setup["tsk"].map(lambda a: a[1])
    jsk = jax.tree.map(lambda a: a[1], setup["jsk"])
    got = TQ.query(setup["tidx"].shard, tsk, setup["tmesh"],
                   TQ.QueryConfig(**qcfg_kw))
    assert got[0].shape == (10,)
    _agree(JQ.query(setup["jshard"], jsk, setup["jmesh"],
                    JQ.QueryConfig(**qcfg_kw)), got)
    mesh4 = make_host_mesh(4, device="cpu")
    sharded = TI.shard_for_mesh(setup["tidx"], mesh4)
    assert len(sharded.blocks) == 4 and sharded.num_columns == 36
    four = TQ.query(sharded, tsk, mesh4, TQ.QueryConfig(**qcfg_kw))
    assert np.isfinite(got[0].numpy()).sum() >= 5
    _same(four, got)        # −inf slots' ids too: ties go to the lower id
    _same(TQ.query(setup["tidx"].shard, tsk, mesh4, TQ.QueryConfig(**qcfg_kw)),
          got)
    # score_shard over the mesh: s4's bounds reduced across the shards
    s4 = TQ.QueryConfig(**qcfg_kw)
    whole = TQ.score_shard(*setup["qa_t"], setup["tidx"].shard, s4)
    split = TQ.score_shard(*setup["qa_t"], sharded, s4)
    _same((x[:, :35] for x in split), whole)


def test_query_needs_a_device_without_cuda(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.query(setup["tidx"].shard, setup["tsk"].map(lambda a: a[0]), None,
                 TQ.QueryConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        with pytest.warns(DeprecationWarning):
            TSV.QueryServer(None, setup["tidx"].shard, TQ.QueryConfig())


# ----------------------------------------------------------------------------
# the deprecated servers
# ----------------------------------------------------------------------------

def _query_servers(setup, qcfg_kw, **kw):
    with pytest.warns(DeprecationWarning, match="QueryServer is deprecated"):
        t = TSV.QueryServer(setup["tmesh"], setup["tidx"].shard,
                            TQ.QueryConfig(**qcfg_kw), buckets=(2,),
                            index=setup["tidx"], **kw)
    with pytest.warns(DeprecationWarning):
        j = JSV.QueryServer(setup["jmesh"], setup["jshard"],
                            JQ.QueryConfig(**qcfg_kw), buckets=(2,),
                            index=setup["jidx"], **kw)
    return t, j


@pytest.mark.parametrize("prune", TPL.PRUNE_MODES)
def test_query_server_matches_reference(setup, prune):
    """Raw `query_batch` output (3 queries in two 2-query dispatches), the
    reference's conventions included: on the full scan the ids of −inf
    rows are the plan's (here k = 20 exceeds every query's eligible
    columns), −1 on the pruned paths; `Server` gives −1 there."""
    qcfg_kw = dict(k=20, scorer="s4", prune=prune, prune_base=4, prune_m=8,
                   score_chunk=16)
    t, j = _query_servers(setup, qcfg_kw)
    got, want = t.query_batch(setup["tsk"]), j.query_batch(setup["jsk"])
    _agree(want, got)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    dead = ~np.isfinite(got[0])
    assert dead.any()
    if prune == "off":
        assert (got[1][dead] >= 0).all()
    else:
        assert (got[1][dead] == -1).all()
    unified = TSV.Server(setup["tidx"], TQ.QueryConfig(**qcfg_kw), buckets=(2,),
                         device="cpu").query_batch(setup["tsk"])
    fin = ~dead
    for g, u in zip(got, unified):
        np.testing.assert_array_equal(g[fin], u[fin])
    assert (unified[1][dead] == -1).all()
    assert t.qcfg.prune == prune and t.request.prune == prune


def test_query_server_legacy_surface(setup, monkeypatch):
    """The accessors, the warmup of only the configured prune mode, the
    block-row rule per server, and the reference's ``cache=`` / ``prep=``
    refused with TypeError."""
    qcfg_kw = dict(k=5, scorer="s2", prune_base=4, score_chunk=16)
    t, j = _query_servers(setup, qcfg_kw)
    for B in (1, 2, 8, 32):
        assert t.qcfg_for(B).score_chunk == j.qcfg_for(B).score_chunk
    assert t.prune_rungs() == j.prune_rungs()
    assert t.bucket_for(1) == j.bucket_for(1) == 2
    # the block-row budget: the port's `BLOCK_ROWS` unless given (the
    # reference's default is 8 · score_chunk); a given one is the same rule
    assert t.C == j.C == 35 and t.batch_rows == TSV.BLOCK_ROWS
    small, jsmall = _query_servers(setup, dict(qcfg_kw, score_chunk=512),
                                   batch_rows=256)
    assert small.batch_rows == jsmall.batch_rows == 256
    for B in (1, 2, 8, 32):
        assert small.qcfg_for(B) == dataclasses.replace(
            small.qcfg, score_chunk=jsmall.qcfg_for(B).score_chunk)
    assert small._exec.chunk_for(8) == 64

    qa = tuple(a[:2] for a in setup["qa_t"])
    ops = TPL.request_operands(t.request)
    raw = t.query_fn(2)(*qa, t.shard, ops)
    _same((x[:, :5] for x in raw),
          t.query_batch(setup["tsk"].map(lambda a: a[:2])))
    np.testing.assert_array_equal(t.stage1_fn(2)(*qa, t.shard).numpy(),
                                  t.stage1_hits(setup["tsk"])[:2])
    np.testing.assert_array_equal(t.stage1_hits(setup["tsk"]),
                                  j.stage1_hits(setup["jsk"]))
    out = t.stage2_fn(2, 8)(*qa, t.shard, np.arange(8, dtype=np.int32),
                            np.ones(8, bool), ops)
    assert out[0].shape == (2, 5)
    assert t.topm_fn(2)(*qa, t.shard, ops)[0].shape == (2, 5)
    with pytest.raises(ValueError, match="prep"):
        t.stage1_fn(2, emit_tables=True)

    # warmup runs the plans of the configured prune mode only (`Server`'s
    # runs every mode's)
    ran = set()
    for name in ("scan", "topm", "pruned"):
        real = getattr(TPL, name)
        monkeypatch.setattr(TPL, name, lambda *a, _n=name, _f=real, **k: (
            ran.add(_n), _f(*a, **k))[1])
    for mode, plans in (("off", {"scan"}), ("topm", {"topm", "pruned"}),
                        ("safe", {"scan", "pruned"})):
        srv, _ = _query_servers(setup, dict(qcfg_kw, prune=mode))
        ran.clear()
        srv.warmup()
        assert ran == plans, mode
        assert set(srv._bucket_cost) == {2}
    full = TSV.Server(setup["tidx"], TQ.QueryConfig(**qcfg_kw), buckets=(2,),
                      device="cpu")
    ran.clear()
    full.warmup()
    assert ran == {"scan", "topm", "pruned"}

    res = t.search_joinable(setup["keys"], k=3)
    jres = j.search_joinable(setup["keys"], k=3)
    np.testing.assert_array_equal(res.ids, np.asarray(jres.ids))
    for bad in (dict(cache=None), dict(prep=None)):
        with pytest.raises(TypeError):
            TSV.QueryServer(setup["tmesh"], setup["tidx"].shard,
                            TQ.QueryConfig(**qcfg_kw), **bad)
    assert issubclass(TSV.QueryServer, TSV.Server)
    assert issubclass(TL.LiveQueryServer, TSV.Server)


def test_live_query_server_matches_reference():
    """`LiveQueryServer` over the same live index as the reference's:
    positional ``refresh``, the `live` property, the warmup of only the
    configured prune mode, and results through appends and a delete."""
    def groups(P):
        rng = np.random.default_rng(0)
        return [P.multi_column_group(rng, n_cols=3, n_max=700, name=f"g{i}",
                                     keep_latent=True) for i in range(4)]

    jgroups, tgroups = groups(JP), groups(TP)
    jlive = JL.LiveIndex(n=32, delta_cap=4)
    jlive.append(jgroups[:2])
    tlive = convert.live_index_from_reference(jlive, device=CPU)
    qcfg_kw = dict(k=4, scorer="s1", prune="safe", prune_base=4)
    with pytest.warns(DeprecationWarning, match="LiveQueryServer is deprecated"):
        t = TL.LiveQueryServer((CPU,), tlive, TQ.QueryConfig(**qcfg_kw),
                               buckets=(1, 2))
    with pytest.warns(DeprecationWarning):
        j = JL.LiveQueryServer(jax.make_mesh((1,), ("shard",)), jlive,
                               JQ.QueryConfig(**qcfg_kw), buckets=(1, 2))
    assert t.live is tlive and j.live is jlive
    t.warmup()
    assert "stage1" in t.throughput()["stages"]    # the cost runs are safe
    keys = [g.keys[:300] for g in jgroups]
    vals = [g.meta["latent"][:300] for g in jgroups]
    jsk = JSV.build_query_sketches(keys, vals, n=32, chunk=256)
    tsk = convert.sketches_from_reference(jsk, device=CPU)
    _agree(j.query_batch(jsk, True), t.query_batch(tsk, True))
    jlive.append(jgroups[2:])
    tlive.append(tgroups[2:])
    jlive.delete("g0")
    tlive.delete("g0")
    stale = t.query_batch(tsk, False)          # positional: no refresh
    assert t.names != tlive.names()
    _agree(j.query_batch(jsk, True), t.query_batch(tsk, True))
    assert t.names == tlive.names() == jlive.names()
    assert stale[1].shape == (4, 4)


# ----------------------------------------------------------------------------
# candidate sources, joined_truth
# ----------------------------------------------------------------------------

def test_candidate_sources_satisfy_the_protocol(setup):
    shard = setup["tidx"].shard
    post = TI.build_postings(shard.key_hash, shard.mask)
    scan = TCD.ScanSource(shard)
    inv = TCD.InvertedSource(post, C=35, n=N)
    for src, kind in ((scan, "scan"), (inv, "inverted")):
        assert isinstance(src, TCD.CandidateSource) and src.kind == kind
    assert not isinstance(object(), TCD.CandidateSource)
    qa = setup["qa_t"]
    np.testing.assert_array_equal(scan.hit_counts(qa, 3), inv.hit_counts(qa))
    with pytest.raises(ValueError):
        scan.hit_counts(qa, 2)


@pytest.mark.parametrize("agg", ["mean", "sum", "min", "max", "count",
                                 "first", "last"])
def test_joined_truth_matches_reference(agg):
    """Repeated keys, NaNs and partial overlap: equal bit for bit."""
    rng = np.random.default_rng(7)
    keys = rng.choice(1 << 20, size=400, replace=False).astype(np.uint32)
    kx = keys[rng.integers(0, 300, size=1500)]
    ky = keys[rng.integers(100, 400, size=900)]
    vx = rng.normal(size=1500).astype(np.float32)
    vy = rng.normal(size=900).astype(np.float32)
    vx[rng.random(1500) < 0.05] = np.nan
    want = JP.joined_truth(JP.Table(keys=kx, values=vx), JP.Table(keys=ky, values=vy),
                           agg=agg)
    got = TP.joined_truth(TP.Table(keys=kx, values=vx), TP.Table(keys=ky, values=vy),
                          agg=agg)
    assert got[0].shape[0] > 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------------
# the augmentation example's discovery step
# ----------------------------------------------------------------------------

def test_train_augmented_matches_reference(capsys, monkeypatch):
    """The port's `discover_and_augment` on the CPU against the reference
    example: the same two picks, r̂ within 5e-5, RMSE equal to three
    decimals, and the same two printed lines."""
    from repro_torch import train_augmented as TA
    monkeypatch.syspath_prepend(os.path.join(_ROOT, "examples"))
    import train_augmented as JA
    seen = {}
    real = JA.Q.query

    def spy(*args):
        seen["out"] = real(*args)
        return seen["out"]

    monkeypatch.setattr(JA.Q, "query", spy)
    JA.discover_and_augment()
    want_out = capsys.readouterr().out
    picked, r_hat, r0, r1 = TA.discover_and_augment("cpu")
    got_out = capsys.readouterr().out
    assert got_out == want_out
    _, g, r, _ = (np.asarray(x) for x in seen["out"])
    assert picked == [int(i) for i in g[:2]] and set(picked) == {0, 1}
    np.testing.assert_allclose(r_hat, r[:2], rtol=TOL, atol=TOL)
    rm = re.search(r"RMSE: ([0-9.]+) → ([0-9.]+)", want_out)
    assert (f"{r0:.3f}", f"{r1:.3f}") == rm.groups()
    assert r1 < 0.6 * r0
