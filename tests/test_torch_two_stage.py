"""Two-stage retrieval in the port: the containment kernel's twin, the
stage-1 probe, the survivor filter, and the port's `Server` under
``prune="safe"`` / ``"topm"`` through both candidate sources against the
JAX `Server`, plus the joinability search. (The CUDA kernel against its twin:
`tests/test_torch_kernels.py`.)

Corpus: 16 tables × 4 columns (C = 64) at n = 32, keys from per-table
universes; each query takes most of its keys from one table and some from
a second, so it joins 4–8 columns and the survivor set is a real subset.
Top-k ids must be equal except at near-ties (a neighbour's reference score
within 5e-5); r, m and scores agree within 5e-5 — `tests/test_torch_serve.py`'s
rule. Hit counts, m and survivor sets are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as JB
from repro.core import containment as JCT
from repro.data.pipeline import TableGroup
from repro.engine import index as JI
from repro.engine import plans as JPL
from repro.engine import serve as SV
from repro.kernels import ops as JK
from repro.kernels import ref as JR
from repro.kernels.ops import KernelConfig
from repro_torch import convert
from repro_torch.core import bounds as TB
from repro_torch.core import containment as TCT
from repro_torch.engine import candidates as TCD
from repro_torch.engine import index as TI
from repro_torch.engine import plans as TPL
from repro_torch.engine import serve as TSV
from repro_torch.kernels import containment as TC
from repro_torch.kernels import ops, ref

TOL = 5e-5
N = 32
GROUPS, COLS = 16, 4
NQ = 6
K_MAX = 5
POLICY = dict(k_max=K_MAX, score_chunk=16, prune_base=4, prune_m=6)


def _groups(rng):
    out = []
    for g in range(GROUPS):
        m = int(rng.integers(200, 900))
        keys = (rng.choice(3000, size=m, replace=False) + g * 10_000).astype(
            np.uint32)
        latent = rng.standard_normal(m).astype(np.float32)
        vals = np.stack([latent * w + rng.standard_normal(m).astype(np.float32)
                         for w in (2.0, 1.0, 0.5, 0.0)])
        out.append(TableGroup(keys=keys, values=vals.astype(np.float32),
                              name=f"g{g}", meta=dict(latent=latent)))
    return out


def _queries(rng, groups):
    """Query q: 60–400 rows of table q, a sixth as many of table q + 3; the
    last query's keys join nothing."""
    keys, vals = [], []
    for q in range(NQ):
        a, b = groups[q % GROUPS], groups[(q + 3) % GROUPS]
        na = int(rng.integers(60, 400))
        ia = rng.choice(a.keys.shape[0], size=na, replace=False)
        ib = rng.choice(b.keys.shape[0], size=na // 6, replace=False)
        k = np.concatenate([a.keys[ia], b.keys[ib]])
        v = np.concatenate([a.meta["latent"][ia], b.meta["latent"][ib]])
        if q == NQ - 1:
            k = (np.arange(k.shape[0]) + 900_000).astype(np.uint32)
        keys.append(k)
        vals.append((v + 0.5 * rng.standard_normal(v.shape[0])).astype(
            np.float32))
    return keys, vals


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(12)
    groups = _groups(rng)
    keys, vals = _queries(rng, groups)
    index = JI.build_index(groups, n=N)
    mesh = jax.make_mesh((1,), ("shard",))
    jsrv = {c: SV.Server(mesh, index, JPL.ShapePolicy(candidates=c, **POLICY),
                         buckets=(4,))
            for c in ("scan", "inverted")}
    carried = convert.index_from_reference(index.shard, index.names, index.n,
                                           device="cpu")
    tsrv = {c: TSV.Server(carried, TPL.ShapePolicy(candidates=c, **POLICY),
                          buckets=(4,), device="cpu")
            for c in ("scan", "inverted")}
    jsk = SV.build_query_sketches(keys, vals, n=N)
    return dict(index=index, jsrv=jsrv, tsrv=tsrv, keys=keys, vals=vals,
                jsk=jsk, tsk=convert.sketches_from_reference(jsk, device="cpu"))


def _agree(want, got):
    ws, wi, wr, wm = (np.asarray(x) for x in want)
    gs, gi, gr, gm = got
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gr, wr, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(gm, wm)
    for q, p in zip(*np.nonzero(gi != wi)):
        row = ws[q]
        near = [abs(row[p] - row[j]) <= TOL for j in (p - 1, p + 1)
                if 0 <= j < row.shape[0]]
        assert any(near), (q, p, wi[q], gi[q], row)


# ----------------------------------------------------------------------------
# the containment twin
# ----------------------------------------------------------------------------

def _containment_inputs(rng, B, nq, n, C, universe):
    """Keys from a small universe, so sketches share keys and a key may
    repeat within one (the reference counts every equal valid pair)."""
    qk = rng.integers(0, universe, size=(B, nq)).astype(np.uint32)
    ck = rng.integers(0, universe, size=(C, n)).astype(np.uint32)
    qm = (rng.random((B, nq)) < 0.8).astype(np.float32)
    cm = (rng.random((C, n)) < 0.8).astype(np.float32)
    return qk, qm, ck, cm


def _torch_args(qk, qm, ck, cm, device="cpu"):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t(qk.view(np.int32)), t(qm), t(ck.view(np.int32)), t(cm)


@pytest.mark.parametrize("B,nq,n,C,universe", [(1, 64, 64, 8, 300),
                                               (3, 32, 48, 37, 100),
                                               (5, 40, 64, 256, 5000)])
def test_containment_twin_matches_reference(rng, B, nq, n, C, universe):
    """Twin == `ref.containment_hits_batched`, exactly."""
    inp = _containment_inputs(rng, B, nq, n, C, universe)
    got = ref.containment_hits_batched(*_torch_args(*inp))
    want = JR.containment_hits_batched(*(jnp.asarray(x) for x in inp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


@pytest.mark.parametrize("B,nq,n,C", [(4, 48, 40, 12), (3, 33, 30, 9)])
def test_containment_twin_repeats_and_extreme_keys(rng, B, nq, n, C):
    """Twin == `ref.containment_hits_batched`, exactly, with keys repeated
    inside query rows and inside candidates (a universe of 20 keys) and
    the keys 0 and 0xFFFFFFFF valid: every equal valid pair counts."""
    qk, qm, ck, cm = _containment_inputs(rng, B, nq, n, C, 20)
    qk[0, :5] = ck[0, :4] = 0xFFFFFFFF
    qk[1, :3] = ck[2, :3] = 0
    qm[0, :5] = cm[0, :4] = qm[1, :3] = cm[2, :3] = 1.0
    got = ref.containment_hits_batched(*_torch_args(qk, qm, ck, cm))
    want = JR.containment_hits_batched(*(jnp.asarray(x) for x in (qk, qm, ck, cm)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0] >= 20 and got[1, 2] >= 9


def test_containment_twin_matches_pallas_interpret(rng):
    """Twin == the Pallas kernel body (interpret mode), batched by vmap, at
    `tests/test_two_stage.py`'s shape."""
    inp = _containment_inputs(rng, 3, 64, 64, 8, 300)
    got = ref.containment_hits_batched(*_torch_args(*inp))
    want = JK.containment_hits_batched(*(jnp.asarray(x) for x in inp),
                                       KernelConfig(backend="interpret"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_containment_equals_sketch_join_m(world):
    """Stage-1 hits equal the sketch join's m for every (query, column)."""
    sh = world["tsrv"]["scan"].shard
    q_kh, q_val, q_mask, _, _ = TI.query_arrays(world["tsk"])
    hits = ops.containment_hits_batched(q_kh, q_mask, sh.key_hash, sh.mask)
    mom, _, _ = ops.sketch_join_moments_batched(
        q_kh, q_val, q_mask, sh.key_hash, sh.values, sh.mask,
        with_aligned=False)
    torch.testing.assert_close(hits, mom[..., 0], rtol=0, atol=0)


def test_containment_wrapper_refuses_cpu_tensors(rng):
    with pytest.raises(ValueError):
        TC.containment_hits_batched(
            *_torch_args(*_containment_inputs(rng, 1, 8, 8, 2, 50)))


# ----------------------------------------------------------------------------
# probe, survivors, rungs
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("cand", ["scan", "inverted"])
def test_stage1_hits_match_reference(world, cand):
    want = world["jsrv"][cand].stage1_hits(world["jsk"])
    got = world["tsrv"][cand].stage1_hits(world["tsk"])
    np.testing.assert_array_equal(got, want)
    assert (got >= 3).sum() < got.size // 2   # a real subset survives


@pytest.mark.parametrize("prune", ["safe", "topm"])
def test_select_survivors_and_rungs_match_reference(rng, prune):
    hits = rng.integers(0, 8, size=(5, 70)).astype(np.float32)
    for min_sample in (0, 3, 6):
        for prune_m in (1, 6, 100):
            np.testing.assert_array_equal(
                TPL.select_survivors(hits, prune, min_sample, prune_m),
                JPL.select_survivors(hits, prune, min_sample, prune_m))
    for n in (0, 1, 5, 63, 64, 65, 500):
        for base, C in ((64, 1024), (4, 64), (8, 100)):
            assert TPL.prune_rung(n, base, C) == JPL.prune_rung(n, base, C, 1)


def test_resolve_candidates_matches_reference():
    for c in TPL.CANDIDATE_CHOICES:
        for C in (1, TPL.AUTO_INVERTED_MIN_C - 1, TPL.AUTO_INVERTED_MIN_C):
            got = TPL.resolve_candidates(c, C)
            assert got == JPL.resolve_candidates(c, C)
            assert got in TCD.CANDIDATE_SOURCES
    with pytest.raises(ValueError):
        TPL.resolve_candidates("bogus", 10)
    assert TPL.ShapePolicy().prune_m == JPL.ShapePolicy().prune_m
    assert TPL.ShapePolicy().prune_base == JPL.ShapePolicy().prune_base
    assert TPL.ShapePolicy().candidates == JPL.ShapePolicy().candidates


# ----------------------------------------------------------------------------
# the port's Server against the JAX Server
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("est", TPL.ESTIMATORS)
@pytest.mark.parametrize("prune", ["safe", "topm"])
@pytest.mark.parametrize("cand", ["scan", "inverted"])
def test_server_matches_reference(world, cand, prune, est):
    for scorer in TPL.FAST_SCORERS:
        want = world["jsrv"][cand].query_batch(
            world["jsk"], request=JPL.Request(k=K_MAX, estimator=est,
                                              scorer=scorer, prune=prune))
        got = world["tsrv"][cand].query_batch(
            world["tsk"], request=TPL.Request(k=K_MAX, estimator=est,
                                              scorer=scorer, prune=prune))
        _agree(want, got)
        assert (got[1][:NQ - 1, 0] >= 0).all() and (got[1][NQ - 1] == -1).all()


@pytest.mark.parametrize("cand", ["scan", "inverted"])
def test_safe_equals_off(world, cand):
    """``safe`` never drops a top-k column: it equals the full scan."""
    srv = world["tsrv"][cand]
    for est in TPL.ESTIMATORS:
        for scorer in TPL.FAST_SCORERS:
            req = TPL.Request(k=K_MAX, estimator=est, scorer=scorer)
            _agree(srv.query_batch(world["tsk"], request=req),
                   srv.query_batch(world["tsk"], request=dataclasses.replace(
                       req, prune="safe")))
    stages = srv.throughput()["stages"]
    assert stages["stage2" if cand == "scan" else "fused"]["count"] > 0


def _carried_server(world, buckets=(4,), **policy):
    carried = convert.index_from_reference(
        world["index"].shard, world["index"].names, N, device="cpu")
    return TSV.Server(carried, TPL.ShapePolicy(**dict(POLICY, **policy)),
                      buckets=buckets, device="cpu")


def test_fused_rung_adaptation_single_steady_dispatch(world):
    """The first fused dispatch may overflow the base rung and retry at the
    covering rung; after that the same batch is one "fused" dispatch."""
    srv = _carried_server(world, candidates="inverted")
    assert len(srv.prune_rungs()) >= 2
    four = world["tsk"].map(lambda a: a[:4])
    req = TPL.Request(k=K_MAX, scorer="s2", prune="safe")
    srv.query_batch(four, request=req)
    n0 = {k: v["count"] for k, v in srv.throughput()["stages"].items()}
    assert n0["fused"] == 2    # the union of 4 rows overflows the base rung
    srv.query_batch(four, request=req)
    n1 = {k: v["count"] for k, v in srv.throughput()["stages"].items()}
    assert n1 == dict(n0, fused=n0["fused"] + 1)
    assert srv._fused_rung in srv.prune_rungs()


def test_ladder_overflow_falls_back_to_scan(world):
    """A union wider than every rung ends in the full scan: same results,
    counted as "scan". Eight queries, each half of two tables' keys, join
    all 64 columns."""
    srv = _carried_server(world, buckets=(8,), candidates="inverted")
    g = _groups(np.random.default_rng(12))
    wide = TSV.build_query_sketches(
        [np.concatenate([g[2 * j].keys[:150], g[2 * j + 1].keys[:150]])
         for j in range(8)],
        [np.ones(300, np.float32) * j for j in range(8)], n=N, device="cpu")
    req = TPL.Request(k=K_MAX, prune="safe")
    assert len(TPL.select_survivors(srv.stage1_hits(wide), "safe")) > \
        srv.prune_rungs()[-1]
    got = srv.query_batch(wide, request=req)
    stages = srv.throughput()["stages"]
    assert stages["scan"]["count"] == 1 and stages["fused"]["count"] == 1
    _agree(srv.query_batch(wide, request=dataclasses.replace(req,
                                                             prune="off")),
           got)


def test_fused_safe_off_gives_same_survivors(world):
    srv = world["tsrv"]["inverted"]
    req = TPL.Request(k=K_MAX, scorer="s4", estimator="spearman",
                      prune="safe")
    fused = srv.query_batch(world["tsk"], request=req)
    srv.fused_safe = False
    try:
        legacy = srv.query_batch(world["tsk"], request=req)
    finally:
        srv.fused_safe = True
    np.testing.assert_array_equal(fused[1], legacy[1])
    np.testing.assert_array_equal(fused[3], legacy[3])
    np.testing.assert_allclose(fused[0], legacy[0], rtol=2e-5, atol=2e-5)


def test_warmup_runs_every_mode_and_rung(world):
    srv = TSV.Server(convert.index_from_reference(
        world["index"].shard, world["index"].names, N, device="cpu"),
        TPL.ShapePolicy(candidates="inverted", **POLICY),
        request=TPL.Request(prune="safe"), buckets=(1, 4), device="cpu")
    srv.warmup()
    assert set(srv._bucket_cost) == {1, 4}
    assert srv.throughput()["stages"]["fused"]["count"] >= 2
    with pytest.raises(ValueError):
        srv.warmup(modes=("bogus",))
    with pytest.raises(ValueError):
        TSV.Server(convert.index_from_reference(
            world["index"].shard, world["index"].names, N, device="cpu"),
            request=TPL.Request(prune="bogus"), device="cpu")


# ----------------------------------------------------------------------------
# joinability
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("metric", TSV.JOIN_METRICS)
def test_search_joinable_matches_reference(world, metric):
    want = world["jsrv"]["scan"].search_joinable(world["keys"], k=8,
                                                 metric=metric)
    for cand in ("scan", "inverted"):
        got = world["tsrv"][cand].search_joinable(world["keys"], k=8,
                                                  metric=metric)
        np.testing.assert_array_equal(got.ids, want.ids)
        for f in TSV.JoinabilityResult._FIELDS[1:]:
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
    assert (got.ids[:NQ - 1, 0] // COLS == np.arange(NQ - 1)).all()
    with pytest.raises(ValueError):
        world["tsrv"]["scan"].search_joinable(world["keys"], metric="bogus")


def test_key_minima_and_estimators_match_reference(world, rng):
    jm = JI.key_minima(world["index"].shard)
    tm = world["tsrv"]["scan"].key_minima()
    np.testing.assert_array_equal(tm.count, jm.count)
    np.testing.assert_array_equal(tm.tau, jm.tau)
    c_hat = rng.random(50).astype(np.float32)
    probes = rng.integers(0, 40, size=50)
    for a, b in zip(TB.containment_ci(c_hat, probes, alpha=0.1),
                    JB.containment_ci(c_hat, probes, alpha=0.1)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-7, atol=1e-7)
    hits = world["jsrv"]["scan"].stage1_hits(world["jsk"])
    q_kh, q_mask = np.asarray(world["jsk"].key_hash), np.asarray(
        world["jsk"].mask)
    for i in range(NQ):
        qmin = TCT.query_minima(q_kh[i], q_mask[i])
        np.testing.assert_array_equal(
            qmin, JCT.query_minima(q_kh[i], q_mask[i]))
        got = TCT.joinability_estimates(hits[i], qmin, tm.count, tm.tau, N)
        want = JCT.joinability_estimates(hits[i], qmin, jm.count, jm.tau, N)
        for f in dataclasses.fields(want):
            np.testing.assert_allclose(getattr(got, f.name),
                                       getattr(want, f.name), rtol=1e-6)
