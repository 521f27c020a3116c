"""The live index in the port: append / delete / compact / snapshot, the
segments' postings under mutation, and the segment-serving `Server`, each
held against the JAX package on the same seeded numpy inputs.

Planes, masks, postings, hit counts and m are compared exactly; so are the
segments' values (both packages add a key's values in row order). Top-k
ids must be equal except at near-ties (a neighbour's reference score
within 5e-5); r and scores agree within 5e-5 — `tests/test_torch_serve.py`'s
rule. During the delta phase s4 normalises over one segment's candidates,
so the port is compared with the JAX `Server` on the same live index there
(s1/s2 against a static server hold only across segments).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.sketch import Agg as JAgg
from repro.data import pipeline as JP
from repro.engine import index as JI
from repro.engine import ingest as JG
from repro.engine import lifecycle as JL
from repro.engine import plans as JPL
from repro.engine import serve as JSV
from repro_torch import convert
from repro_torch.core.sketch import Agg
from repro_torch.data import pipeline as TP
from repro_torch.engine import index as TI
from repro_torch.engine import ingest as TG
from repro_torch.engine import lifecycle as TL
from repro_torch.engine import plans as TPL
from repro_torch.engine import serve as TSV
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
N = 32          # sketch size: small keeps the 7-agg sweep quick
CHUNK = 512     # several chunks inside every table
TOL = 5e-5
K = 5
POLICY = dict(k_max=K, score_chunk=16, prune_base=4, prune_m=6)
SEG_FIELDS = ("kh", "acc", "cnt", "order", "mask", "cmin", "cmax", "rows",
              "live")


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


def _same_segments(jlive, tlive):
    """The two live indexes hold the same segments, bit for bit."""
    js, ts = jlive.segments(), tlive.segments()
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert (a.sid, a.capacity, a.used, a.sealed, a.names, a.tables) == \
            (b.sid, b.capacity, b.used, b.sealed, b.names, b.tables)
        for f in SEG_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f), err_msg=f)
    assert jlive.names() == tlive.names()
    assert jlive.stats() == tlive.stats()


def _both(make, *args, **kw):
    """The same tables as (JAX, port) objects."""
    return make(JP, *args, **kw), make(TP, *args, **kw)


def _messy_group(P, rng, name, n_cols=2, n_rows=1500):
    """Repeated keys + NaNs, so the seven aggregations differ."""
    n_distinct = n_rows // 3
    base = rng.choice(1 << 30, size=n_distinct, replace=False).astype(
        np.uint32)
    keys = base[rng.integers(0, n_distinct, size=n_rows)]
    vals = rng.normal(size=(n_cols, n_rows)).astype(np.float32)
    vals[:, rng.random(n_rows) < 0.02] = np.nan
    return P.TableGroup(keys=keys, values=vals, name=name,
                        column_names=[f"{name}.c{c}" for c in range(n_cols)])


@pytest.fixture(scope="module")
def messy():
    def make(P):
        rng = np.random.default_rng(42)
        return [_messy_group(P, rng, f"t{i}") for i in range(5)]
    return _both(make)


# ----------------------------------------------------------------------------
# lifecycle state
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("agg", list(Agg))
def test_append_compact_bit_identical_to_one_shot(messy, agg):
    """Three appends across seal boundaries, then a compaction, equal a
    one-shot build of the same tables (the port's and the JAX package's),
    every plane bit for bit, padding included."""
    jt, tt = messy
    live = TL.LiveIndex(n=N, agg=agg, chunk=CHUNK, delta_cap=4, device=CPU)
    live.append(tt[:2])
    live.append(tt[2:3])
    live.append(tt[3:])
    assert live.stats()["segments"] == 3
    base = live.compact()
    assert live.stats()["segments"] == 1 and base.sealed
    assert base.capacity == TL.ladder_rung(10, 4) == 16
    got = base.to_index_shard()
    one = TI.build_index(tt, n=N, agg=agg, chunk=CHUNK, pad_to=16, device=CPU)
    want = JI.build_index(jt, n=N, agg=JAgg(agg.value), chunk=CHUNK,
                          pad_to=16)
    for f in ("key_hash", "values", "mask", "col_min", "col_max", "rows"):
        assert torch.equal(getattr(got, f), getattr(one.shard, f)), f
        g = getattr(got, f).numpy()
        np.testing.assert_array_equal(
            g.view(np.uint32) if f == "key_hash" else g,
            np.asarray(getattr(want.shard, f)), err_msg=f)
    assert live.names() == one.names == want.names


def test_ladder_and_seal_boundaries():
    assert [TL.ladder_rung(c, 4) for c in (0, 1, 4, 5, 8, 9, 64)] == \
        [4, 4, 4, 8, 8, 16, 64]
    g = TP.multi_column_group(np.random.default_rng(3), n_cols=7,
                              n_rows=600, name="wide")
    live = TL.LiveIndex(n=N, chunk=CHUNK, delta_cap=4, device=CPU)
    live.append([g])
    st = live.stats()
    assert st["segments"] == 2 and st["live"] == 7
    assert live.segments()[0].sealed and not live.segments()[1].sealed
    assert live.names() == [f"wide.c{c}" for c in range(7)]
    with pytest.raises(ValueError):
        TL.LiveIndex(delta_cap=0, device=CPU)


def test_unnamed_tables_and_grow_corpus():
    """Unnamed tables take their lifetime source position as their id, and
    the growing-corpus generator (equal to the JAX one) streams into
    append with unique names."""
    rng = np.random.default_rng(9)
    cols = [TP.Table(keys=rng.integers(0, 1000, 300).astype(np.uint32),
                     values=rng.normal(size=300).astype(np.float32))
            for _ in range(2)]
    live = TL.LiveIndex(n=N, chunk=CHUNK, delta_cap=4, device=CPU)
    live.append(cols[:1])
    live.append(cols[1:])
    assert live.names() == ["col0", "col1"]
    assert live.delete("col0") == 1 and live.live_columns() == 1
    jb, tb = _both(lambda P: list(P.grow_corpus(
        np.random.default_rng(5), n_batches=3, tables_per_batch=2, n_cols=2,
        n_max=900)))
    grow = TL.LiveIndex(n=N, chunk=CHUNK, delta_cap=8, device=CPU)
    for a, b in zip(jb, tb):
        for x, y in zip(a, b):
            assert x.name == y.name and np.array_equal(x.keys, y.keys)
            np.testing.assert_array_equal(x.values, y.values)
        grow.append(b)
    assert grow.live_columns() == 12 and len(set(grow.names())) == 12


# ----------------------------------------------------------------------------
# postings under mutation
# ----------------------------------------------------------------------------

def _postings_pairs(p):
    """Sorted (key, column) pairs of a postings layout's live prefix."""
    keys = np.asarray(p.keys[:p.used]).astype(np.int64)
    cols = np.asarray(p.cols[:p.used]).astype(np.int64)
    return sorted(zip(keys.tolist(), cols.tolist()))


def test_segment_postings_track_writes_and_tombstones(messy):
    """After every write and tombstone a segment's postings equal
    `build_postings` of its planes exactly, and the JAX segment's
    incrementally kept postings as a (key → column) multiset."""
    jt, tt = messy
    jseg = JL.Segment.empty(0, 16, N, JAgg.MEAN)
    tseg = TL.Segment.empty(0, 16, N, Agg.MEAN)
    jseg.postings(), tseg.postings()
    steps = [("write", 0), ("write", 1), ("tomb", [1, 2]), ("write", 2),
             ("tomb", [5]), ("write", 3)]
    for op, arg in steps:
        if op == "write":
            t, j = tt[arg], jt[arg]
            tseg.write(TG.sketch_source(t, n=N, chunk=CHUNK, device=CPU),
                       [t.column_name(c) for c in range(2)], t.name)
            jseg.write(JG.sketch_source(j, n=N, agg=JAgg.MEAN, chunk=CHUNK),
                       [j.column_name(c) for c in range(2)], j.name)
        else:
            tseg.tombstone(arg)
            for s in arg:
                jseg.tombstone(s)
        got = tseg.postings()
        want = TI.build_postings(torch.from_numpy(tseg.kh.view(np.int32)),
                                 torch.from_numpy(tseg.mask), capacity=16)
        assert got.used == want.used and got.E == want.E == 16 * N
        assert torch.equal(got.keys, want.keys), (op, arg)
        assert torch.equal(got.cols, want.cols), (op, arg)
        jp = jseg.postings()
        assert _postings_pairs(got) == _postings_pairs(jp), (op, arg)
        np.testing.assert_array_equal(got.keys.numpy(),
                                      jp.keys.astype(np.int64))
    # the one-column forms, and a copy that mutations leave alone
    post = tseg.postings()
    copy = post.copy()
    post.remove_col(0)
    assert copy.used > post.used and not (post.cols[:post.used] == 0).any()
    post.insert_col(0, torch.from_numpy(tseg.kh[0].view(np.int32)),
                    torch.from_numpy(tseg.mask[0]))
    assert _postings_pairs(post) == _postings_pairs(copy)


# ----------------------------------------------------------------------------
# serving a live index: deletes, upserts, snapshots, the reference
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planted():
    """Four tables over one key universe, one of them holding a column
    planted to correlate with the query."""
    def make(P):
        rng = np.random.default_rng(7)
        groups = [P.multi_column_group(rng, n_cols=2, n_rows=2000,
                                       name=f"g{i}", key_space=4096,
                                       keep_latent=True) for i in range(4)]
        g = groups[1]
        latent = g.meta.pop("latent")
        groups[1] = P.TableGroup(keys=g.keys,
                                 values=np.stack([latent, g.values[1]]),
                                 name="planted",
                                 column_names=["planted.hit", "planted.other"])
        sel = rng.choice(len(latent), size=800, replace=False)
        return groups, (g.keys[sel], latent[sel])
    return _both(make)


def _server(live, **policy):
    return TSV.Server(live, TPL.ShapePolicy(**dict(POLICY, **policy)),
                      request=TPL.Request(k=4), buckets=(1, 2), device=CPU)


def test_deletes_and_upserts_are_excluded(planted):
    """A deleted table leaves every top-k, its stage-1 counts drop to 0 and
    joinability search skips it, before and after compaction; re-appending
    a table id tombstones its old columns."""
    _, (groups, (qk, qv)) = planted
    live = TL.LiveIndex(n=64, chunk=CHUNK, delta_cap=4, device=CPU)
    live.append(groups)
    srv = {c: _server(live, candidates=c) for c in ("scan", "inverted")}
    for s in srv.values():
        sc, g, _, _ = s.query_columns([qk], [qv])
        assert s.names[g[0, 0]] == "planted.hit" and sc[0, 0] > 0.5
    planted_ids = [i for i, nm in enumerate(live.names())
                   if nm.startswith("planted.")]
    assert live.delete("planted") == 2
    for c, s in srv.items():
        for req in (TPL.Request(k=4), TPL.Request(k=4, prune="safe"),
                    TPL.Request(k=4, prune="topm")):
            _, g, _, _ = s.query_columns([qk], [qv], request=req)
            names = [s.names[i] for i in g[0] if i >= 0]
            assert len(names) == 4, (c, req)
            assert not any(nm.startswith("planted.") for nm in names)
        hits = s.stage1_hits(TSV.build_query_sketches([qk], [qv], n=64,
                                                      device=CPU))
        assert hits.shape == (1, 8) and (hits[0, planted_ids] == 0).all()
        assert (np.delete(hits[0], planted_ids) > 0).all()
        join = s.search_joinable([qk], k=8)
        ids = join.ids[0][join.ids[0] >= 0]
        assert len(ids) == 6 and not set(ids) & set(planted_ids)
    live.compact()
    for s in srv.values():
        _, g, _, _ = s.query_columns([qk], [qv])
        assert not any(s.names[i].startswith("planted.") for i in g[0]
                       if i >= 0)
        assert s.throughput()["segments"] == 1
    assert live.live_columns() == 6
    live.append([groups[0]])
    st = live.stats()
    assert st["live"] == 6 and st["dead"] == 2 and st["segments"] == 2
    assert sum(nm.startswith("g0.") for nm in live.names()) == 4


def test_refresh_fast_path_and_telemetry(planted):
    """No mutation, no new view; a mutation republishes it. The segment
    count and the retired executors' dispatches stay in throughput(); k
    beyond the policy's k_max is refused, and rows pad to k when the
    segments hold fewer candidates."""
    _, (groups, (qk, qv)) = planted
    live = TL.LiveIndex(n=64, chunk=CHUNK, delta_cap=4, device=CPU)
    live.append(groups[:1])
    srv = _server(live)
    view = srv._view
    srv.refresh()
    assert srv._view is view
    out = srv.query_columns([qk], [qv], request=TPL.Request(k=5))
    assert out[1].shape == (1, 5) and (out[1][0, 2:] == -1).all()
    before = srv.throughput()
    assert before["queries"] == 1 and before["segments"] == 1
    live.append(groups[1:])
    srv.query_columns([qk], [qv])
    tp = srv.throughput()
    assert srv._view is not view and tp["segments"] == 2
    assert tp["queries"] == 2 and tp["dispatches"] >= before["dispatches"] + 2
    with pytest.raises(ValueError, match="k_max"):
        srv.query_columns([qk], [qv], request=TPL.Request(k=K + 1))
    srv.warmup(modes=("off",))
    assert set(srv._cap_costs) == {4, 8}


def test_snapshot_roundtrip_and_both_packages(planted, tmp_path):
    """save → load round-trips bit for bit and serves equal top-k; a port
    snapshot loads in the JAX package with equal arrays, and a JAX snapshot
    loads in the port and serves the JAX `Server`'s top-k."""
    (jg, (jqk, jqv)), (tg, (qk, qv)) = planted
    live = TL.LiveIndex(n=64, chunk=CHUNK, delta_cap=4, device=CPU)
    live.append(tg[:3])
    live.delete("g2")       # tombstones survive the round trip
    live.append(tg[3:])
    live.save(str(tmp_path / "port"))
    loaded = TL.LiveIndex.load(str(tmp_path / "port"), device=CPU)
    _same_segments(live, loaded)
    a = _server(live).query_columns([qk], [qv])
    b = _server(loaded).query_columns([qk], [qv])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    _same_segments(JL.LiveIndex.load(str(tmp_path / "port")), live)

    jlive = JL.LiveIndex(n=64, chunk=CHUNK, delta_cap=4)
    jlive.append(jg[:3])
    jlive.delete("g2")
    jlive.append(jg[3:])
    _same_segments(jlive, live)
    jlive.save(str(tmp_path / "jax"))
    from_jax = TL.LiveIndex.load(str(tmp_path / "jax"), device=CPU)
    _same_segments(jlive, from_jax)
    mesh = jax.make_mesh((1,), ("shard",))
    jsrv = JSV.Server(mesh, jlive, JPL.ShapePolicy(**POLICY),
                      request=JPL.Request(k=4), buckets=(1, 2))
    for sc in ("s1", "s2"):
        _agree(jsrv.query_columns([jqk], [jqv],
                                  request=JPL.Request(k=4, scorer=sc)),
               _server(from_jax).query_columns(
                   [qk], [qv], request=TPL.Request(k=4, scorer=sc)))
    # a loaded index finds a table's columns for a later delete
    assert loaded.delete("g3") == live.delete("g3") == 2
    _same_segments(live, loaded)


# ----------------------------------------------------------------------------
# the segment Server against the JAX Server on one mutation sequence
# ----------------------------------------------------------------------------

NQ = 4


@pytest.fixture(scope="module")
def world():
    """A growing corpus over one key universe through the same mutations in
    both packages: two appends, an upsert, a delete, a compaction. Queries
    are table columns cut to part of their rows, with noise."""
    jb, tb = _both(lambda P: list(P.grow_corpus(
        np.random.default_rng(11), n_batches=3, tables_per_batch=3,
        n_cols=4, n_max=1500, key_space=1 << 12)))
    rng = np.random.default_rng(12)
    src = [tb[0][0], tb[0][2], tb[1][1], tb[2][0]]
    keys, vals = [], []
    for t in src:
        m = int(rng.integers(200, 600))
        keys.append(t.keys[:m])
        vals.append(np.nan_to_num(t.values[1, :m])
                    + 0.3 * rng.standard_normal(m).astype(np.float32))
    jsk = JSV.build_query_sketches(keys, vals, n=N)
    mesh = jax.make_mesh((1,), ("shard",))
    jlive = JL.LiveIndex(n=N, chunk=CHUNK, delta_cap=6)
    tlive = TL.LiveIndex(n=N, chunk=CHUNK, delta_cap=6, device=CPU)
    jsrv = {c: JSV.Server(mesh, jlive, JPL.ShapePolicy(candidates=c,
                                                       **POLICY),
                          buckets=(4,)) for c in ("scan", "inverted")}
    tsrv = {c: TSV.Server(tlive, TPL.ShapePolicy(candidates=c, **POLICY),
                          buckets=(4,), device=CPU)
            for c in ("scan", "inverted")}
    return dict(jb=jb, tb=tb, jlive=jlive, tlive=tlive, jsrv=jsrv,
                tsrv=tsrv, jsk=jsk, keys=keys,
                tsk=convert.sketches_from_reference(jsk, device=CPU))


def _requests(scorers, prunes):
    return [dict(k=K, estimator=e, scorer=s, prune=p)
            for e in TPL.ESTIMATORS for s in scorers for p in prunes]


def _compare(world, reqs):
    for c in ("scan", "inverted"):
        for r in reqs:
            _agree(world["jsrv"][c].query_batch(world["jsk"],
                                                request=JPL.Request(**r)),
                   world["tsrv"][c].query_batch(world["tsk"],
                                                request=TPL.Request(**r)))
        np.testing.assert_array_equal(
            np.asarray(world["jsrv"][c].stage1_hits(world["jsk"])),
            world["tsrv"][c].stage1_hits(world["tsk"]))


def test_segment_server_matches_reference_through_mutations(world):
    """Delta phase (several segments, a table across a seal boundary):
    s1/s2 × 4 estimators through safe and topm on both candidate sources;
    then after an append mid-serving, an upsert and a delete; then, with
    one segment after compaction, all 12 requests through off and safe."""
    w = world
    w["jlive"].append(w["jb"][0])
    w["tlive"].append(w["tb"][0])
    _same_segments(w["jlive"], w["tlive"])
    assert w["tlive"].stats()["segments"] == 2
    _compare(w, _requests(("s1", "s2"), ("safe", "topm")))

    w["jlive"].append(w["jb"][1] + [w["jb"][0][1]])
    w["tlive"].append(w["tb"][1] + [w["tb"][0][1]])   # g1 upserted
    assert w["jlive"].delete("g4") == w["tlive"].delete("g4") == 4
    _same_segments(w["jlive"], w["tlive"])
    assert w["tlive"].stats()["dead"] == 8
    _compare(w, _requests(("s1", "s2"), ("safe", "topm")))
    for c in ("scan", "inverted"):
        got = w["tsrv"][c].search_joinable(w["keys"], k=8)
        want = w["jsrv"][c].search_joinable(w["keys"], k=8)
        np.testing.assert_array_equal(got.ids, want.ids)
        live = np.concatenate([s.live[:s.used]
                               for s in w["tlive"].segments()])
        assert (~live).sum() == 8
        assert not set(got.ids.ravel()) & set(np.nonzero(~live)[0])

    w["jlive"].compact()
    w["tlive"].compact()
    _same_segments(w["jlive"], w["tlive"])
    _compare(w, _requests(("s1", "s2", "s4"), ("off", "safe")))


def test_live_index_from_reference_serves_the_same(world):
    """A JAX live index carried into the port keeps its segments and
    counters and serves the JAX `Server`'s top-k."""
    w = world
    carried = convert.live_index_from_reference(w["jlive"], device=CPU)
    _same_segments(w["jlive"], carried)
    assert (carried._next_sid, carried._n_sources, carried.version) == \
        (w["jlive"]._next_sid, w["jlive"]._n_sources, w["jlive"].version)
    srv = TSV.Server(carried, TPL.ShapePolicy(candidates="inverted",
                                              **POLICY),
                     buckets=(4,), device=CPU)
    for r in _requests(("s2",), ("safe",)):
        _agree(w["jsrv"]["inverted"].query_batch(w["jsk"],
                                                 request=JPL.Request(**r)),
               srv.query_batch(w["tsk"], request=TPL.Request(**r)))
