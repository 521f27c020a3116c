"""Sharded serving and build on a device mesh (DESIGN.md §10), on the
reference's uneven corpus (C = 13 columns of ``sbn_pair`` tables, n = 32,
as tests/test_sharded_serving.py): padded to a multiple of the shard
count with fully masked columns, each shard scores its block, and the
shards' top-k strips combine in one total order (score descending, global
id ascending).

* the port's `Server` on a D ∈ {2, 8} CPU mesh equals its D = 1 server
  bit for bit — scores, ids, r and m — in both combines, for every scorer
  × estimator × prune mode × candidate source, with duplicated columns on
  different shards tied by global id; no pad id is ever returned;
* the port at D = 8 matches the reference's one-device `Server` at the
  slice tolerances (integers exact, floats within 5e-5, ids exact except
  at near-ties);
* the row-sharded builds match the reference's single-host builds (key
  sets exact, values within 1e-3, rows within 0.5);
* a live server on a D = 4 mesh equals the D = 1 live server through
  append, delete, compact and refresh;
* the serving drivers print the reference drivers' top ids, r values and
  recall lines on the same seed.

The ``gpu`` cases repeat the bit-identity and the builds on the card's
mesh (four shards, round-robin over the visible cards). The JAX side is
imported inside the tests that use it, so the file collects without JAX.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import build_sketch, hashing
from repro_torch.core.sketch import PAD_KEY
from repro_torch.data import pipeline as TP
from repro_torch.engine import index as TI
from repro_torch.engine import ingest as TG
from repro_torch.engine import lifecycle as TL
from repro_torch.engine import plans as PL
from repro_torch.engine import serve as SV
from repro_torch.launch.mesh import make_host_mesh
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_ROOT = os.path.join(os.path.dirname(__file__), "..")
C, N = 13, 32
TOL = 5e-5
BUCKETS = (1, 2)
COMBOS = [(sc, est, pm) for sc in PL.FAST_SCORERS for est in PL.ESTIMATORS
          for pm in PL.PRUNE_MODES]


def _tables(seed: int = 3):
    """The reference's uneven corpus and its 3 query columns."""
    rng = np.random.default_rng(seed)
    tables, queries = [], []
    for i in range(C):
        tx, ty, _, _ = TP.sbn_pair(rng, n_max=700)
        tables.append(TP.Table(keys=ty.keys, values=ty.values, name=f"t{i}"))
        if len(queries) < 3:
            queries.append(tx)
    return tables, queries


def _shape(source: str = "scan", **kw):
    # prune_base ≥ D and prune_m ≥ C, the reference's contract
    return PL.ShapePolicy(**{**dict(k_max=4, prune_base=8, prune_m=32,
                                    score_chunk=512, candidates=source), **kw})


@pytest.fixture(scope="module")
def world():
    tables, queries = _tables()
    index = TI.build_index(tables, n=N, device="cpu")
    sks = SV.build_query_sketches([q.keys for q in queries],
                                  [q.values for q in queries], n=N,
                                  device="cpu")
    return dict(tables=tables, queries=queries, index=index, sks=sks)


def _server(index, D, source="scan", dev="cpu", **kw):
    srv = SV.Server(index, _shape(source, **kw), buckets=BUCKETS,
                    mesh=make_host_mesh(D, device=dev))
    srv.warmup()
    return srv


def _sweep(srv_a, srv_b, sks, combos, k=4):
    """Every combination's four outputs, bit for bit."""
    bad = []
    for sc, est, pm in combos:
        req = PL.Request(k=k, scorer=sc, estimator=est, prune=pm)
        want = srv_a.query_batch(sks, request=req)
        got = srv_b.query_batch(sks, request=req)
        for name, a, b in zip("sgrm", want, got):
            if not np.array_equal(a, b):
                bad.append((sc, est, pm, name, a, b))
        assert got[1].max() < C, f"pad column id returned: {got[1]}"
    return bad


# ----------------------------------------------------------------------------
# (a) placement
# ----------------------------------------------------------------------------

def test_place_shard_pads_with_masked_columns(world):
    mesh = make_host_mesh(8, device="cpu")
    ms = TI.shard_for_mesh(world["index"], mesh)
    assert (ms.num_columns, ms.width, len(ms.blocks)) == (16, 2, 8)
    assert [ms.offset(d) for d in range(8)] == list(range(0, 16, 2))
    whole = ms.on("cpu")
    assert torch.equal(whole.key_hash[:C], world["index"].shard.key_hash)
    pad = whole.columns(C, 16)
    assert bool((pad.key_hash == TI.PAD_PATTERN).all())
    assert int(hashing.from_pattern(pad.key_hash)[0, 0]) == PAD_KEY
    for plane in (pad.mask, pad.rows, pad.col_min, pad.col_max, pad.values):
        assert not bool(plane.any())
    # the padded count depends on (C, D) alone
    assert TI.place_shard(world["index"].shard, mesh[:3]).num_columns == 15
    # pad columns are never eligible: a k over every column ends in −1 ids
    srv = SV.Server(world["index"], PL.ShapePolicy(k_max=16), buckets=(4,),
                    mesh=mesh)
    s, g, _, _ = srv.query_batch(world["sks"], request=PL.Request(
        k=16, scorer="s1", min_sample=0))
    assert g.max() < C and (g[np.isinf(s)] == -1).all()


def test_shape_resolution_and_mesh_errors():
    one, eight = make_host_mesh(device="cpu"), make_host_mesh(8, device="cpu")
    assert PL.resolve_shape(PL.ShapePolicy(), one).combine == "gather"
    r8 = PL.resolve_shape(PL.ShapePolicy(candidates="auto"), eight,
                          num_columns=16)
    assert (r8.combine, r8.mesh_shards, r8.candidates) == ("host", 8, "scan")
    assert PL.resolve_shape(PL.ShapePolicy(candidates="auto"),
                            eight).candidates == "auto"
    with pytest.raises(ValueError):
        PL.resolve_shape(PL.ShapePolicy(mesh_shards=2), eight)
    with pytest.raises(ValueError):
        PL.resolve_shape(PL.ShapePolicy(combine="tree"), eight)
    with pytest.raises(ValueError):
        SV.Server(None, mesh=eight, device="cpu")
    assert PL.prune_rung(5, 8, 16, 8) == 8 and PL.prune_rung(9, 8, 16, 8) is None
    assert PL.prune_rung(9, 6, 64, 4) == 12


# ----------------------------------------------------------------------------
# (b) D ∈ {2, 8} == D = 1, bit for bit
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_device(world):
    return {src: _server(world["index"], 1, src)
            for src in ("scan", "inverted")}


@pytest.mark.parametrize("combine", ["gather", "host"])
@pytest.mark.parametrize("source", ["scan", "inverted"])
@pytest.mark.parametrize("D", [2, 8])
def test_sharded_server_bit_identical(world, one_device, D, source, combine):
    srv = _server(world["index"], D, source, combine=combine)
    assert srv.shape.mesh_shards == D and srv.shape.combine == combine
    assert srv.C == C + (-C) % D
    bad = _sweep(one_device[source], srv, world["sks"], COMBOS)
    for sc, est, pm, name, a, b in bad:
        print(f"MISMATCH {sc}/{est}/{pm} [{name}]\n D=1: {a}\n D={D}: {b}")
    assert not bad, f"{len(bad)} mismatches against D = 1"
    if source == "inverted":
        assert srv.throughput()["stages"]["fused"]["count"] > 0


@pytest.mark.parametrize("D", [1, 2, 8])
def test_cross_shard_ties_go_to_the_global_id(world, D):
    """t0 copied to 2, 7 and 11 (different shards at D = 8): querying t0's
    own column ties all four at the top score."""
    tables = list(world["tables"])
    for pos in (2, 7, 11):
        tables[pos] = TP.Table(keys=tables[0].keys, values=tables[0].values,
                               name=f"dup{pos}")
    index = TI.build_index(tables, n=N, device="cpu")
    qsk = SV.build_query_sketches([tables[0].keys], [tables[0].values], n=N,
                                  device="cpu")
    for combine in ("gather", "host"):
        srv = _server(index, D, combine=combine)
        for pm in PL.PRUNE_MODES:
            s, g, _, _ = srv.query_batch(qsk, request=PL.Request(k=4, prune=pm))
            assert g[0].tolist() == [0, 2, 7, 11], (combine, pm, g[0])
            assert len(set(s[0].tolist())) == 1, s[0]


# ----------------------------------------------------------------------------
# (c) D = 8 against the reference's one-device Server
# ----------------------------------------------------------------------------

def _agree(want, got):
    ws, wi, wr, wm = (np.asarray(x) for x in want)
    gs, gi, gr, gm = got
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gr[fin], wr[fin], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(gm[fin], wm[fin])
    for q, p in zip(*np.nonzero(gi != wi)):
        row = ws[q]
        near = [abs(row[p] - row[j]) <= TOL for j in (p - 1, p + 1)
                if 0 <= j < row.shape[0]]
        assert any(near), (q, p, wi[q], gi[q], row)


@pytest.mark.parametrize("source", ["scan", "inverted"])
def test_sharded_server_matches_reference(world, source):
    jax = pytest.importorskip("jax")
    from repro.data import pipeline as JP
    from repro.engine import index as JI
    from repro.engine import plans as JPL
    from repro.engine import serve as JSV
    jtables = [JP.Table(keys=t.keys, values=t.values, name=t.name)
               for t in world["tables"]]
    mesh = jax.make_mesh((1,), ("shard",), devices=jax.devices()[:1])
    jsrv = JSV.Server(mesh, JI.build_index(jtables, n=N),
                      JPL.ShapePolicy(k_max=4, prune_base=8, prune_m=32,
                                      score_chunk=512, candidates=source),
                      buckets=BUCKETS)
    jsk = JSV.build_query_sketches([q.keys for q in world["queries"]],
                                   [q.values for q in world["queries"]], n=N)
    srv = _server(world["index"], 8, source)
    for sc, est, pm in COMBOS:
        want = jsrv.query_batch(jsk, request=JPL.Request(
            k=4, scorer=sc, estimator=est, prune=pm))
        got = srv.query_batch(world["sks"], request=PL.Request(
            k=4, scorer=sc, estimator=est, prune=pm))
        _agree(want, got)


# ----------------------------------------------------------------------------
# (d) row-sharded builds against the reference's single-host builds
# ----------------------------------------------------------------------------

def _key_values(kh, vals, mask):
    mask = np.asarray(mask, bool)
    return dict(zip(np.asarray(kh)[mask].tolist(),
                    np.asarray(vals)[mask].tolist()))


def _same_sketch(got, want, rows=None):
    g, w = _key_values(*got), _key_values(*want)
    assert g.keys() == w.keys()
    for k in w:
        assert abs(g[k] - w[k]) < 1e-3, (k, g[k], w[k])
    if rows is not None:
        assert abs(rows[0] - rows[1]) < 0.5, rows


def _planes(sk, c=None):
    """(key hashes, values, mask) of a sketch, or of column ``c`` of a
    stacked one, as numpy."""
    take = lambda t: (t if c is None else t[c]).cpu().numpy()
    return take(sk.key_hash), take(sk.values()), take(sk.mask)


def _build_inputs():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 2500, size=4096).astype(np.uint32)
    vals = rng.normal(size=(3, 4096)).astype(np.float32)
    return keys, vals


def test_distributed_build_table_matches_reference():
    pytest.importorskip("jax")
    from repro.engine.ingest import sketch_table as jsketch_table
    keys, vals = _build_inputs()
    got = TG.distributed_build_table(keys, vals, make_host_mesh(8, "cpu"),
                                     n=64)
    want = jsketch_table(keys, vals, n=64)
    for c in range(vals.shape[0]):
        _same_sketch(_planes(got, c),
                     (np.asarray(want.key_hash)[c], np.asarray(want.values())[c],
                      np.asarray(want.mask)[c]),
                     rows=(float(got.rows[c]), float(want.rows[c])))


def test_distributed_build_matches_reference():
    jax = pytest.importorskip("jax")
    from repro.core.sketch import build_sketch as jbuild
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 3000, size=4096).astype(np.uint32)
    vals = rng.normal(size=4096).astype(np.float32)
    got = TI.distributed_build(keys, vals, make_host_mesh(8, "cpu"), n=64)
    want = jbuild(jax.numpy.asarray(keys), jax.numpy.asarray(vals), n=64)
    _same_sketch(_planes(got), (np.asarray(want.key_hash),
                                np.asarray(want.values()),
                                np.asarray(want.mask)),
                 rows=(float(got.rows), float(want.rows)))


def test_distributed_builds_check_their_inputs():
    keys, vals = _build_inputs()
    with pytest.raises(ValueError):
        TG.distributed_build_table(keys[:-1], vals[:, :-1],
                                   make_host_mesh(8, "cpu"), n=64)
    # one shard is the fused build itself, bit for bit
    a = TG.distributed_build_table(keys, vals, make_host_mesh(1, "cpu"), n=64)
    b = TG.sketch_table(keys, vals, n=64, device="cpu")
    for f in ("key_hash", "acc", "cnt", "order", "mask", "rows"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ----------------------------------------------------------------------------
# (e) a live server on a D = 4 mesh
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["scan", "inverted"])
def test_live_server_on_a_mesh_equals_one_device(source):
    rng = np.random.default_rng(11)
    groups = [TP.multi_column_group(rng, n_cols=3, n_max=900, name=f"g{i}",
                                    keep_latent=True) for i in range(9)]
    live = TL.LiveIndex(n=N, delta_cap=8, device="cpu")
    live.append(groups[:5])
    shape = _shape(source, k_max=5)
    srvs = [SV.Server(live, shape, buckets=BUCKETS,
                      mesh=make_host_mesh(D, device="cpu")) for D in (1, 4)]
    for srv in srvs:
        srv.warmup(include_ladder=True)
    sks = SV.build_query_sketches(
        [g.keys[:500] for g in groups], [g.meta["latent"][:500] for g in groups],
        n=N, device="cpu")
    reqs = [PL.Request(k=5, scorer=sc, prune=pm) for sc in PL.FAST_SCORERS
            for pm in PL.PRUNE_MODES] + [PL.Request(k=5, estimator="qn")]

    def check(step):
        for srv in srvs:
            srv.refresh()
        assert srvs[0].names == srvs[1].names
        for req in reqs:
            want, got = (srv.query_batch(sks, request=req) for srv in srvs)
            for name, a, b in zip("sgrm", want, got):
                assert np.array_equal(a, b), (step, req, name, a, b)
        assert np.array_equal(*(srv.stage1_hits(sks) for srv in srvs)), step
        jw, jg = (srv.search_joinable_sketches(sks, k=5) for srv in srvs)
        assert np.array_equal(jw.ids, jg.ids), step

    check("first append")
    live.append(groups[5:])
    check("append")
    live.delete("g1")
    check("delete")
    live.compact()
    check("compact")
    assert srvs[1]._view[0].exec.shard.num_columns % 4 == 0


# ----------------------------------------------------------------------------
# (g) the serving drivers against the reference's
# ----------------------------------------------------------------------------

_SERVE_ARGS = ["--tables", "24", "--queries", "6", "--sketch-size", "64",
               "--rows-max", "2000", "--k", "5"]


def test_launch_serve_prints_the_reference_results(capsys, monkeypatch):
    pytest.importorskip("jax")
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    monkeypatch.setattr(sys, "argv", ["serve"] + _SERVE_ARGS)
    jserve.main()
    ref = capsys.readouterr().out
    tserve.main(_SERVE_ARGS + ["--device", "cpu"])
    got = capsys.readouterr().out
    first = lambda out: re.search(r"top ids (\[.*?\]) r (\[.*?\])",
                                  out.replace("\n", " "))
    assert first(got).group(1) == first(ref).group(1)
    np.testing.assert_allclose(
        np.array(first(got).group(2)[1:-1].split(), float),
        np.array(first(ref).group(2)[1:-1].split(), float), atol=1e-3)
    assert got.splitlines()[0] == ref.splitlines()[0]
    tserve.main(_SERVE_ARGS + ["--batch", "4", "--device", "cpu"])
    assert "batched serving (B≤4): 6 queries in" in capsys.readouterr().out


def test_launch_serve_needs_a_device_without_cuda(monkeypatch):
    from repro_torch.launch import serve as tserve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(_SERVE_ARGS)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    assert make_host_mesh(3, device="cpu") == (torch.device("cpu"),) * 3


_QUERIES_ARGS = ["--groups", "12", "--extra", "3", "--cols", "4",
                 "--queries", "8", "--sketch-size", "64", "--delta-cap",
                 "16", "--buckets", "1", "4"]


def test_serve_queries_prints_the_reference_recall(capsys):
    from repro_torch import serve_queries
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, os.path.join(
        _ROOT, "examples", "serve_queries.py"), *_QUERIES_ARGS], env=env,
        capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    serve_queries.main(_QUERIES_ARGS + ["--device", "cpu"])
    got = capsys.readouterr().out
    recall = lambda out: re.findall(r"recall@\d+[^:]*: \d+/\d+ \(MRR [\d.]+\)",
                                    out)
    assert len(recall(ref.stdout)) == 3
    assert recall(got) == recall(ref.stdout)
    for tag in ("zero new compiles", "(zero recompiles)",
                "excluded from every top-k"):
        assert tag in got and tag in ref.stdout


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["scan", "inverted"])
def test_cuda_mesh_server_bit_identical(cuda, source):
    tables, queries = _tables()
    index = TI.build_index(tables, n=N, device=cuda)
    sks = SV.build_query_sketches([q.keys for q in queries],
                                  [q.values for q in queries], n=N,
                                  device=cuda)
    one = _server(index, 1, source, dev="cuda")
    for combine in ("gather", "host"):
        bad = _sweep(one, _server(index, 4, source, dev="cuda",
                                  combine=combine), sks, COMBOS)
        assert not bad, bad[:3]


@pytest.mark.gpu
def test_cuda_mesh_builds_match_the_cpu(cuda):
    keys, vals = _build_inputs()
    got = TG.distributed_build_table(keys, vals, make_host_mesh(4), n=64)
    want = TG.sketch_table(keys, vals, n=64, device="cpu")
    for c in range(vals.shape[0]):
        _same_sketch(_planes(got, c), _planes(want, c),
                     rows=(float(got.rows[c]), float(want.rows[c])))
    k1 = keys[:4096]
    got = TI.distributed_build(k1, vals[0], make_host_mesh(4), n=64)
    want = build_sketch(hashing.keys_tensor(k1), torch.from_numpy(vals[0]),
                        n=64)
    _same_sketch(_planes(got), _planes(want),
                 rows=(float(got.rows), float(want.rows)))
