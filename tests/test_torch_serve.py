"""The slice as a whole: the port's `Server` against the JAX `Server` on a
small corpus, for 3 scorers × 4 estimators, once on the reference's index
carried over by `convert.index_from_reference` and once on the port's own
`build_index`.

Top-k ids must be equal, except at positions where the reference's score
lies within 5e-5 of a neighbour's (a near-tie that float order may flip);
r, m and scores agree within 5e-5 (tests/test_plans.py's tolerance).
"""
import jax
import numpy as np
import pytest

from repro.data import pipeline as JP
from repro.engine import index as JI
from repro.engine import plans as JPL
from repro.engine import serve as SV
from repro_torch import convert
from repro_torch.data import pipeline as TP
from repro_torch.engine import index as TI
from repro_torch.engine import plans as TPL
from repro_torch.engine import serve as TSV

TOL = 5e-5
BUCKETS = (1, 4)
NQ = 6          # greedy planning over (1, 4) pads the second bucket


def _corpus(pipeline):
    return [pipeline.multi_column_group(np.random.default_rng(20 + i),
                                        n_cols=6, n_rows=1000, name=f"g{i}",
                                        keep_latent=True) for i in range(6)]


@pytest.fixture(scope="module")
def servers():
    groups = _corpus(JP)
    index = JI.build_index(groups, n=64)
    mesh = jax.make_mesh((1,), ("shard",))
    policy = dict(k_max=10, score_chunk=16)
    jsrv = SV.Server(mesh, index, JPL.ShapePolicy(**policy), buckets=(4,))
    jsrv.warmup(modes=("off",))
    rng = np.random.default_rng(5)
    keys = [groups[i % 6].keys[:600] for i in range(NQ)]
    vals = [groups[i % 6].meta["latent"][:600]
            + 0.4 * rng.normal(size=600).astype(np.float32) for i in range(NQ)]
    carried = TSV.Server(
        convert.index_from_reference(index.shard, index.names, index.n,
                                     device="cpu"),
        TPL.ShapePolicy(**policy), buckets=BUCKETS, device="cpu")
    carried.warmup()
    own = TSV.Server(TI.build_index(_corpus(TP), n=64, device="cpu"),
                     TPL.ShapePolicy(**policy), buckets=BUCKETS, device="cpu")
    return dict(jsrv=jsrv, carried=carried, own=own, keys=keys, vals=vals)


def _agree(want, got):
    ws, wi, wr, wm = want
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


@pytest.mark.parametrize("est", TPL.ESTIMATORS)
def test_server_matches_reference(servers, est):
    jsk = SV.build_query_sketches(servers["keys"], servers["vals"], n=64)
    for scorer in TPL.FAST_SCORERS:
        want = servers["jsrv"].query_batch(
            jsk, request=JPL.Request(estimator=est, scorer=scorer))
        assert (want[1][:, 0] >= 0).all()
        req = TPL.Request(estimator=est, scorer=scorer)
        for name in ("carried", "own"):
            got = servers[name].query_columns(servers["keys"], servers["vals"],
                                              request=req)
            _agree(want, got)


def test_planted_column_ranks_first(servers):
    """Each query is a noisy copy of a group's latent: the top pearson/s4
    hit is a column of that group."""
    s, ids, r, m = servers["own"].query_columns(servers["keys"],
                                                servers["vals"])
    names = servers["own"].names
    for q in range(NQ):
        assert names[ids[q, 0]].startswith(f"g{q % 6}.")


def test_bucket_planning_and_padding(servers):
    """A warmed server plans by measured cost; an unwarmed one slices
    greedily and pads the last bucket with copies of the last query."""
    own = servers["own"]
    assert sum(own.plan_batches(NQ)) >= NQ
    cold = TSV.Server(TI.build_index(_corpus(TP)[:2], n=64, device="cpu"),
                      buckets=BUCKETS, device="cpu")
    assert cold.plan_batches(NQ) == [4, 4]
    out = cold.query_columns(servers["keys"], servers["vals"])
    assert out[1].shape == (NQ, 10)
    log = list(cold.dispatch_log)
    assert [(B, n) for B, n, _ in log] == [(4, 4), (4, 2)]
    tp = cold.throughput()
    assert tp["queries"] == NQ and tp["dispatches"] == 2 and tp["qps"] > 0
    with pytest.raises(ValueError):
        cold.query_columns(servers["keys"], servers["vals"],
                           request=TPL.Request(k=11))


def test_k_and_small_corpus(servers):
    """k below k_max slices; a corpus smaller than k_max still serves."""
    got = servers["own"].query_columns(servers["keys"][:2],
                                       servers["vals"][:2],
                                       request=TPL.Request(k=3))
    assert got[1].shape == (2, 3)
    tiny = TSV.Server(TI.build_index(_corpus(TP)[:1], n=64, device="cpu"),
                      buckets=BUCKETS, device="cpu")
    assert tiny.k_max == 6
    s, ids, _, _ = tiny.query_columns(servers["keys"][:1], servers["vals"][:1],
                                      request=TPL.Request(k=6))
    assert sorted(ids[0].tolist()) == list(range(6))
