"""The port's scan plan against `repro.engine.plans` on the same index:
`_shard_stats` → `score_stats` → top-k for 4 estimators × 3 scorers, with
a candidate count that is not a multiple of ``score_chunk``. Tolerances are
tests/test_plans.py's: 5e-5 on r and scores; m exactly."""
import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.engine import index as JI
from repro.engine import plans as JPL
from repro.engine import serve as SV
from repro_torch import convert
from repro_torch.engine import plans as TPL

TOL = 5e-5
CHUNK = 16


@pytest.fixture(scope="module")
def setup():
    groups = [JP.multi_column_group(np.random.default_rng(10 + i), n_cols=7,
                                    n_max=1200, name=f"g{i}", keep_latent=True)
              for i in range(5)]
    index = JI.build_index(groups, n=64)       # C = 35 = 2·16 + 3
    rng = np.random.default_rng(3)
    keys = [g.keys[:500] for g in groups[:3]]
    vals = [g.meta["latent"][:500] + 0.5 * rng.normal(size=500).astype(np.float32)
            for g in groups[:3]]
    qa_j = SV.query_arrays(SV.build_query_sketches(keys, vals, n=64, chunk=256))
    shard_t = convert.index_from_reference(index.shard, index.names, 64,
                                           device="cpu").shard
    qa_t = (torch.from_numpy(np.array(qa_j[0]).view(np.int32)),
            *(torch.from_numpy(np.array(a)) for a in qa_j[1:]))
    stats = jax.jit(JPL._shard_stats, static_argnames=("shape", "est"))
    return dict(index=index, qa_j=qa_j, qa_t=qa_t, shard_t=shard_t,
                stats=stats)


def test_chunk_layout_matches_reference():
    for C, chunk in ((35, 16), (32, 16), (5, 16), (1, 1)):
        assert TPL._chunk_layout(C, chunk) == JPL._chunk_layout(C, chunk)


def test_request_operands_match_reference():
    for est in TPL.ESTIMATORS:
        for sc in TPL.FAST_SCORERS:
            req = dict(estimator=est, scorer=sc, alpha=0.1, min_sample=5)
            np.testing.assert_array_equal(
                TPL.request_operands(TPL.Request(**req)),
                JPL.request_operands(JPL.Request(**req)))
    with pytest.raises(ValueError):
        TPL.request_operands(TPL.Request(estimator="kendall"))
    with pytest.raises(ValueError):
        TPL.request_operands(TPL.Request(scorer="s3"))


@pytest.mark.parametrize("est", TPL.ESTIMATORS)
def test_scan_stages_match_reference(setup, est):
    jr, jm, jci = setup["stats"](*setup["qa_j"], setup["index"].shard,
                                 JPL.ShapePolicy(score_chunk=CHUNK), est, 0.05)
    tr, tm, tci = TPL._shard_stats(*setup["qa_t"], setup["shard_t"], CHUNK,
                                   est, 0.05)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.max() >= 20   # the planted columns joined
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=TOL, atol=TOL)
    fin = np.isfinite(np.asarray(jci))
    np.testing.assert_array_equal(np.isfinite(tci.numpy()), fin)
    np.testing.assert_allclose(tci.numpy()[fin], np.asarray(jci)[fin],
                               rtol=TOL, atol=TOL)
    for scorer in TPL.FAST_SCORERS:
        js = JPL.score_stats(jr, jm, jci, scorer, 3.0)
        ts = TPL.score_stats(tr, tm, tci, scorer, 3.0)
        np.testing.assert_array_equal(np.isfinite(ts.numpy()),
                                      np.isfinite(np.asarray(js)))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL,
                                   atol=TOL)
        # rank stage: the reference's top_k order on the same scores
        top_s, top_i = jax.lax.top_k(js, 10)
        s, ids, r, m = TPL.topk(torch.from_numpy(np.array(js)), tr, tm, 10)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(top_i))
        np.testing.assert_array_equal(s.numpy(), np.asarray(top_s))


def test_topk_breaks_ties_by_id():
    s = torch.tensor([[0.5, 0.9, 0.5, float("-inf"), 0.9, 0.1]])
    z = torch.zeros_like(s)
    _, ids, _, _ = TPL.topk(s, z, z, 5)
    assert ids.tolist() == [[1, 4, 0, 2, 5]]
