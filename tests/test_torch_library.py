"""The paper library of the port (`repro_torch.core`: sketch join,
estimators, Hoeffding CI, scorers, top-k query, and the quickstart) against
the JAX package's `repro.core` on the CPU.

Inputs are seeded numpy; sketches are built by the reference and carried
over with `convert.sketches_from_reference`, so both sides see the same
sketches. Tolerances: ranks, join pairs, m, U(k), k and K_∩ exact;
estimators 1e-5; join-size and Jaccard estimates 1e-6 relative; Hoeffding
bounds 1e-5 relative; top-k ids equal except at near-ties (a neighbour's
reference score within 5e-5), r and scores within 5e-5, m exact — the
serving tests' rule. The PM1 bootstrap draws its resamples differently
from JAX's PRNG, so it is held to interval coverage, and the s3 ranking to
the golden corpus's floors.
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as JB
from repro.core import build_sketch as jbuild
from repro.core import estimators as JE
from repro.core import scoring as JSC
from repro.core import sketch_join as jjoin
from repro.core import stack_sketches as jstack
from repro.core import topk_query as jtopk
from repro_torch import convert
from repro_torch.core import bounds as B
from repro_torch.core import estimators as E
from repro_torch.core import join as J
from repro_torch.core import ranking as RK
from repro_torch.core import scoring as SC
from repro_torch import quickstart

import test_ranking_golden as G

TOL = 5e-5
_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _samples(rng, R=9, n=64):
    """Join-sample rows: ties, random masks, an all-masked row, a
    one-survivor row, a constant row and NaN-free values."""
    a = (np.round(rng.normal(size=(R, n)) * 2) / 2).astype(np.float32)
    b = (0.6 * a + rng.normal(size=(R, n))).astype(np.float32)
    mask = rng.random((R, n)) < 0.75
    mask[0] = False
    mask[1] = False
    mask[1, 3] = True
    a[2] = 1.5
    return a, b, mask


# ----------------------------------------------------------------------------
# estimators
# ----------------------------------------------------------------------------

def test_average_ranks_exact(rng):
    a, _, mask = _samples(rng)
    a[3, :4] = np.nan
    got = E.average_ranks(_t(a), _t(mask)).numpy()
    want = np.asarray(JE.average_ranks(jnp.asarray(a), jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["pearson", "spearman", "rin", "qn"])
def test_estimators_match_reference(rng, name):
    a, b, mask = _samples(rng)
    got = E.ESTIMATORS[name](_t(a), _t(b), _t(mask)).numpy()
    want = np.asarray(JE.ESTIMATORS[name](jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[0] == 0 and got[1] == 0    # m < 2: undefined → 0


def test_estimators_batch_over_leading_axes(rng):
    a, b, mask = _samples(rng, R=12, n=32)
    for name, est in E.ESTIMATORS.items():
        flat = est(_t(a), _t(b), _t(mask))
        lead = est(*(_t(x).reshape(3, 4, 32) for x in (a, b, mask)))
        assert lead.shape == (3, 4)
        torch.testing.assert_close(lead.reshape(12), flat, rtol=0, atol=0)


def test_pm1_bootstrap_coverage(rng):
    """Over 200 samples of m = 80 from a bivariate normal with ρ = 0.5,
    the port's PM1 interval covers ρ about as often as the reference's
    (both near the nominal 95 %), and r_b is near ρ on average."""
    S, n, m, rho = 200, 128, 80, 0.5
    xy = rng.multivariate_normal([0, 0], [[1, rho], [rho, 1]], size=(S, m))
    a = np.zeros((S, n), np.float32)
    b = np.zeros((S, n), np.float32)
    a[:, :m], b[:, :m] = xy[..., 0], xy[..., 1]
    mask = np.zeros((S, n), bool)
    mask[:, :m] = True
    gen = torch.Generator().manual_seed(7)
    rb, lo, hi = E.pm1_bootstrap(_t(a), _t(b), _t(mask), gen)
    cover = float(((lo <= rho) & (rho <= hi)).double().mean())
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    jrb, jlo, jhi = jax.vmap(JE.pm1_bootstrap)(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), keys)
    jcover = float(np.mean((np.asarray(jlo) <= rho) & (rho <= np.asarray(jhi))))
    assert 0.88 <= cover <= 1.0 and 0.88 <= jcover <= 1.0, (cover, jcover)
    assert abs(cover - jcover) <= 0.08, (cover, jcover)
    assert abs(float(rb.mean()) - rho) < 0.05
    assert bool((lo <= hi).all())
    # m < 3: (0, −1, 1)
    few = E.pm1_bootstrap(_t(a[:2]), _t(b[:2]), _t(np.arange(n) < 2)[None]
                          .expand(2, n), gen)
    assert [float(x[0]) for x in few] == [0.0, -1.0, 1.0]


def test_pm1_bootstrap_independent_of_batching(rng):
    """A sample's resamples depend on its own stream key alone: a batch
    equals its rows run one by one."""
    a, b, mask = _samples(rng, R=6, n=48)
    keys = E.bootstrap_keys((6,), torch.Generator().manual_seed(3))
    whole = E.pm1_from_keys(_t(a), _t(b), _t(mask), keys)
    for i in range(6):
        one = E.pm1_from_keys(_t(a[i:i + 1]), _t(b[i:i + 1]),
                              _t(mask[i:i + 1]), keys[i:i + 1])
        for w, o in zip(whole, one):
            assert float(w[i]) == float(o[0])


# ----------------------------------------------------------------------------
# sketch join (the corpora of tests/test_theorem1.py)
# ----------------------------------------------------------------------------

def _theorem1_pair(seed, n, overlap):
    r = np.random.default_rng(seed)
    nx = int(r.integers(64, 2000))
    universe = r.choice(1 << 28, size=2 * nx, replace=False).astype(np.uint32)
    kx = universe[:nx]
    m_ov = max(1, int(nx * overlap))
    ky = np.concatenate([r.choice(kx, size=m_ov, replace=False),
                         universe[nx: nx + int(r.integers(1, nx))]])
    vx = r.normal(size=len(kx)).astype(np.float32)
    vy = r.normal(size=len(ky)).astype(np.float32)
    return (jbuild(jnp.asarray(kx), jnp.asarray(vx), n=n),
            jbuild(jnp.asarray(ky), jnp.asarray(vy), n=n))


def _join_pair(rng):
    nx = 30000
    universe = rng.choice(1 << 30, size=2 * nx, replace=False).astype(np.uint32)
    kx = universe[:nx]
    ky = np.concatenate([kx[: nx // 2], universe[nx: nx + nx // 2]])
    return (jbuild(jnp.asarray(kx), jnp.asarray(
                rng.normal(size=nx).astype(np.float32)), n=512),
            jbuild(jnp.asarray(ky), jnp.asarray(
                rng.normal(size=len(ky)).astype(np.float32)), n=512))


_JOIN_FIELDS = ("a", "b", "mask", "m", "union_kth", "union_k", "inter_k",
                "c_low", "c_high")


def _check_join(jsj, tsj):
    for f in _JOIN_FIELDS:
        np.testing.assert_array_equal(getattr(tsj, f).numpy(),
                                      np.asarray(getattr(jsj, f)), err_msg=f)
    np.testing.assert_allclose(tsj.join_size_estimate().numpy(),
                               np.asarray(jsj.join_size_estimate()), rtol=1e-6)
    np.testing.assert_allclose(tsj.jaccard_estimate().numpy(),
                               np.asarray(jsj.jaccard_estimate()), rtol=1e-6)


@pytest.mark.parametrize("seed,n,overlap", [
    (0, 16, 0.05), (1, 64, 0.5), (2, 128, 1.0), (3, 64, 0.2), (4, 128, 0.7),
    (5, 16, 0.9)])
def test_sketch_join_matches_reference(seed, n, overlap):
    sx, sy = _theorem1_pair(seed, n, overlap)
    tx = convert.sketches_from_reference(sx, device="cpu")
    ty = convert.sketches_from_reference(sy, device="cpu")
    _check_join(jjoin(sx, sy), J.sketch_join(tx, ty))


def test_sketch_join_batched_and_unequal_sizes(rng):
    """One query against a stack of candidates equals each pair alone,
    with the candidates at a larger sketch size than the query (the join
    pads to the common n)."""
    sx, _ = _theorem1_pair(11, 32, 0.5)
    ys = [_theorem1_pair(12 + i, 64, 0.5)[1] for i in range(3)]
    tx = convert.sketches_from_reference(sx, device="cpu")
    ty = convert.sketches_from_reference(jstack(ys), device="cpu")
    tsj = J.sketch_join(tx, ty)
    for i, y in enumerate(ys):
        one = J.SketchJoin(**{f: getattr(tsj, f)[i] for f in _JOIN_FIELDS})
        _check_join(jjoin(sx, y), one)


def test_join_size_and_jaccard_estimates(rng):
    sx, sy = _join_pair(rng)
    tx, ty = (convert.sketches_from_reference(s, device="cpu") for s in (sx, sy))
    tsj = J.sketch_join(tx, ty)
    _check_join(jjoin(sx, sy), tsj)
    assert abs(float(tsj.join_size_estimate()) - 15000) / 15000 < 0.3


# ----------------------------------------------------------------------------
# Hoeffding CI and scorers
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("alpha,hfd", [(0.05, True), (0.2, True), (0.05, False)])
def test_hoeffding_ci_matches_reference(rng, alpha, hfd):
    a, b, mask = _samples(rng, R=10, n=64)
    lo_c = np.minimum(a.min(-1), b.min(-1)) - rng.uniform(0, 1, 10).astype(np.float32)
    hi_c = np.maximum(a.max(-1), b.max(-1)) + rng.uniform(0, 1, 10).astype(np.float32)
    got = B.hoeffding_ci(_t(a), _t(b), _t(mask), _t(lo_c), _t(hi_c),
                         alpha=alpha, hfd=hfd)
    want = JB.hoeffding_ci(*(jnp.asarray(x) for x in (a, b, mask, lo_c, hi_c)),
                           alpha=alpha, hfd=hfd)
    np.testing.assert_allclose(got.lo.numpy(), np.asarray(want.lo), rtol=1e-5)
    np.testing.assert_allclose(got.hi.numpy(), np.asarray(want.hi), rtol=1e-5)
    np.testing.assert_allclose(got.length().numpy(), np.asarray(want.length()),
                               rtol=1e-5)
    assert float(got.lo[0]) == float(-np.float32(3.4e38))   # m < 2
    assert B.sample_size_for_accuracy(2.0, 0.5, 0.1) == \
        JB.sample_size_for_accuracy(2.0, 0.5, 0.1)


@pytest.mark.parametrize("scorer", SC.SCORERS)
def test_score_matches_reference(rng, scorer):
    C = 16
    f = lambda *s: rng.uniform(-1, 1, size=s).astype(np.float32)
    r_p, r_b = f(C), f(C)
    lo = f(C) - 2.0
    hi = lo + rng.uniform(0.1, 30, C).astype(np.float32)
    blo = -np.abs(f(C))
    bhi = np.abs(f(C))
    m = rng.integers(0, 60, C).astype(np.int32)
    elig = m >= 3
    stats = SC.CandidateStats(r_p=_t(r_p), m=_t(m), ci_lo=_t(lo), ci_hi=_t(hi),
                              r_b=_t(r_b), ci_b_lo=_t(blo), ci_b_hi=_t(bhi))
    jstats = JSC.CandidateStats(*(jnp.asarray(x) for x in
                                  (r_p, m, lo, hi, r_b, blo, bhi)))
    got = SC.score(stats, scorer, eligible=_t(elig)).numpy()
    want = np.asarray(JSC.score(jstats, scorer, eligible=jnp.asarray(elig)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if scorer == "s3":
        with pytest.raises(ValueError, match="bootstrap"):
            SC.score(SC.CandidateStats(r_p=_t(r_p), m=_t(m), ci_lo=_t(lo),
                                       ci_hi=_t(hi)), "s3")
    with pytest.raises(ValueError, match="scorer"):
        SC.score(stats, "s9")


# ----------------------------------------------------------------------------
# top-k query on the golden corpus
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    q_keys, q_vals, cands, truth = G._corpus()
    qsk = jbuild(jnp.asarray(q_keys), jnp.asarray(q_vals), n=G.N_SKETCH)
    stack = jstack([jbuild(jnp.asarray(k), jnp.asarray(v), n=G.N_SKETCH)
                    for k, v in cands])
    order_truth = np.argsort(-np.abs(truth))
    truth_rank = np.empty(G.C)
    truth_rank[order_truth] = np.arange(G.C)
    return dict(jq=qsk, js=stack,
                tq=convert.sketches_from_reference(qsk, device="cpu"),
                ts=convert.sketches_from_reference(stack, device="cpu"),
                order_truth=order_truth, truth_rank=truth_rank)


def _agree(want, got):
    ws, wi = np.asarray(want.scores), np.asarray(want.indices)
    gs, gi = got.scores.numpy(), got.indices.numpy()
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(want.m))
    for p in np.nonzero(gi != wi)[0]:
        assert any(abs(ws[p] - ws[j]) <= TOL for j in (p - 1, p + 1)
                   if 0 <= j < ws.shape[0]), (p, wi, gi)


@pytest.mark.parametrize("estimator,scorer", G._COMBOS)
def test_topk_query_matches_reference(golden, estimator, scorer):
    """The 12 deterministic combinations: the reference's top-k. s3 (the
    bootstrap): the golden floors of tests/test_ranking_golden.py."""
    boot = scorer == "s3"
    got = RK.topk_query(golden["tq"], golden["ts"], k=G.C,
                        estimator=estimator, scorer=scorer, bootstrap=boot,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    idx = got.indices.numpy()
    assert sorted(idx.tolist()) == list(range(G.C))
    if not boot:
        _agree(jtopk(golden["jq"], golden["js"], k=G.C, estimator=estimator,
                     scorer=scorer), got)
        return
    pred_rank = np.empty(G.C)
    pred_rank[idx] = np.arange(G.C)
    recall = len(set(idx[:G.K].tolist())
                 & set(golden["order_truth"][:G.K].tolist())) / G.K
    rec_floor, tau_floor = G._FLOORS[scorer]
    assert recall >= rec_floor
    assert G._kendall(golden["truth_rank"], pred_rank) >= tau_floor
    assert idx[0] == golden["order_truth"][0]


def test_topk_query_chunking_changes_nothing(golden, monkeypatch):
    """Chunks of 5 candidates (and of 7 under the bootstrap) give the same
    result as one chunk, bit for bit, the bootstrap included."""
    def run(est, sc):
        return RK.topk_query(golden["tq"], golden["ts"], k=8, estimator=est,
                             scorer=sc, bootstrap=sc == "s3",
                             generator=torch.Generator().manual_seed(1),
                             device="cpu")
    combos = [("spearman", "s4"), ("qn", "s2"), ("pearson", "s3")]
    whole = [run(*c) for c in combos]
    monkeypatch.setattr(RK, "CHUNK", 5)
    monkeypatch.setattr(RK, "BOOT_ELEMENTS", 7 * 599 * G.N_SKETCH)
    for w, c in zip(whole, combos):
        got = run(*c)
        for f in ("indices", "scores", "r", "m", "ci_lo", "ci_hi", "join_size"):
            assert torch.equal(getattr(w, f), getattr(got, f)), (c, f)


def test_topk_query_ties_and_ineligible_rows(golden):
    """k above the eligible count: −inf rows follow in index order, as
    `jax.lax.top_k` orders them; ties in score go to the lower index."""
    tq, ts = golden["tq"], golden["ts"]
    three = RK.topk_query(tq, ts.map(lambda t: t[:3]), k=3, scorer="s1",
                          device="cpu")
    score = dict(zip(three.indices.tolist(), three.scores.tolist()))
    dup = ts.map(lambda t: torch.cat([t[:3], t[:3]]))
    got = RK.topk_query(tq, dup, k=6, scorer="s1", device="cpu")
    assert got.indices.tolist() == sorted(range(6), key=lambda i: (
        -score[i % 3], i))
    far = RK.topk_query(tq, ts, k=G.C, min_sample=10 ** 6, device="cpu")
    assert far.indices.tolist() == list(range(G.C))
    assert bool(torch.isinf(far.scores).all())
    want = jtopk(golden["jq"], golden["js"], k=G.C, min_sample=10 ** 6)
    np.testing.assert_array_equal(far.indices.numpy(), np.asarray(want.indices))


# ----------------------------------------------------------------------------
# quickstart
# ----------------------------------------------------------------------------

def test_quickstart_prints_the_examples_numbers(capsys):
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, os.path.join(_ROOT, "examples",
                                                       "quickstart.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out
    num = re.compile(r"[-+]?\d+\.?\d*")
    ref_lines, got_lines = ref.stdout.splitlines(), got.splitlines()
    assert len(got_lines) == len(ref_lines) == 6
    for g, w in zip(got_lines, ref_lines):
        assert g.split(":")[0] == w.split(":")[0]
        gn, wn = num.findall(g), num.findall(w)
        assert len(gn) == len(wn), (g, w)
        np.testing.assert_allclose([float(x) for x in gn],
                                   [float(x) for x in wn], atol=1e-3)
