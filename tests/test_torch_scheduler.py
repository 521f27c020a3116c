"""The port's `AsyncScheduler` (`repro_torch.engine.scheduler`) on the CPU:
the ports of tests/test_scheduler.py's scheduler tests, plus the port's
scheduler against the JAX package's on the same corpus.

  * results served through the scheduler equal direct `Server.query_batch`
    calls bit for bit, whatever coalescing the admission loop chose;
  * coalescing is real and counted, and ``max_queue`` back-pressure raises
    in the submitting caller;
  * invalid requests fail at `submit()`, worker-side failures reach every
    waiter's `result()`;
  * query threads racing append/delete/compact and `refresh()` never fail,
    and each result equals a single-threaded replay at some index version
    inside its submit→complete window.

The reference's compile-cache test has no counterpart: nothing compiles in
the port. Inputs come from seeded numpy (tests/test_two_stage.py's corpus).
"""
import threading
import time

import jax
import numpy as np
import pytest

from repro.engine import index as JI
from repro.engine import plans as JPL
from repro.engine import serve as JSV
from repro.engine.scheduler import AsyncScheduler as JAsyncScheduler
from repro_torch.data.pipeline import Table
from repro_torch.engine import index as TI
from repro_torch.engine import lifecycle as TL
from repro_torch.engine import plans as TPL
from repro_torch.engine import serve as TSV
from repro_torch.engine.scheduler import AsyncScheduler
from repro_torch.launch.mesh import make_host_mesh

from test_two_stage import _corpus, _queries

N_SKETCH = 32
TOL = 5e-5


def _server(tables, buckets=(1, 2, 4)):
    idx = TI.build_index(tables, n=N_SKETCH, pad_to=len(tables), device="cpu")
    srv = TSV.Server(idx, TPL.ShapePolicy(k_max=4, prune_base=2),
                     request=TPL.Request(k=4), buckets=buckets, device="cpu")
    srv.warmup(modes=("off",))
    return srv


def _static_server(rng, n_tables=8, buckets=(1, 2, 4)):
    return _server(_corpus(rng, n_tables=n_tables), buckets)


def _qsks(rng, nq):
    qs = _queries(rng, nq=nq)
    return TSV.build_query_sketches([k for k, _ in qs], [v for _, v in qs],
                                    n=N_SKETCH, device="cpu")


def _slice(sks, i):
    return sks.map(lambda a: a[i:i + 1])


def test_scheduler_bit_identical_to_direct(rng):
    """Per-ticket results == the direct batched call, element for element,
    however the admission loop grouped the submissions."""
    srv = _static_server(rng)
    sks = _qsks(rng, 6)
    direct = srv.query_batch(sks)
    with AsyncScheduler(srv, workers=1) as sched:
        tickets = [sched.submit(_slice(sks, i)) for i in range(6)]
        for i, t in enumerate(tickets):
            got = t.result(timeout=120.0)
            for g, d in zip(got, direct):
                np.testing.assert_array_equal(g, d[i:i + 1, :4])
        st = sched.stats()
    assert st["submitted"] == st["completed"] == 6
    assert st["errors"] == 0 and st["queue_depth"] == 0
    # admission telemetry rides Server.throughput()
    tp = srv.throughput()
    assert tp["queue_depth"] == 0 and tp["deadline_misses"] == 0


def test_coalescing_counters_and_backpressure(rng, monkeypatch):
    """While the single worker is parked inside a dispatch, later arrivals
    pile up and flush as one group; ``max_queue`` rejects the overflow in
    the submitting caller."""
    srv = _static_server(rng, buckets=(1, 2, 4))
    sks = _qsks(rng, 6)
    gate, entered = threading.Event(), threading.Event()
    orig = srv.query_batch
    widths = []

    def slow(s, **kw):
        widths.append(int(s.key_hash.shape[0]))
        if len(widths) == 1:
            entered.set()
            assert gate.wait(30.0)
        return orig(s, **kw)

    monkeypatch.setattr(srv, "query_batch", slow)
    sched = AsyncScheduler(srv, workers=1, max_queue=4)
    try:
        head = sched.submit(_slice(sks, 0))
        assert entered.wait(30.0)
        rest = [sched.submit(_slice(sks, i)) for i in range(1, 5)]
        with pytest.raises(RuntimeError, match="queue full"):
            sched.submit(_slice(sks, 5))
        gate.set()
        for t in [head] + rest:
            t.result(timeout=120.0)
        st = sched.stats()
        # head alone, then the four queued queries as one coalesced group
        # (max_coalesce defaults to max(buckets) = 4)
        assert widths == [1, 4]
        assert st["batches"] == 2 and st["avg_coalesce"] == 2.5
        assert st["flush_full"] + st["flush_drain"] == 2
    finally:
        gate.set()
        sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(_slice(sks, 0))


def test_submit_validation_and_error_propagation(rng, monkeypatch):
    """Bad requests raise in the caller; a worker-side exception re-raises
    from the affected ticket's `result()` and counts as an error."""
    srv = _static_server(rng)
    sks = _qsks(rng, 1)
    with pytest.raises(ValueError, match="workers"):
        AsyncScheduler(srv, workers=0)
    with AsyncScheduler(srv, workers=1) as sched:
        with pytest.raises(ValueError, match="k_max"):
            sched.submit(_slice(sks, 0), request=TPL.Request(k=9))
        with pytest.raises(ValueError, match="estimator"):
            sched.submit(_slice(sks, 0),
                         request=TPL.Request(k=2, estimator="nope"))
        monkeypatch.setattr(
            srv, "query_batch",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("kaboom")))
        t = sched.submit(_slice(sks, 0))
        with pytest.raises(RuntimeError, match="kaboom"):
            t.result(timeout=30.0)
        assert sched.stats()["errors"] == 1


def test_deadlines_and_mixed_requests(rng):
    """Tickets of different requests never share a dispatch, each gets its
    own k, and with a deadline already past every query counts as a miss
    while its result stays exact."""
    srv = _static_server(rng)
    sks = _qsks(rng, 4)
    reqs = [TPL.Request(k=4), TPL.Request(k=2),
            TPL.Request(k=3, estimator="spearman", scorer="s1"),
            TPL.Request(k=4, estimator="qn")]
    with AsyncScheduler(srv, workers=1, slo_ms=0.0) as sched:
        tickets = [sched.submit(_slice(sks, i), request=reqs[i])
                   for i in range(4)]
        for i, t in enumerate(tickets):
            want = srv.query_batch(_slice(sks, i), request=reqs[i])
            got = t.result(timeout=120.0)
            assert got[0].shape == (1, reqs[i].k)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            assert t.missed_deadline and t.latency_s >= 0.0
        st = sched.stats()
    assert st["deadline_misses"] == 4 and st["completed"] == 4


def _agree(want, got):
    ws, wi, wr, wm = (np.asarray(a) for a in want)
    gs, gi, gr, gm = got
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gr, wr, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(gm, wm)
    for q, p in zip(*np.nonzero(gi != wi)):
        row = ws[q]
        assert any(abs(row[p] - row[j]) <= TOL for j in (p - 1, p + 1)
                   if 0 <= j < row.shape[0]), (q, p, wi[q], gi[q])


def test_scheduler_matches_reference_scheduler(rng):
    """The port's scheduler and the JAX package's, each over its own
    server on the same tables, serve the same top-k (ids except
    near-ties, r and scores within 5e-5, m exactly)."""
    tables = _corpus(rng, n_tables=8)
    qs = _queries(rng, nq=5)
    keys, vals = [k for k, _ in qs], [v for _, v in qs]
    idx = JI.build_index(tables, n=N_SKETCH, pad_to=8)
    jsrv = JSV.Server(jax.make_mesh((1,), ("shard",)), idx,
                      JPL.ShapePolicy(k_max=4, prune_base=2),
                      request=JPL.Request(k=4), buckets=(1, 2, 4),
                      cache=JSV.CompileCache())
    jsrv.warmup(modes=("off",))
    jsks = jax.tree.map(np.asarray, JSV.build_query_sketches(
        keys, vals, n=N_SKETCH))
    srv = _server(tables)
    sks = TSV.build_query_sketches(keys, vals, n=N_SKETCH, device="cpu")
    with JAsyncScheduler(jsrv, workers=1) as jsched, \
            AsyncScheduler(srv, workers=1) as sched:
        for est in ("pearson", "rin"):
            jt = [jsched.submit(jax.tree.map(lambda a: a[i:i + 1], jsks),
                                request=JPL.Request(k=4, estimator=est))
                  for i in range(5)]
            tt = [sched.submit(_slice(sks, i),
                               request=TPL.Request(k=4, estimator=est))
                  for i in range(5)]
            for j, t in zip(jt, tt):
                _agree(j.result(timeout=120.0), t.result(timeout=120.0))


# ---------------------------------------------------------------------------
# queries race mutations through the scheduler
# ---------------------------------------------------------------------------

def _mutation_script(rng, steps=4):
    """A deterministic append/delete/compact schedule, generated once and
    replayed twice: live under load, then single-threaded as the oracle."""
    script = []
    for step in range(steps):
        m = int(rng.integers(64, 400))
        t = Table(keys=rng.choice(2000, size=m, replace=False).astype(
                      np.uint32),
                  values=rng.standard_normal(m).astype(np.float32),
                  name=f"x{step}")
        script.append(("append", [t]))
        script.append(("delete", f"t{step}"))
    script.append(("compact", None))
    return script


def _apply(live, op):
    kind, arg = op
    if kind == "append":
        live.append(arg)
    elif kind == "delete":
        live.delete(arg)
    else:
        live.compact()


def _live_server(rng, shards: int = 1):
    live = TL.LiveIndex(n=N_SKETCH, delta_cap=8, device="cpu")
    live.append(_corpus(rng, n_tables=5))
    srv = TSV.Server(live, TPL.ShapePolicy(k_max=4, prune_base=2),
                     request=TPL.Request(k=4), buckets=(1, 2, 4),
                     mesh=make_host_mesh(shards, device="cpu"))
    srv.warmup(modes=("off",), include_ladder=True)
    return live, srv


def test_stress_queries_race_mutations(rng):
    """Query threads hammer the scheduler (two workers) while the index
    appends, deletes and compacts and `refresh()` republishes under them:
    no ticket fails, and every result equals the single-threaded oracle at
    a version inside the query's submit→complete window."""
    _race_mutations(rng, shards=1)


def test_stress_queries_race_mutations_on_a_mesh(rng):
    """The same race with every segment sharded over a 4-shard mesh: the
    workers' sharded dispatches serialise on the mesh lock, and every
    result equals the one-device oracle at a version in its window."""
    _race_mutations(rng, shards=4)


def _race_mutations(rng, shards: int):
    seed = int(rng.integers(1 << 30))
    rng_live = np.random.default_rng(seed)
    live, srv = _live_server(rng_live, shards)
    script = _mutation_script(rng_live)
    sks = _qsks(np.random.default_rng(seed + 1), 1)

    results, errors = [], []
    stop = threading.Event()

    def qloop(sched):
        while not stop.is_set():
            v0 = live.version
            try:
                res = sched.query(sks, timeout=120.0)
            except Exception as e:   # pragma: no cover - fail loudly
                errors.append(e)
                return
            results.append((v0, live.version, res))

    with AsyncScheduler(srv, workers=2) as sched:
        threads = [threading.Thread(target=qloop, args=(sched,))
                   for _ in range(3)]
        for t in threads:
            t.start()
        for op in script:
            _apply(live, op)
            srv.refresh()
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=180.0)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert results, "query threads never completed a request"

    rng_replay = np.random.default_rng(seed)
    live2, srv2 = _live_server(rng_replay)
    script2 = _mutation_script(rng_replay)
    expected = {live2.version: srv2.query_batch(sks)}
    for op in script2:
        _apply(live2, op)
        expected[live2.version] = srv2.query_batch(sks)
    assert live2.version == live.version

    def matches(res, want):
        return all(np.array_equal(g, w[:, :4]) for g, w in zip(res, want))

    for v0, v1, res in results:
        window = [v for v in range(v0, v1 + 1) if v in expected]
        assert window, f"no oracle state for version window [{v0}, {v1}]"
        assert any(matches(res, expected[v]) for v in window), (
            f"result matches no index version in [{v0}, {v1}]")
