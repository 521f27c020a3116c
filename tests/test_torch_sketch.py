"""The port's sketch construction against the JAX package: key planes and
masks bit for bit, values allclose at 1e-6 — for `build_sketch` under all
seven aggregations, `merge`, `build_sketch_streaming`, the batched query
sketches, the index build and the sketches carried over by `convert`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as S
from repro.data import pipeline as JP
from repro.engine import index as JI
from repro.engine import serve as SV
from repro_torch import convert
from repro_torch.core import hashing as TH
from repro_torch.core import sketch as TS
from repro_torch.data import pipeline as TP
from repro_torch.engine import index as TI
from repro_torch.engine import serve as TSV


def _column(rng, m=400, distinct=250):
    keys = rng.integers(0, distinct, size=m).astype(np.uint32)
    vals = rng.normal(size=m).astype(np.float32)
    vals[rng.random(m) < 0.05] = np.nan
    return keys, vals


def _same(js, ts):
    np.testing.assert_array_equal(ts.key_hash.numpy(),
                                  np.asarray(js.key_hash).astype(np.int64))
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    for f in ("order", "col_min", "col_max", "rows"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    for f in ("acc", "cnt"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.values().numpy(), np.asarray(js.values()),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("agg", list(S.Agg), ids=lambda a: a.value)
def test_build_sketch_matches_reference(rng, agg):
    """Repeated keys fold under every aggregation; NaNs are dropped."""
    keys, vals = _column(rng)
    js = S.build_sketch(jnp.asarray(keys), jnp.asarray(vals), n=64, agg=agg)
    ts = TS.build_sketch(TH.keys_tensor(keys), torch.from_numpy(vals), n=64,
                         agg=TS.Agg(agg.value))
    _same(js, ts)


@pytest.mark.parametrize("agg", [S.Agg.FIRST, S.Agg.LAST],
                         ids=lambda a: a.value)
def test_merge_and_streaming_match_reference(rng, agg):
    """merge of two partial sketches and the chunked streaming build both
    equal the reference (order-dependent aggregations included)."""
    keys, vals = _column(rng, m=600, distinct=300)
    n = 48
    ja = S.build_sketch(jnp.asarray(keys[:250]), jnp.asarray(vals[:250]),
                        n=n, agg=agg)
    jb = S.build_sketch(jnp.asarray(keys[250:]), jnp.asarray(vals[250:]),
                        n=n, agg=agg, order_offset=250.0)
    tk, tv = TH.keys_tensor(keys), torch.from_numpy(vals)
    tagg = TS.Agg(agg.value)
    ta = TS.build_sketch(tk[:250], tv[:250], n=n, agg=tagg)
    tb = TS.build_sketch(tk[250:], tv[250:], n=n, agg=tagg, order_offset=250.0)
    _same(S.merge(ja, jb), TS.merge(ta, tb))
    _same(S.build_sketch_streaming(keys, vals, n=n, agg=agg, chunk=128),
          TS.build_sketch_streaming(tk, tv, n=n, agg=tagg, chunk=128))


def test_build_sketch_u64_keys_and_short_columns(rng):
    """64-bit keys hash as two blocks; a column shorter than the sketch
    pads up (the merge identity: sketch ⊕ empty == sketch)."""
    keys = rng.integers(0, 2**40, size=30).astype(np.int64)
    vals = rng.normal(size=30).astype(np.float32)
    ts = TS.build_sketch(TH.keys_tensor(keys), torch.from_numpy(vals), n=64)
    assert int(ts.mask.sum()) == 30
    want = TH.murmur3_32(torch.from_numpy(keys))
    assert set(ts.key_hash[ts.mask].tolist()) == set(want.tolist())
    empty = TS.build_sketch(TH.keys_tensor(keys), torch.from_numpy(vals), n=64,
                            valid=torch.zeros(30, dtype=torch.bool))
    merged = TS.merge(ts, empty)
    torch.testing.assert_close(merged.key_hash, ts.key_hash)
    torch.testing.assert_close(merged.values(), ts.values())


def test_stack_equals_batched_build(rng):
    """Sketches built one by one and stacked == one batched build."""
    cols = [_column(rng) for _ in range(3)]
    keys = np.stack([k for k, _ in cols])
    vals = np.stack([v for _, v in cols])
    batched = TS.build_sketch(TH.keys_tensor(keys), torch.from_numpy(vals),
                              n=32)
    stacked = TS.stack_sketches([
        TS.build_sketch(TH.keys_tensor(k), torch.from_numpy(v), n=32)
        for k, v in cols])
    for f in ("key_hash", "acc", "cnt", "order", "mask", "col_min",
              "col_max", "rows"):
        torch.testing.assert_close(getattr(stacked, f), getattr(batched, f))


def test_query_sketches_match_reference(rng):
    """Batched multi-chunk query sketches (ragged lengths) == reference."""
    keys = [rng.choice(1 << 20, size=m, replace=False).astype(np.uint32)
            for m in (700, 90, 300)]
    vals = [rng.normal(size=len(k)).astype(np.float32) for k in keys]
    js = SV.build_query_sketches(keys, vals, n=64, chunk=256)
    ts = TSV.build_query_sketches(keys, vals, n=64, chunk=256, device="cpu")
    _same(js, ts)


def test_build_index_matches_reference():
    """Mixed `TableGroup`s and single `Table`s, multi-chunk tables and
    ``pad_to`` padding: planes equal the reference's fused build."""
    groups = [JP.multi_column_group(np.random.default_rng(i), n_cols=4,
                                    n_max=2500, name=f"g{i}") for i in range(3)]
    tgroups = [TP.multi_column_group(np.random.default_rng(i), n_cols=4,
                                     n_max=2500, name=f"g{i}") for i in range(3)]
    single = TP.sbn_pair(np.random.default_rng(7), n_max=1500)[1]
    jsingle = JP.Table(keys=single.keys, values=single.values, name=single.name)
    ji = JI.build_index(groups + [jsingle], n=64, chunk=1024, pad_to=16)
    ti = TI.build_index(tgroups + [single], n=64, chunk=1024, pad_to=16,
                        device="cpu")
    assert ti.names == ji.names and ti.n == ji.n
    np.testing.assert_array_equal(ti.shard.key_hash.numpy(),
                                  np.asarray(ji.shard.key_hash).view(np.int32))
    np.testing.assert_array_equal(ti.shard.mask.numpy(), np.asarray(ji.shard.mask))
    for f in ("values", "col_min", "col_max", "rows"):
        np.testing.assert_allclose(getattr(ti.shard, f).numpy(),
                                   np.asarray(getattr(ji.shard, f)),
                                   rtol=1e-6, atol=1e-6)


def test_sketches_from_reference_serve_as_own(rng):
    """Reference query sketches carried over by `convert` equal the port's
    own, field for field, and a server answers both alike."""
    keys = [rng.choice(1 << 20, size=m, replace=False).astype(np.uint32)
            for m in (500, 120)]
    vals = [rng.normal(size=len(k)).astype(np.float32) for k in keys]
    js = SV.build_query_sketches(keys, vals, n=64, chunk=256)
    carried = convert.sketches_from_reference(js, device="cpu")
    own = TSV.build_query_sketches(keys, vals, n=64, chunk=256, device="cpu")
    assert carried.agg == own.agg and carried.key_hash.dtype == torch.int64
    _same(js, carried)
    groups = [TP.multi_column_group(np.random.default_rng(i), n_cols=4,
                                    n_max=1500, name=f"g{i}") for i in range(2)]
    tables = groups + [TP.Table(keys=k, values=v, name=f"q{i}")
                       for i, (k, v) in enumerate(zip(keys, vals))]
    srv = TSV.Server(TI.build_index(tables, n=64, device="cpu"),
                     buckets=(1, 2), device="cpu")
    for got, want in zip(srv.query_batch(carried), srv.query_batch(own)):
        np.testing.assert_array_equal(got, want)
    assert (srv.query_batch(own)[1][:, 0] >= 0).all()
