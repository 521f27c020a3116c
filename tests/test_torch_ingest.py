"""Fused ingest in the port: the `hash_build` twin, the fused table build,
the merge algebra of stacked sketches and `build_index(engine=...)`, each
held against the JAX package on the same seeded numpy inputs. Hashes, key
planes and masks are compared bit for bit; so are values, counts, orders
and column statistics, since both packages add each key's values in row
order. (The CUDA kernel against its twin: `tests/test_torch_kernels.py`.)
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import sketch as JS
from repro.data import pipeline as JP
from repro.engine import index as JI
from repro.engine import ingest as JG
from repro.kernels import ops as JK
from repro.kernels import ref as JR
from repro.kernels.ops import KernelConfig
from repro_torch.core import hashing as TH
from repro_torch.core import sketch as TS
from repro_torch.data import pipeline as TP
from repro_torch.engine import index as TI
from repro_torch.engine import ingest as TG
from repro_torch.kernels import ops, ref

CPU = torch.device("cpu")
FIELDS = ("key_hash", "acc", "cnt", "order", "mask", "col_min", "col_max",
          "rows")


def _murmur_preimage_u32(target: int) -> int:
    """The one 32-bit key whose murmur3-32 (seed 0x9747B28C) is ``target``:
    every mixing step is a bijection on Z_2^32."""
    M = 1 << 32
    inv = lambda x: pow(int(x), -1, M)
    rotr = lambda x, r: ((x >> r) | (x << (32 - r))) & (M - 1)
    unxs = lambda y, s: y ^ (y >> s) ^ ((y >> s) >> s)
    h = unxs(target, 16)
    h = (h * inv(0xC2B2AE35)) % M
    h = unxs(h, 13)
    h = (h * inv(0x85EBCA6B)) % M
    h = unxs(h, 16)
    h ^= 4
    h = ((h - 0xE6546B64) * inv(5)) % M
    k = rotr(h, 13) ^ 0x9747B28C
    k = (k * inv(0x1B873593)) % M
    k = rotr(k, 15)
    return (k * inv(0xCC9E2D51)) % M


#: the key hashing to the key-space sentinel, and the key whose Fibonacci
#: value is the Fibonacci-space sentinel
SENTINEL_KEY = _murmur_preimage_u32(0xFFFFFFFF)
FIB_SENTINEL_KEY = _murmur_preimage_u32(
    (0xFFFFFFFF * pow(2654435769, -1, 1 << 32)) % (1 << 32))
EDGE_KEYS = np.array([0, 0xFFFFFFFF, SENTINEL_KEY, FIB_SENTINEL_KEY],
                     np.uint32)


def _assert_fields(got, want, ctx=""):
    """Port sketch ``got`` equals JAX sketch ``want`` bit for bit."""
    for f in FIELDS:
        a = getattr(got, f).numpy()
        b = np.asarray(getattr(want, f))
        if f == "key_hash":
            a = a.astype(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: {f}")


def _assert_same(a, b, ctx=""):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), (ctx, f)


def _messy(rng, name, n_cols=4, n_rows=3000, key_space=900):
    """Repeated keys (so every aggregation differs), NaNs, and the two
    sentinel preimages among the keys."""
    keys = rng.integers(0, key_space, size=n_rows).astype(np.uint32)
    keys[:3] = [SENTINEL_KEY, FIB_SENTINEL_KEY, SENTINEL_KEY]
    vals = rng.normal(size=(n_cols, n_rows)).astype(np.float32)
    vals[min(1, n_cols - 1), ::7] = np.nan
    vals[-1, 100:400] = np.nan
    return keys, vals, name


# ----------------------------------------------------------------------------
# hash_build
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 5, 4093])
def test_hash_build_twin_matches_reference_and_pallas(rng, m):
    """h, fib and unit bit-equal to the JAX oracle and to the Pallas body
    under the interpreter, at odd m, with the edge keys at the front."""
    keys = rng.integers(0, 1 << 32, size=m, dtype=np.uint64).astype(np.uint32)
    keys[:min(m, 4)] = EDGE_KEYS[:min(m, 4)]
    h, fib, unit = ref.hash_build(torch.from_numpy(keys.view(np.int32)))
    got = (h.numpy().view(np.uint32), fib.numpy().view(np.uint32),
           unit.numpy())
    jk = jnp.asarray(keys)
    for want in (JR.hash_build(jk),
                 JK.hash_build(jk, KernelConfig("interpret"))):
        for g, w, name in zip(got, want, ("h", "fib", "unit")):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    if m >= 4:   # the preimages land on the sentinels
        assert got[0][2] == 0xFFFFFFFF and got[1][3] == 0xFFFFFFFF


def test_hash_build_dispatch_shape_and_type(rng):
    """`ops.hash_build` keeps the key shape, routes CPU tensors to the twin
    (matching `core.hashing`), and refuses non-int32 keys."""
    keys = torch.from_numpy(rng.integers(0, 1 << 31, size=(3, 7)).astype(
        np.int32))
    h, fib, unit = ops.hash_build(keys)
    assert h.shape == fib.shape == unit.shape == (3, 7)
    assert h.dtype == fib.dtype == torch.int32 and unit.dtype == torch.float32
    want_h = TH.murmur3_32(keys)
    assert torch.equal(TH.from_pattern(h), want_h)
    assert torch.equal(TH.from_pattern(fib), TH.fibonacci_u32(want_h))
    assert torch.equal(unit, TH.unit_interval(TH.fibonacci_u32(want_h)))
    with pytest.raises(TypeError):
        ops.hash_build(keys.to(torch.int64))


# ----------------------------------------------------------------------------
# the fused build
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("agg", list(TS.Agg))
def test_fused_build_matches_reference_and_loop(rng, agg):
    """A messy table through the port's fused and loop engines equals the
    JAX fused engine, every field bit for bit, for every aggregation."""
    keys, vals, _ = _messy(rng, "t")
    want = JG.sketch_source(JP.TableGroup(keys=keys, values=vals), n=64,
                            agg=JS.Agg(agg.value), chunk=1024)
    fused = TG.sketch_table(keys, vals, n=64, agg=agg, chunk=1024,
                            device=CPU)
    loop = TG.sketch_source(TP.TableGroup(keys=keys, values=vals), n=64,
                            agg=agg, chunk=1024, device=CPU, engine="loop")
    _assert_fields(fused, want, f"fused {agg}")
    _assert_same(fused, loop, f"fused vs loop {agg}")
    kh, mask = fused.key_hash, fused.mask
    assert not (kh[mask] == TH.SENTINEL_HASH).any()
    assert not (TH.fibonacci_u32(kh[mask]) == TH.SENTINEL_HASH).any()


def test_batched_sources_match_each_source_alone(rng):
    """Several sources in one batched fused build (a group, a single
    column, a cut of the group) equal each source sketched alone by the JAX
    engine. 64-bit keys form a batch of their own and equal the port's loop
    engine (the JAX package runs without 64-bit types, so it cuts such keys
    to 32 bits)."""
    k1, v1, _ = _messy(rng, "a", n_rows=1700)
    k2, v2, _ = _messy(rng, "b", n_cols=1, n_rows=800)
    k3 = rng.integers(0, 1 << 40, size=900).astype(np.uint64)
    v3 = rng.normal(size=(2, 900)).astype(np.float32)
    srcs = [(k1, v1), (k2, v2[0]), (k3, v3), (k1[:500], v1[:, :500])]
    tsrc = [TP.TableGroup(keys=k, values=v) if v.ndim == 2 else
            TP.Table(keys=k, values=v) for k, v in srcs]
    got = TG.sketch_sources(tsrc, n=32, chunk=512, device=CPU)
    c0 = 0
    for (k, v), t in zip(srcs, tsrc):
        part = got.map(lambda x: x[c0:c0 + (v.shape[0] if v.ndim == 2
                                            else 1)])
        if k.dtype == np.uint64:
            _assert_same(part, TG.sketch_source(t, n=32, chunk=512,
                                                device=CPU, engine="loop"))
        else:
            j = (JP.TableGroup(keys=k, values=v) if v.ndim == 2 else
                 JP.Table(keys=k, values=v))
            _assert_fields(part, JG.sketch_source(j, n=32, agg=JS.Agg.MEAN,
                                                  chunk=512), f"col {c0}")
        c0 += part.key_hash.shape[0]
    assert c0 == got.key_hash.shape[0] == 11


def test_build_sketch_cols_single_chunk_matches_reference(rng):
    """One chunk of all columns, with a padded tail and a row offset."""
    m, C, n = 1200, 4, 32
    keys = rng.integers(0, 300, size=m).astype(np.uint32)
    vals = rng.normal(size=(C, m)).astype(np.float32)
    valid = np.arange(m) < m - 77
    want = JS.build_sketch_cols(jnp.asarray(keys), jnp.asarray(vals), n=n,
                                valid=jnp.asarray(valid), order_offset=5.0)
    got = TS.build_sketch_cols(TH.keys_tensor(keys), torch.from_numpy(vals),
                               n=n, valid=torch.from_numpy(valid),
                               order_offset=5.0)
    _assert_fields(got, want)
    # leading batch axes: two tables at once, [2, C, n] out
    both = TS.build_sketch_cols(
        torch.stack([TH.keys_tensor(keys)] * 2),
        torch.from_numpy(np.stack([vals, vals[::-1].copy()])), n=n)
    assert both.key_hash.shape == (2, C, n)
    one = TS.build_sketch_cols(TH.keys_tensor(keys),
                               torch.from_numpy(vals[::-1].copy()), n=n)
    _assert_same(both.map(lambda t: t[1]), one)


def test_ingest_rejects_an_unknown_engine(rng):
    g = TP.multi_column_group(rng, n_cols=2, n_max=600)
    with pytest.raises(ValueError, match="engine"):
        TG.sketch_source(g, n=16, device=CPU, engine="jit")
    with pytest.raises(ValueError, match="engine"):
        TI.build_index([g], n=16, device=CPU, engine="jit")


# ----------------------------------------------------------------------------
# merge algebra of stacked sketches
# ----------------------------------------------------------------------------

def _cols(rng, m=4000, C=3, n=32, key_space=900):
    keys = rng.integers(0, key_space, size=m).astype(np.uint32)
    vals = rng.normal(size=(C, m)).astype(np.float32)
    return keys, vals


def test_empty_is_merge_identity_and_place_cols(rng):
    keys, vals = _cols(rng, m=500)
    sk = TS.build_sketch_cols(TH.keys_tensor(keys), torch.from_numpy(vals),
                              n=32)
    empty = TS.empty_sketch_cols(3, 32)
    for merged in (TG.merge_cols(empty, sk), TG.merge_cols(sk, empty)):
        _assert_same(merged, sk)
    want = JS.place_cols(JS.build_sketch_cols(jnp.asarray(keys),
                                              jnp.asarray(vals), n=32), 8, 2)
    _assert_fields(TS.place_cols(sk, 8, 2), want)
    with pytest.raises(ValueError):
        TS.place_cols(sk, 4, 2)


@pytest.mark.parametrize("P", [2, 3, 5])
def test_tree_merge_equals_linear_fold_and_reference(rng, P):
    """The tree fold of P row-strided partial sketches equals the JAX tree
    fold bit for bit, and the linear fold up to the order of its sums (the
    same keys, masks and counts; values within 1e-5)."""
    keys, vals = _cols(rng)
    parts = [TS.build_sketch_cols(TH.keys_tensor(keys[s::P]),
                                  torch.from_numpy(vals[:, s::P].copy()),
                                  n=32) for s in range(P)]
    tree = TG.tree_merge(TS.stack_sketches(parts))
    lin = parts[0]
    for p in parts[1:]:
        lin = TG.merge_cols(lin, p)
    for f in ("key_hash", "mask", "cnt", "order", "col_min", "col_max",
              "rows"):
        assert torch.equal(getattr(tree, f), getattr(lin, f)), f
    torch.testing.assert_close(tree.acc, lin.acc, rtol=1e-5, atol=1e-5)
    jparts = [JS.build_sketch_cols(jnp.asarray(keys[s::P]),
                                   jnp.asarray(vals[:, s::P]), n=32)
              for s in range(P)]
    want = JG.tree_merge(jax.tree.map(lambda *xs: jnp.stack(xs), *jparts))
    _assert_fields(tree, want)


# ----------------------------------------------------------------------------
# build_index
# ----------------------------------------------------------------------------

def test_build_index_fused_equals_loop_and_reference():
    """Fused and loop port builds are bit-identical to each other and to
    the JAX fused build, padding included; the alias serves groups."""
    jg = JP.group_corpus(np.random.default_rng(0), 3, n_cols=3, n_max=2000)
    tg = TP.group_corpus(np.random.default_rng(0), 3, n_cols=3, n_max=2000)
    for a, b in zip(jg, tg):   # the port's generator makes the same tables
        assert a.name == b.name and np.array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.values, b.values)
    mixed_t = [tg[0], TP.Table(keys=tg[0].keys, values=tg[0].values[0] * 2,
                               name="solo"), tg[1], tg[2]]
    mixed_j = [jg[0], JP.Table(keys=jg[0].keys, values=jg[0].values[0] * 2,
                               name="solo"), jg[1], jg[2]]
    want = JI.build_index(mixed_j, n=32, pad_to=16)
    fused = TI.build_index_groups(mixed_t, n=32, pad_to=16, device=CPU)
    loop = TI.build_index(mixed_t, n=32, pad_to=16, device=CPU,
                          engine="loop")
    assert fused.names == loop.names == want.names
    for f in ("key_hash", "values", "mask", "col_min", "col_max", "rows"):
        a, b = getattr(fused.shard, f), getattr(loop.shard, f)
        assert torch.equal(a, b), f
        w = np.asarray(getattr(want.shard, f))
        np.testing.assert_array_equal(
            a.numpy().view(np.uint32) if f == "key_hash" else a.numpy(), w,
            err_msg=f)
