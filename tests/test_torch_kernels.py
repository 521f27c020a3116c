"""The port's kernels: each plain PyTorch twin against the JAX package's
oracle (`repro.kernels.ref`) and against the Pallas kernel body run by the
interpreter (`repro.kernels.ops` with ``KernelConfig("interpret")``), at
the JAX package's own tolerances; each CUDA kernel against its twin on the
card (marked ``gpu``: skips without one).

The JAX side is imported through the ``jx`` fixture, so on a machine with
only the card's software the ``gpu`` tests still collect and run.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import containment as CT
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hash_build as HB
from repro_torch.kernels import ops, ref
from repro_torch.kernels import postings as PM
from repro_torch.kernels import rank_transform as RT
from repro_torch.kernels import sketch_join as SJ


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops, ref as jref
    from repro.kernels.ops import KernelConfig
    return SimpleNamespace(jnp=jax.numpy, ops=jops, ref=jref,
                           interp=KernelConfig("interpret"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _join_inputs(rng, B, nq, n, C):
    """Query/candidate sketches with planted overlaps and 85% masks (keys
    from 2³⁰, so distinct within a sketch, as the build guarantees)."""
    draw = lambda k: rng.integers(0, 1 << 30, size=k)
    qk = np.stack([draw(nq) for _ in range(B)]).astype(np.uint32)
    ck = np.stack([draw(n) for _ in range(C)]).astype(np.uint32)
    ov = min(nq, n) // 2
    ck[0, :ov] = qk[0, :ov]
    if C > 3:
        ck[3, :ov // 2] = qk[-1, ov // 2:ov]
    qv = rng.normal(size=(B, nq)).astype(np.float32)
    cv = rng.normal(size=(C, n)).astype(np.float32)
    qm = (rng.random((B, nq)) < 0.85).astype(np.float32)
    cm = (rng.random((C, n)) < 0.85).astype(np.float32)
    return qk, qv, qm, ck, cv, cm


def _torch_join_args(qk, qv, qm, ck, cv, cm, device="cpu"):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (t(qk.view(np.int32)), t(qv), t(qm), t(ck.view(np.int32)), t(cv),
            t(cm))


def _rank_inputs(rng, R, n):
    """Adversarial rows: heavy ties, random masks, an all-masked row, a
    single-survivor row and an all-ties row."""
    a = np.round(rng.normal(size=(R, n)) * 2).astype(np.float32) / 2
    b = (0.6 * a + rng.normal(size=(R, n))).astype(np.float32)
    mask = (rng.random((R, n)) < 0.75).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, 3] = 1.0
    a[2] = 1.5
    return a, b, mask


def _zero_rows(rng, R, n):
    """Rows of signed zeros that must tie: values drawn from {−0.0, +0.0,
    ±0.5} (a) and {−0.0, +0.0, 1.0} (b); row 0 of a is all zeros of both
    signs, row 1 of b all equal, row 2 all masked."""
    a = rng.choice(np.array([-0.0, 0.0, 0.5, -0.5], np.float32), size=(R, n))
    b = rng.choice(np.array([-0.0, 0.0, 1.0], np.float32), size=(R, n))
    mask = (rng.random((R, n)) < 0.8).astype(np.float32)
    a[0] = 0.0
    a[0, ::2] = -0.0
    b[1] = 2.0
    mask[2] = 0.0
    return a, b, mask


def _qn_inputs(rng, case, R, n):
    """Rows for Qn: "random" is `_rank_inputs`; "m2m3" rows of m = 2 and
    m = 3; "ties" rows whose valid a (even rows) or b (odd rows) all tie,
    so a scale is 0 and r = 0; "full" m = n without ties; "mixed" rows of
    m = 0 or 1 between joined rows, so that one block of the kernel (four
    rows at n ≤ 256, two at n ≤ 512) holds both."""
    a, b, mask = _rank_inputs(rng, R, n)
    if case == "m2m3":
        mask[:] = 0.0
        for r in range(R):
            mask[r, rng.choice(n, 2 + r % 2, replace=False)] = 1.0
    elif case == "ties":
        a[0::2] = 1.5
        b[1::2] = -0.25
    elif case == "full":
        perm = lambda: np.stack([rng.permutation(n) for _ in range(R)])
        a = (perm() * 0.37 + 0.1).astype(np.float32)
        b = (perm() * -0.61 + 2.0).astype(np.float32)
        mask[:] = 1.0
    elif case == "mixed":
        mask[0::2] = 0.0
        mask[0::4, rng.integers(n)] = 1.0
    else:
        assert case == "random", case
    return a, b, mask


def _transform_inputs(rng, R, n, ties=True):
    """Rows for rank_transform: ties, NaNs in valid and masked slots, 0/1
    masks with an all-masked row (R ≥ 2), any n ≥ 1."""
    x = rng.normal(size=(R, n)).astype(np.float32)
    if ties:
        x = np.round(x * 3) / 3
    mask = (rng.random((R, n)) < 0.8).astype(np.float32)
    x[0, : (n + 1) // 2] = np.nan
    if R > 1:
        mask[1] = 0.0
    return x.astype(np.float32), mask


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ----------------------------------------------------------------------------
# twins against the JAX package
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("B,nq,n,C", [(1, 64, 64, 8), (3, 128, 96, 13),
                                      (8, 64, 64, 64)])
def test_sketch_join_twin_matches_reference(rng, jx, B, nq, n, C):
    """Twin == `ref.sketch_join_moments_batched` at 1e-5
    (tests/test_kernels.py's tolerance)."""
    inp = _join_inputs(rng, B, nq, n, C)
    mom, al, hit = ref.sketch_join_moments_batched(*_torch_join_args(*inp))
    jm, ja, jh = jx.ref.sketch_join_moments_batched(
        *[jx.jnp.asarray(x) for x in inp])
    _close(mom, jm, 1e-5)
    _close(al, ja, 1e-5)
    _close(hit, jh, 1e-5)
    assert hit.sum() > 0   # the planted overlap matched


def test_sketch_join_twin_matches_pallas_interpret(rng, jx):
    """Twin == the Pallas kernel body (interpret mode), batched by vmap."""
    inp = _join_inputs(rng, 2, 64, 64, 8)
    mom, al, hit = ref.sketch_join_moments_batched(*_torch_join_args(*inp))
    jm, ja, jh = jx.ops.sketch_join_moments_batched(
        *[jx.jnp.asarray(x) for x in inp], jx.interp)
    _close(mom, jm, 1e-5)
    _close(al, ja, 1e-5)
    _close(hit, jh, 1e-5)


def test_sketch_join_without_aligned(rng):
    """Moments-only calls (pearson) give the same moments."""
    args = _torch_join_args(*_join_inputs(rng, 2, 32, 32, 5))
    full = ref.sketch_join_moments_batched(*args)
    lean = ref.sketch_join_moments_batched(*args, with_aligned=False)
    assert lean[1] is None and lean[2] is None
    torch.testing.assert_close(lean[0], full[0], rtol=0, atol=0)


@pytest.mark.parametrize("kind,tol", [("spearman", 1e-6), ("rin", 2e-5)])
def test_rank_moments_twin_matches_reference(rng, jx, kind, tol):
    """Twin == `ref.rank_moments` (tests/test_rank_moments.py: 1e-6
    spearman, 2e-5 rin — the same f64 rankit table on both sides)."""
    a, b, mask = _rank_inputs(rng, 12, 64)
    got = ref.rank_moments(*(torch.from_numpy(x) for x in (a, b, mask)),
                           kind=kind)
    want = jx.ref.rank_moments(*(jx.jnp.asarray(x) for x in (a, b, mask)),
                               kind=kind)
    _close(got, want, tol)


def test_rank_moments_twin_matches_pallas_interpret(rng, jx):
    """Spearman twin == the Pallas kernel body at 1e-6. (The body's rin
    epilogue does not run under this interpreter: its in-register ``ndtri``
    captures constants, which ``pallas_call`` refuses; rin is held against
    the reference's table above.)"""
    a, b, mask = _rank_inputs(rng, 9, 32)
    got = ref.rank_moments(*(torch.from_numpy(x) for x in (a, b, mask)))
    want = jx.ops.rank_moments(*(jx.jnp.asarray(x) for x in (a, b, mask)),
                               "spearman", jx.interp)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("kind,tol", [("spearman", 1e-6), ("rin", 2e-5)])
@pytest.mark.parametrize("n", [16, 64])
def test_rank_moments_twin_signed_zeros_and_ties(rng, jx, kind, tol, n):
    """Twin == `ref.rank_moments` where −0.0 and +0.0 tie and whole rows
    are equal (the kernel ranks by sorted keys, which must tie them too)."""
    a, b, mask = _zero_rows(rng, 12, n)
    got = ref.rank_moments(*(torch.from_numpy(x) for x in (a, b, mask)),
                           kind=kind)
    want = jx.ref.rank_moments(*(jx.jnp.asarray(x) for x in (a, b, mask)),
                               kind=kind)
    _close(got, want, tol)


@pytest.mark.parametrize("case,R,n", [("random", 6, 16), ("m2m3", 8, 16),
                                      ("ties", 6, 16), ("full", 4, 64),
                                      ("mixed", 8, 64)])
def test_qn_twin_matches_reference_and_pallas(rng, jx, case, R, n):
    """Twin == `ref.qn_correlation` and the Pallas body at 5e-5
    (tests/test_rank_moments.py), degenerate and edge rows included."""
    a, b, mask = _qn_inputs(rng, case, R, n)
    got = ref.qn_correlation(*(torch.from_numpy(x) for x in (a, b, mask)))
    args = [jx.jnp.asarray(x) for x in (a, b, mask)]
    _close(got, jx.ref.qn_correlation(*args), 5e-5)
    _close(got, jx.ops.qn_correlation(*args, jx.interp), 5e-5)
    if case in ("random", "mixed"):
        assert got[0] == 0 and got[1] == 0   # no valid pair → r = 0
    if case == "ties":
        assert (got == 0).all()              # a tied scale is 0 → r = 0
    if case == "mixed":
        assert (got[0::2] == 0).all()


@pytest.mark.parametrize("R,n,ties", [(8, 64, False), (16, 256, True),
                                      (4, 512, True), (8, 1, False),
                                      (8, 7, True)])
def test_rank_transform_twin_matches_reference_and_pallas(rng, jx, R, n, ties):
    """Twin == `ref.rank_transform` and the Pallas kernel (interpret mode)
    bit for bit, at tests/test_kernels.py's shapes plus NaNs and edge
    widths: with 0/1 masks every rank is an exact half-integer."""
    x, mask = _transform_inputs(rng, R, n, ties)
    got = ref.rank_transform(torch.from_numpy(x), torch.from_numpy(mask))
    args = [jx.jnp.asarray(x), jx.jnp.asarray(mask)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jx.ref.rank_transform(*args)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jx.ops.rank_transform(*args, jx.interp)))
    assert (got[1] == 0).all()


def test_rank_transform_twin_matches_blocked_pallas(rng, jx):
    """The Pallas kernel's blocked column sweep (block_n < n) gives the
    same ranks as the twin."""
    from repro.kernels import rank_transform as JRT
    x, mask = _transform_inputs(rng, 8, 128)
    got = ref.rank_transform(torch.from_numpy(x), torch.from_numpy(mask))
    want = JRT.rank_transform(jx.jnp.asarray(x), jx.jnp.asarray(mask),
                              block_r=2, block_n=32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rank_transform_twin_fractional_weights(rng, jx):
    """With fractional weights the twin is the reference's weighted rank
    to float32 rounding."""
    x, _ = _transform_inputs(rng, 6, 96)
    w = rng.uniform(0.0, 1.0, size=x.shape).astype(np.float32)
    w[2, ::3] = 0.0
    got = ref.rank_transform(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, jx.ref.rank_transform(jx.jnp.asarray(x), jx.jnp.asarray(w)), 1e-5)


def test_moment_statistics_match_reference(rng, jx):
    """pearson_from_moments and hoeffding_from_moments == the reference on
    the same moments (degenerate m < 2 rows included)."""
    inp = _join_inputs(rng, 2, 64, 64, 8)
    mom, _, _ = ref.sketch_join_moments_batched(*_torch_join_args(*inp))
    lo_c = torch.from_numpy(rng.uniform(-3, -1, size=(2, 8)).astype(np.float32))
    hi_c = torch.from_numpy(rng.uniform(1, 3, size=(2, 8)).astype(np.float32))
    jmom = jx.jnp.asarray(mom.numpy())
    _close(ref.pearson_from_moments(mom), jx.ref.pearson_from_moments(jmom), 1e-6)
    for alpha in (0.05, 0.2):
        lo, hi = ref.hoeffding_from_moments(mom, lo_c, hi_c, alpha=alpha)
        jlo, jhi = jx.ref.hoeffding_from_moments(
            jmom, jx.jnp.asarray(lo_c.numpy()), jx.jnp.asarray(hi_c.numpy()),
            alpha=jx.jnp.float32(alpha))
        _close(lo, jlo, 1e-5)
        _close(hi, jhi, 1e-5)


def test_ops_route_cpu_tensors_to_twins(rng):
    """CPU tensors take the twin: no kernel launch is counted."""
    ops.reset_launches()
    a, b, mask = (torch.from_numpy(x) for x in _rank_inputs(rng, 6, 16))
    out = ops.rank_moments(a.reshape(2, 3, 16), b.reshape(2, 3, 16),
                           mask.reshape(2, 3, 16))
    assert out.shape == (2, 3, 6)
    torch.testing.assert_close(out.reshape(6, 6), ref.rank_moments(a, b, mask))
    assert ops.qn_correlation(a, b, mask).shape == (6,)
    ranks = ops.rank_transform(a.reshape(2, 3, 16), mask.reshape(2, 3, 16) > 0)
    torch.testing.assert_close(ranks.reshape(6, 16), ref.rank_transform(a, mask),
                               rtol=0, atol=0)
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(rng, 1, 4, 2, 5, 9, 32))
    torch.testing.assert_close(ops.flash_attention(q, k, v, window=3),
                               ref.flash_attention(q, k, v, window=3), rtol=0, atol=0)
    assert ops.launches() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)


@pytest.mark.parametrize("nq,n,C", [(64, 64, 8), (100, 96, 13)])
def test_single_query_twins_match_reference(rng, jx, nq, n, C):
    """The single-query entries (`ops.sketch_join_moments`,
    `ops.containment_hits`, the reference's Pallas kernels' own form) on
    CPU tensors: the twin at B = 1, equal to the reference's single-query
    oracle at 1e-5 (hits exactly), to the batched twin's row bit for bit,
    and launching nothing. `KernelConfig` picks no path."""
    qk, qv, qm, ck, cv, cm = _join_inputs(rng, 3, nq, n, C)
    bq, bv, bm, tk, tv, tm = _torch_join_args(qk, qv, qm, ck, cv, cm)
    ops.reset_launches()
    batch = ref.sketch_join_moments_batched(bq, bv, bm, tk, tv, tm)
    hits_b = ref.containment_hits_batched(bq, bm, tk, tm)
    for row in range(3):
        for cfg in (ops.KernelConfig(), ops.KernelConfig("pallas"),
                    ops.KernelConfig("interpret")):
            got = ops.sketch_join_moments(bq[row], bv[row], bm[row], tk, tv,
                                          tm, cfg)
            for g, w in zip(got, batch):
                torch.testing.assert_close(g, w[row], rtol=0, atol=0)
            torch.testing.assert_close(
                ops.containment_hits(bq[row], bm[row], tk, tm, cfg),
                hits_b[row], rtol=0, atol=0)
        want = jx.ref.sketch_join_moments(*[jx.jnp.asarray(x) for x in (
            qk[row], qv[row], qm[row], ck, cv, cm)])
        for g, w in zip(ref.sketch_join_moments(bq[row], bv[row], bm[row], tk,
                                                tv, tm), want):
            _close(g, w, 1e-5)
        np.testing.assert_array_equal(
            ref.containment_hits(bq[row], bm[row], tk, tm).numpy(),
            np.asarray(jx.ref.containment_hits(*[jx.jnp.asarray(x) for x in (
                qk[row], qm[row], ck, cm)])))
    assert batch[2][0].sum() > 0   # the planted overlap matched
    assert ops.launches() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    assert [ops.KernelConfig(b).use_pallas for b in ("xla", "pallas", "interpret")] \
        == [False, True, True]
    assert ops.default_backend() in ("xla", "pallas")


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    """A wrapper never falls back: given CPU tensors it raises."""
    args = _torch_join_args(*_join_inputs(rng, 1, 16, 16, 4))
    with pytest.raises(ValueError):
        SJ.sketch_join_moments_batched(*args)
    a, b, mask = (torch.from_numpy(x) for x in _rank_inputs(rng, 4, 8))
    with pytest.raises(ValueError):
        RT.rank_moments(a, b, mask)
    with pytest.raises(ValueError):
        RT.qn_correlation(a, b, mask)
    with pytest.raises(ValueError):
        RT.rank_transform(a, mask)


def test_hash_build_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        HB.hash_build(torch.zeros(8, dtype=torch.int32))


def test_flash_attention_wrapper_refuses_cpu_tensors(rng):
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(rng, 1, 4, 2, 8, 8, 64))
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, v)


def _flash_inputs(rng, B, Hq, Hkv, Lq, Lk, D):
    q = rng.normal(size=(B, Hq, Lq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Lk, D)).astype(np.float32)
    return q, k, v


#: the JAX package's sweep (tests/test_kernels.py), with its tolerances:
#: 2e-3 in float32, 2e-2 in bfloat16
FLASH_SWEEP = [
    (2, 4, 2, 256, 256, 64, True, 0, "float32"),
    (1, 8, 8, 128, 128, 32, True, 64, "float32"),
    (1, 4, 1, 128, 512, 64, True, 0, "float32"),     # GQA + decode-ish
    (2, 2, 2, 256, 256, 128, False, 0, "float32"),
    (1, 4, 2, 256, 256, 64, True, 0, "bfloat16"),
]


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,window,dtype", FLASH_SWEEP)
def test_flash_attention_twin_matches_reference_and_pallas(
        rng, jx, B, Hq, Hkv, Lq, Lk, D, causal, window, dtype):
    arrays = _flash_inputs(rng, B, Hq, Hkv, Lq, Lk, D)
    jargs = [jx.jnp.asarray(x).astype(dtype) for x in arrays]
    got = ref.flash_attention(*(torch.from_numpy(x).to(getattr(torch, dtype))
                                for x in arrays), causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    f32 = lambda x: np.asarray(x, np.float32)
    _close(got.float(), f32(jx.ref.flash_attention(*jargs, causal=causal, window=window)), tol)
    _close(got.float(), f32(jx.ops.flash_attention(*jargs, causal=causal, window=window,
                                                   cfg=jx.interp)), tol)


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,window", [
    (2, 4, 2, 37, 37, 32, True, 0),       # ragged tails
    (1, 6, 2, 1, 77, 64, False, 0),       # one decode query over a ragged cache
    (2, 4, 4, 40, 24, 32, True, 0),       # Lq > Lk: the first 16 rows see no key
    (1, 4, 2, 37, 37, 32, True, 5),       # a window inside the tile
    (1, 6, 3, 5, 70, 64, True, 16),       # window + right-aligned queries
    (1, 2, 1, 9, 30, 32, False, 4),       # window without the causal mask
    (1, 8, 2, 1, 129, 64, False, 0),      # decode, group 4, keys not a tile multiple
    (2, 4, 1, 1, 257, 32, True, 0),       # the same, causal
    (1, 4, 2, 2, 40, 32, True, 8),        # two right-aligned queries, window 8
])
def test_flash_attention_twin_ragged_and_masked(rng, jx, B, Hq, Hkv, Lq, Lk, D,
                                                causal, window):
    arrays = _flash_inputs(rng, B, Hq, Hkv, Lq, Lk, D)
    got = ref.flash_attention(*(torch.from_numpy(x) for x in arrays),
                              causal=causal, window=window)
    want = jx.ref.flash_attention(*(jx.jnp.asarray(x) for x in arrays),
                                  causal=causal, window=window)
    _close(got, want, 2e-3)
    assert torch.isfinite(got).all()
    if causal and Lq > Lk:
        assert (got[:, :, :Lq - Lk] == 0).all()
    # a bf16 cache: the same numbers as an upcast copy
    kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays[1:])
    q = torch.from_numpy(arrays[0])
    torch.testing.assert_close(
        ref.flash_attention(q, kb, vb, causal=causal, window=window),
        ref.flash_attention(q, kb.float(), vb.float(), causal=causal, window=window),
        rtol=0, atol=0)


@pytest.mark.parametrize("B,Hkv,Lq,Lk,window,sms", [
    (4, 4, 1, 2048, 0, 132),      # the LM path's decode: 32 splits of 64 keys
    (4, 4, 1, 2017, 0, 132),      # a ragged cache
    (2, 5, 1, 2048, 1024, 132),   # hymba's decode with a window: keys 1024-2047
    (1, 1, 1, 1, 0, 132),         # one key
    (1, 4, 7, 0, 0, 132),         # no key at all: one empty split
    (64, 8, 1, 4100, 0, 132),     # a wide batch: splits of several tiles
    (2, 4, 3, 300, 16, 132),      # right-aligned rows with a window: keys 282-299
])
def test_flash_split_plan_covers_the_visible_keys(B, Hkv, Lq, Lk, window, sms):
    """The split-key kernel's plan: whole 64-key tiles that cover exactly
    the keys some row may see, in enough blocks to fill the card twice
    when there are keys enough."""
    splits, per, key0 = FA.split_plan(B, Hkv, Lq, Lk, window, sms)
    first = max(0, Lk - Lq - window + 1) if window > 0 else 0
    assert key0 == first and splits >= 1 and per % FA.SPLIT_TILE == 0
    assert key0 + (splits - 1) * per < max(Lk, 1) <= key0 + splits * per or Lk == key0
    tiles = -(-(Lk - key0) // FA.SPLIT_TILE)
    assert B * Hkv * splits >= min(2 * sms, B * Hkv * max(tiles, 1))
    if (B, Hkv, Lk) == (4, 4, 2048):
        assert (splits, per) == (32, 64)


@pytest.mark.parametrize("B,nq,n", [(1, 64, 64), (32, 256, 256), (33, 256, 256),
                                    (40, 33, 17), (300, 256, 256), (2, 64, 2048)])
@pytest.mark.parametrize("C,sms", [(131072, 132), (16384, 132), (1000, 132), (7, 78)])
def test_containment_plan_covers_rows_and_fits(B, nq, n, C, sms):
    """The containment kernel's plan: its passes cover every query row
    once, a block's table and tile fit the card's shared memory, the table
    is at most half full, and no block is launched without a tile."""
    p = CT.plan(B, nq, C, sms)
    starts = range(0, p.passes * p.rows, p.rows)
    held = [min(p.rows, B - s) for s in starts]
    assert min(held) >= 1 and sum(held) == B
    assert 1 <= p.rows <= CT.MAX_ROWS
    assert p.smem == 12 * 2 ** p.tbits + 4 * p.rows * p.tile <= CT.SMEM_MAX
    assert p.rows * nq <= 2 ** p.tbits // 2
    assert CT.MIN_TILE <= p.tile <= CT.TILE
    assert 1 <= p.grid_x <= min(sms, -(-C // p.tile))
    if (B, nq, C) == (32, 256, 131072):
        assert (p.passes, p.tbits, p.grid_x) == (1, 14, sms)


# ----------------------------------------------------------------------------
# CUDA kernels against their twins, on the card
# ----------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("B,nq,n,C,dup", [
    (1, 64, 64, 8, False), (3, 100, 96, 13, False), (2, 64, SJ.MAX_N, 4, False),
    # the scan's buckets at the engine's sketch size: 1, 8 and 32 queries
    (1, 256, 256, 4096, False), (8, 256, 256, 512, False), (32, 256, 256, 128, False),
    (3, 64, 1, 9, False),          # one slot a candidate
    (4, 256, 256, 16, True),       # candidates with repeated valid keys
])
def test_cuda_sketch_join_matches_twin(rng, cuda, B, nq, n, C, dup):
    """1e-5 against the twin; a moments-only launch's moments equal a full
    launch's bit for bit. With ``dup``, query 0's slot 4 matches five
    valid slots of candidate 0 and slot 5 two of candidate 3: equal keys
    sum."""
    inp = _join_inputs(rng, B, nq, n, C)
    if dup:
        qk, _, qm, ck, _, cm = inp
        ck[0, 5:9] = ck[0, 4] = qk[0, 4]
        ck[3, [0, 7]] = qk[0, 5]
        qm[0, 4:6] = cm[0, 4:9] = cm[3, [0, 7]] = 1.0
    args = _torch_join_args(*inp, device=cuda)
    before = SJ.sketch_join_moments_batched.launches
    got = SJ.sketch_join_moments_batched(*args)
    lean = SJ.sketch_join_moments_batched(*args, with_aligned=False)
    torch.cuda.synchronize()
    assert SJ.sketch_join_moments_batched.launches == before + 2
    want = ref.sketch_join_moments_batched(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lean[0], got[0], rtol=0, atol=0)
    if dup:
        assert int(got[2][0, 0, 4]) == 1 and int(got[2][0, 3, 5]) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind,tol", [("spearman", 1e-6), ("rin", 2e-5)])
@pytest.mark.parametrize("R,n", [(12, 64), (40, 256), (7, 100), (3, RT.MAX_N)])
def test_cuda_rank_moments_matches_twin(rng, cuda, kind, tol, R, n):
    a, b, mask = (torch.from_numpy(x).to(cuda) for x in _rank_inputs(rng, R, n))
    got = RT.rank_moments(a, b, mask, kind)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.rank_moments(a, b, mask, kind),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,tol", [("spearman", 1e-6), ("rin", 2e-5)])
@pytest.mark.parametrize("case,R,n", [("bucket", 4096, 256), ("zeros", 40, 256),
                                      ("random", 24, 512), ("random", 24, 1000),
                                      ("mixed", 12, RT.MAX_N), ("zeros", 8, RT.MAX_N)])
def test_cuda_rank_moments_bucket_and_wide_rows(rng, cuda, kind, tol, case, R, n):
    """The kernel against its twin (1e-6 spearman, 2e-5 rin), one launch a
    call: "bucket" is the scan's shape, 4096 rows of which a quarter join
    in runs of 32; "zeros" rows where −0.0 and +0.0 tie and whole rows are
    equal; n > 256 takes two, four or eight warps a group."""
    if case == "bucket":
        a, b, mask = _rank_inputs(rng, R, n)
        mask[(np.arange(R) // 32) % 4 != 0] = 0.0
    elif case == "zeros":
        a, b, mask = _zero_rows(rng, R, n)
    else:
        a, b, mask = _qn_inputs(rng, case, R, n)
    a, b, mask = (torch.from_numpy(x).to(cuda) for x in (a, b, mask))
    before = RT.rank_moments.launches
    got = RT.rank_moments(a, b, mask, kind)
    torch.cuda.synchronize()
    assert RT.rank_moments.launches == before + 1
    torch.testing.assert_close(got, ref.rank_moments(a, b, mask, kind),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case,R,n", [
    ("random", 12, 64), ("random", 40, 256), ("random", 7, 100),
    ("random", 3, RT.MAX_N), ("m2m3", 16, 256), ("ties", 12, 256),
    ("full", 8, 256), ("mixed", 24, 256), ("random", 9, 257),
    ("mixed", 12, 257), ("full", 4, 512), ("random", 5, 600), ("mixed", 12, 1000),
    ("m2m3", 8, RT.MAX_N), ("full", 4, RT.MAX_N), ("mixed", 12, RT.MAX_N)])
def test_cuda_qn_matches_twin(rng, cuda, case, R, n):
    """Within 5e-5 of the twin (the kernel computes its order statistics
    bit for bit); n > 256 takes two, four or eight warps a scale."""
    a, b, mask = (torch.from_numpy(x).to(cuda) for x in _qn_inputs(rng, case, R, n))
    before = RT.qn_correlation.launches
    got = RT.qn_correlation(a, b, mask)
    torch.cuda.synchronize()
    assert RT.qn_correlation.launches == before + 1
    torch.testing.assert_close(got, ref.qn_correlation(a, b, mask),
                               rtol=5e-5, atol=5e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("R,n", [(12, 1), (12, 7), (64, 256), (7, 257),
                                 (3, 2049), (2, 4100)])
def test_cuda_rank_transform_matches_twin(rng, cuda, R, n):
    """0/1 masks: equal to the twin bit for bit (ties, NaNs, a masked
    row); fractional weights: within 1e-5; leading axes through ops."""
    x, mask = (torch.from_numpy(v).to(cuda) for v in _transform_inputs(rng, R, n))
    got = RT.rank_transform(x, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.rank_transform(x, mask))
    w = torch.from_numpy(rng.uniform(0, 1, size=(R, n)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(RT.rank_transform(x, w), ref.rank_transform(x, w),
                               rtol=1e-5, atol=1e-5)
    wide = torch.stack([x, x.flip(0)], dim=1)      # [R, 2, n], then a view
    got = ops.rank_transform(wide[:, 1], torch.stack([mask, mask.flip(0)], 1)[:, 1])
    assert torch.equal(got, ref.rank_transform(x.flip(0), mask.flip(0)))


def _containment_inputs(rng, B, nq, n, C, universe):
    """Keys from a universe of ``universe`` values: small ones make keys
    repeat within a sketch (every equal valid pair counts)."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    qk = rng.integers(0, universe, size=(B, nq)).astype(np.uint32)
    ck = rng.integers(0, universe, size=(C, n)).astype(np.uint32)
    qm = (rng.random((B, nq)) < 0.8).astype(np.float32)
    cm = (rng.random((C, n)) < 0.8).astype(np.float32)
    return t(qk.view(np.int32)), t(qm), t(ck.view(np.int32)), t(cm)


@pytest.mark.gpu
@pytest.mark.parametrize("nq,n,C", [(64, 64, 8), (256, 256, 512), (100, 96, 13)])
def test_cuda_single_query_sketch_join_matches_twin(rng, cuda, nq, n, C):
    """`ops.sketch_join_moments` on a ``[nq]`` query: one launch of the
    kernel at B = 1, within 1e-5 of the single-query twin, and bit for bit
    that query's row of a batched launch."""
    args = _torch_join_args(*_join_inputs(rng, 4, nq, n, C), device=cuda)
    batch = SJ.sketch_join_moments_batched(*args)
    for row in range(4):
        one = [a[row] for a in args[:3]] + list(args[3:])
        before = SJ.sketch_join_moments_batched.launches
        got = ops.sketch_join_moments(*one)
        torch.cuda.synchronize()
        assert SJ.sketch_join_moments_batched.launches == before + 1
        for g, w, b in zip(got, ref.sketch_join_moments(*one), batch):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(g, b[row], rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("nq,n,C,universe", [(64, 64, 8, 300),
                                             (256, 256, 4096, 1 << 20)])
def test_cuda_single_query_containment_matches_twin(rng, cuda, nq, n, C, universe):
    """`ops.containment_hits` on a ``[nq]`` query: one launch at B = 1,
    exactly the single-query twin and that query's row of a batch."""
    args = [x.to(cuda) for x in _containment_inputs(rng, 3, nq, n, C, universe)]
    batch = CT.containment_hits_batched(*args)
    for row in range(3):
        one = (args[0][row], args[1][row], args[2], args[3])
        before = CT.containment_hits_batched.launches
        got = ops.containment_hits(*one)
        torch.cuda.synchronize()
        assert CT.containment_hits_batched.launches == before + 1
        torch.testing.assert_close(got, ref.containment_hits(*one), rtol=0, atol=0)
        torch.testing.assert_close(got, batch[row], rtol=0, atol=0)
    assert batch.sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("B,nq,n,C,universe", [
    (1, 64, 64, 8, 300), (3, 100, 96, 13, 100), (32, 256, 256, 4096, 1 << 20),
    (2, 64, CT.MAX_N, 4, 3000), (40, 33, 17, 1000, 200)])
def test_cuda_containment_matches_twin(rng, cuda, B, nq, n, C, universe):
    """Exact: counts are integers."""
    args = [x.to(cuda) for x in _containment_inputs(rng, B, nq, n, C,
                                                     universe)]
    before = CT.containment_hits_batched.launches
    got = CT.containment_hits_batched(*args)
    torch.cuda.synchronize()
    assert CT.containment_hits_batched.launches == before + 1
    assert got.sum() > 0
    torch.testing.assert_close(got, ref.containment_hits_batched(*args),
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,nq,n,C,universe", [
    (33, 256, 256, 3000, 1 << 16),   # two passes of rows
    (300, 256, 256, 700, 1 << 16),   # ten passes
    (3, 64, CT.MAX_N, 200, 3000),    # the widest candidates
    (5, 128, 128, 40, 50),           # C below the SM count; keys repeat on both sides
    (7, 33, 30, 9, 12)])             # n % 4 != 0: scalar loads
def test_cuda_containment_passes_and_edge_keys(rng, cuda, B, nq, n, C, universe):
    """Exactly the twin, one launch a call, with the key 0xFFFFFFFF valid
    and repeated in query 0 and candidate 0 (4 × 3 pairs), key 0 valid,
    and small universes repeating keys inside rows and candidates."""
    qk, qm, ck, cm = (x.numpy().copy() for x in _containment_inputs(rng, B, nq, n, C,
                                                                     universe))
    qk[0, :4] = ck[0, :3] = -1          # 0xFFFFFFFF as an int32 pattern
    qk[-1, -2:] = ck[-1, :2] = 0
    qm[0, :4] = cm[0, :3] = qm[-1, -2:] = cm[-1, :2] = 1.0
    args = [torch.from_numpy(x).to(cuda) for x in (qk, qm, ck, cm)]
    before = CT.containment_hits_batched.launches
    got = CT.containment_hits_batched(*args)
    torch.cuda.synchronize()
    assert CT.containment_hits_batched.launches == before + 1
    want = ref.containment_hits_batched(*args)
    assert torch.equal(got, want)
    assert int(got[0, 0]) >= 12 and int(got[-1, -1]) >= 4


def _window_ids(rng, B, L, ids, empty=0.5):
    cand = rng.integers(0, ids, size=(B, L)).astype(np.int32)
    cand[rng.random((B, L)) < empty] = -1
    return torch.from_numpy(cand)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,ids,C,edge", [
    (1, 64, 12, 12, None), (7, 192, 40, 40, None), (32, 8192, 4096, 4096, None),
    (4, 20000, 5000, 5000, None), (2, 2048 * 64, 70000, 70000, None), (3, 1, 3, 3, None),
    (32, 256 * 128, 131072, 131072, None),  # the inverted source's rows: n·W at C
    (4, 300, 1, 1, None),                   # C = 1
    (5, 1000, 45, 45, "top"),               # C not a multiple of 32, id C − 1
    (6, 4096, 200, 200, "empty"),           # a row of −1 only
    (3, 5000, 300, 300, "repeat"),          # one id repeated L times
    (2, 131072, 1 << 22, 1 << 22, "top")])  # 512 KB a row: many compaction tiles
def test_cuda_postings_merge_matches_twin(rng, cuda, B, L, ids, C, edge):
    """Bit-equal: the kernel writes the twin's layout (ids ascending at the
    front, then (−1, 0)), ids in [0, C)."""
    cand = _window_ids(rng, B, L, ids)
    if edge == "top":
        cand[0, :3] = C - 1
    elif edge == "empty":
        cand[1] = -1
    elif edge == "repeat":
        cand[2] = ids - 1
    cand = cand.to(cuda)
    before = PM.postings_merge.launches
    got = PM.postings_merge(cand, C)
    torch.cuda.synchronize()
    assert PM.postings_merge.launches == before + 1
    want = ref.postings_merge(cand, C)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if edge == "repeat":
        assert int(got[0][2, 0]) == ids - 1 and float(got[1][2, 0]) == L


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,M,floor,C,top", [
    (1, 64, 8, 1.0, 40, False), (4, 128, 32, 2.0, 40, False),
    (7, 192, 64, 0.0, 40, False), (2, 64, 256, 3.0, 40, False),
    (3, 128, 16, 1e9, 40, False), (32, 8192, 1024, 3.0, 131072, False),
    (32, 8192, 64, 3.0, 131072, False),
    (4, 128, 32, 2.0, 45, True),            # C not a multiple of 32
    (2, 64, 8, 1.0, 1, True),               # C = 1
    (32, 8192, 1024, 3.0, 131071, True),
    (8, 8192, 4096, 1.0, 1 << 22, True)])   # 32 tiles of the compaction
def test_cuda_postings_select_matches_twin(rng, cuda, B, L, M, floor, C, top):
    """Bit-equal surv, valid and n_surv: overflow (n_surv > M), M > B·L,
    floor 0 and an empty selection included. Rows are merge outputs; with
    ``top`` ids are drawn from all of [0, C) and C − 1 is eligible."""
    ids = C if top else min(C, 4 * L)
    cols, counts = ref.postings_merge(_window_ids(rng, B, L, ids), C)
    counts = torch.where(cols >= 0, torch.from_numpy(
        rng.integers(1, 5, size=(B, L)).astype(np.float32)), 0.0)
    if top:
        cols[0] = torch.where(cols[0] == C - 1, -1, cols[0])
        cols[0, 0], counts[0, 0] = C - 1, 4.0
    cols, counts = cols.to(cuda), counts.to(cuda)
    before = PM.postings_select.launches
    got = PM.postings_select(cols, counts, floor, M, C)
    torch.cuda.synchronize()
    assert PM.postings_select.launches == before + 1
    for g, w in zip(got, ref.postings_select(cols, counts, floor, M)):
        assert torch.equal(g, w)


def _edge_keys():
    """0, 2³² − 1, the key hashing onto the key-space sentinel, and the key
    whose Fibonacci value is the Fibonacci-space sentinel (murmur3 is a
    bijection on 32-bit keys, so each preimage is unique)."""
    from repro_torch.core import hashing as TH
    M = 1 << 32
    inv = lambda x: pow(int(x), -1, M)
    rotr = lambda x, r: ((x >> r) | (x << (32 - r))) & (M - 1)
    unxs = lambda y, s: y ^ (y >> s) ^ ((y >> s) >> s)

    def preimage(target):
        h = unxs(target, 16)
        h = unxs((h * inv(0xC2B2AE35)) % M, 13)
        h = unxs((h * inv(0x85EBCA6B)) % M, 16) ^ 4
        h = ((h - 0xE6546B64) * inv(5)) % M
        k = (rotr(h, 13) ^ TH.DEFAULT_SEED) * inv(0x1B873593) % M
        return rotr(k, 15) * inv(0xCC9E2D51) % M

    fib_star = (TH.SENTINEL_HASH * inv(TH.FIBONACCI_MULTIPLIER)) % M
    return np.array([0, 0xFFFFFFFF, preimage(TH.SENTINEL_HASH),
                     preimage(fib_star)], np.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", [
    ((1,), 0), ((3,), 0), ((4,), 0), ((4093,), 0), ((4093,), 1),
    ((512, 1024), 0), (((1 << 22) + 3,), 0)])
def test_cuda_hash_build_matches_twin(rng, cuda, shape, offset):
    """Bit-equal h, fib and unit, edge keys included; ``offset`` starts the
    keys 4 bytes into an allocation, which takes the unaligned path."""
    m = int(np.prod(shape))
    keys = rng.integers(0, 1 << 32, size=m + offset,
                        dtype=np.uint64).astype(np.uint32)
    keys[offset:offset + min(m, 4)] = _edge_keys()[:min(m, 4)]
    t = torch.from_numpy(keys.view(np.int32)).to(cuda)[offset:]
    t = t.reshape(shape)
    before = HB.hash_build.launches
    got = HB.hash_build(t)
    torch.cuda.synchronize()
    assert HB.hash_build.launches == before + 1
    for g, w in zip(got, ref.hash_build(t)):
        assert g.shape == t.shape and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,window,qdt,kvdt", [
    (B, Hq, Hkv, Lq, Lk, D, c, w, dt, dt) for B, Hq, Hkv, Lq, Lk, D, c, w, dt in FLASH_SWEEP
] + [
    (4, 32, 4, 1, 2048, 64, False, 0, "float32", "bfloat16"),   # decode on a bf16 cache
    (2, 32, 4, 300, 300, 64, True, 0, "float32", "float32"),    # tinyllama's heads
    (1, 25, 5, 520, 520, 64, True, 128, "float32", "float32"),  # hymba's heads, a window
    (2, 4, 2, 37, 37, 32, True, 0, "float32", "float32"),
    (1, 6, 2, 1, 77, 64, False, 0, "float32", "float32"),
    (2, 4, 4, 40, 24, 32, True, 0, "float32", "float32"),
    (1, 6, 3, 5, 70, 96, True, 16, "float32", "float32"),
    (1, 4, 2, 130, 200, 128, True, 0, "bfloat16", "float32"),
    (1, 4, 2, 7, 0, 64, True, 0, "float32", "float32"),         # no keys at all
] + [
    # the split-key path: one query over a cache, group 1 and group 8
    (2, Hq, Hkv, 1, Lk, 64, False, 0, "float32", kvdt)
    for Lk in (1, 63, 65, 2017, 2048, 4100) for kvdt in ("float32", "bfloat16")
    for Hq, Hkv in ((4, 4), (32, 4))
] + [
    (2, 16, 4, 2, 300, 64, True, 0, "float32", "bfloat16"),   # 2-4 positions, causal
    (1, 16, 4, 3, 97, 128, True, 0, "float32", "float32"),
    (2, 16, 4, 4, 300, 64, True, 16, "float32", "bfloat16"),  # and a window of 16
    (1, 8, 4, 3, 70, 32, False, 16, "bfloat16", "bfloat16"),
    (1, 4, 2, 7, 3, 64, True, 0, "float32", "float32"),       # Lq > Lk: rows see no key
    (2, 25, 5, 1, 2048, 64, True, 0, "float32", "bfloat16"),  # hymba's heads
    (2, 25, 5, 1, 2048, 64, True, 1024, "float32", "float32"),
    (1, 12, 4, 1, 333, 96, False, 0, "bfloat16", "float32"),
] + [
    # the tensor-core path: a prefill row (group 8, the LM path's length),
    # D = 96 and 128, a ragged Lq, bf16 × bf16 with group 8
    (1, 32, 4, 2016, 2016, 64, True, 0, "float32", "float32"),
    (1, 16, 2, 700, 700, 96, True, 0, "float32", "float32"),
    (2, 8, 1, 513, 513, 128, True, 200, "float32", "float32"),
    (1, 32, 4, 333, 1000, 64, True, 0, "float32", "float32"),
    (1, 32, 4, 260, 260, 64, True, 0, "bfloat16", "bfloat16"),
    (1, 32, 4, 260, 400, 128, False, 0, "float32", "bfloat16"),
])
def test_cuda_flash_attention_matches_twin(rng, cuda, B, Hq, Hkv, Lq, Lk, D,
                                           causal, window, qdt, kvdt):
    """Contiguous [B, H, L, D] tensors and strided views of [B, L, H, D]
    ones: 2e-3 in float32, 2e-2 with a bf16 output; and a float32 output
    within 1e-4 (the tensor-core path's split TF32 keeps float32
    accuracy)."""
    q, k, v = _flash_inputs(rng, B, Hq, Hkv, Lq, Lk, D)
    t = lambda x, dt: torch.from_numpy(x).to(cuda, getattr(torch, dt))
    tol = 2e-2 if qdt == "bfloat16" else 2e-3
    for view in (False, True):
        args = [t(q, qdt), t(k, kvdt), t(v, kvdt)]
        if view:
            args = [a.transpose(1, 2).contiguous().transpose(1, 2) for a in args]
        before = FA.flash_attention.launches
        got = FA.flash_attention(*args, causal=causal, window=window)
        torch.cuda.synchronize()
        assert FA.flash_attention.launches == before + (got.numel() > 0)
        assert got.dtype == args[0].dtype and got.shape == args[0].shape
        want = ref.flash_attention(*args, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        if qdt == "float32" and got.numel():
            assert float((got - want).abs().max()) <= 1e-4
        if causal and Lq > Lk:
            assert bool((got[:, :, :Lq - Lk] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["fused", "loop"])
def test_cuda_build_index_matches_cpu_build(rng, cuda, engine):
    """Tables with repeated keys and NaNs built on the card equal the CPU
    build bit for bit, values included: each key's values are added in row
    order on both (no atomic sums)."""
    from repro_torch.core.sketch import Agg
    from repro_torch.data.pipeline import TableGroup
    from repro_torch.engine import index as TI
    tables = []
    for i in range(6):
        m = int(rng.integers(300, 5000))
        keys = rng.integers(0, m // 3, size=m).astype(np.uint32)
        vals = rng.normal(size=(3, m)).astype(np.float32)
        vals[:, rng.random(m) < 0.05] = np.nan
        tables.append(TableGroup(keys=keys, values=vals, name=f"t{i}"))
    for agg in (Agg.MEAN, Agg.SUM, Agg.LAST):
        card = TI.build_index(tables, n=64, agg=agg, chunk=1024,
                              engine=engine, device=cuda)
        cpu = TI.build_index(tables, n=64, agg=agg, chunk=1024,
                             device="cpu")
        for f in ("key_hash", "values", "mask", "col_min", "col_max",
                  "rows"):
            assert torch.equal(getattr(card.shard, f).cpu(),
                               getattr(cpu.shard, f)), (agg, f)
