"""The inverted candidate source in the port: the postings layout, the
postings-merge and postings-select twins against the JAX package (its
oracles and the Pallas kernel bodies run by the interpreter), the window
probe against the reference's layout, and the inverted hits against the
scan's. (The CUDA kernels against their twins: `tests/test_torch_kernels.py`.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import candidates as JCD
from repro.engine import index as JI
from repro.engine import plans as JPL
from repro.kernels import ops as JK
from repro.kernels import ref as JR
from repro.kernels.ops import KernelConfig
from repro_torch import convert
from repro_torch.engine import candidates as TCD
from repro_torch.engine import index as TI
from repro_torch.engine import plans as TPL
from repro_torch.kernels import ops, ref
from repro_torch.kernels import postings as TP

INTERP = KernelConfig(backend="interpret")


def _cand(rng, B, L, ids, empty=0.5):
    cand = rng.integers(0, ids, size=(B, L)).astype(np.int32)
    cand[rng.random((B, L)) < empty] = -1
    return cand


def _pairs(cols, counts):
    """Per row, the set of (id, count) pairs of a merge output; each live
    id must occupy one slot."""
    out = []
    for c, n in zip(np.asarray(cols), np.asarray(counts)):
        live = c >= 0
        assert len(set(c[live].tolist())) == int(live.sum())
        assert (n[~live] == 0).all()
        out.append({(int(i), float(k)) for i, k in zip(c[live], n[live])})
    return out


def _merged(rng, B, L, ids):
    """A merge-shaped input of postings_select: each live id once a row."""
    cols = _cand(rng, B, L, ids, empty=0.4)
    for i in range(B):
        live = np.flatnonzero(cols[i] >= 0)
        _, first = np.unique(cols[i][live], return_index=True)
        dup = np.ones(live.size, bool)
        dup[first] = False
        cols[i, live[dup]] = -1
    counts = rng.integers(1, 5, size=(B, L)).astype(np.float32)
    counts[cols < 0] = 0.0
    return cols, counts


# ----------------------------------------------------------------------------
# postings merge
# ----------------------------------------------------------------------------

def _merge_matches_reference(cand, C):
    """`ops.postings_merge(cand, C)` on the CPU (the twin) == `ref.
    postings_merge` and the Pallas body as (id, count) sets per row, its
    layout ids ascending at the front; returns the per-row sets."""
    cols, counts = ops.postings_merge(torch.from_numpy(cand), C)
    got = _pairs(cols, counts)
    assert got == _pairs(*JR.postings_merge(jnp.asarray(cand)))
    assert got == _pairs(*JK.postings_merge(jnp.asarray(cand), INTERP))
    for i, row in enumerate(got):
        k = len(row)
        assert cols[i, :k].tolist() == sorted(c for c, _ in row)
        assert (cols[i, k:] == -1).all()
    return got


@pytest.mark.parametrize("B,L,ids", [(1, 64, 12), (4, 256, 12), (7, 192, 40),
                                     (2, 96, 1)])
def test_postings_merge_twin_matches_reference(rng, B, L, ids):
    """Twin == `ref.postings_merge` and the Pallas body, ids in [0, C = ids)."""
    _merge_matches_reference(_cand(rng, B, L, ids), ids)


@pytest.mark.parametrize("B,L,C", [(3, 128, 45), (2, 96, 1), (4, 200, 64), (2, 160, 33)])
def test_postings_merge_edges_match_reference(rng, B, L, C):
    """Ids that reach C − 1 (C not a multiple of 32, C = 1, C = 32·k + 1),
    a row of −1 only and a row of one id repeated L times: the twin ==
    the JAX reference and the Pallas body."""
    cand = _cand(rng, B, L, C)
    cand[0, :2] = C - 1
    cand[1] = -1
    if B > 2:
        cand[2] = C // 2
    got = _merge_matches_reference(cand, C)
    assert (C - 1, float((cand[0] == C - 1).sum())) in got[0]
    assert got[1] == set()
    if B > 2:
        assert got[2] == {(C // 2, float(L))}


def test_postings_merge_twin_refuses_ids_past_C(rng):
    """The twin checks the bound the kernel's bitmap relies on."""
    cand = torch.from_numpy(_cand(rng, 2, 64, 10))
    cand[1, 5] = 10
    with pytest.raises(ValueError):
        ref.postings_merge(cand, 10)
    with pytest.raises(ValueError):
        ops.postings_merge(cand, 10)
    assert ref.postings_merge(cand, 11)[1].sum() == (cand >= 0).sum()


# ----------------------------------------------------------------------------
# postings select
# ----------------------------------------------------------------------------

def _select_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("B,L,M,floor,C,top", [
    (1, 64, 8, 1.0, 40, False),      # overflow: more distinct ids than M
    (4, 128, 32, 2.0, 40, False),
    (7, 192, 64, 0.0, 40, False),    # floor 0: every live id survives
    (2, 64, 256, 3.0, 40, False),    # M > N = B·L
    (3, 128, 16, 1e9, 40, False),    # nothing eligible
    (4, 128, 64, 2.0, 45, True),     # C not a multiple of 32, C − 1 eligible
    (3, 64, 8, 1.0, 1, True),        # C = 1: every live id is 0
])
def test_postings_select_twin_matches_reference(rng, B, L, M, floor, C, top):
    """Twin == `ref.postings_select` and the Pallas body, bit for bit, ids
    in [0, C); with ``top`` the id C − 1 is eligible in row 0."""
    cols, counts = _merged(rng, B, L, C)
    if top:
        cols[0, cols[0] == C - 1] = -1
        cols[0, 0], counts[0, 0] = C - 1, 4.0
    got = ref.postings_select(torch.from_numpy(cols),
                              torch.from_numpy(counts), floor, M)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    jargs = (jnp.asarray(cols), jnp.asarray(counts), jnp.float32(floor), M)
    _select_equal(got, JR.postings_select(*jargs))
    _select_equal(got, JK.postings_select(*jargs, INTERP))
    if top:
        assert C - 1 in got[0][got[1]].tolist()


def test_postings_select_union_across_rows():
    """An id eligible in any row survives (floor 3)."""
    cols = torch.tensor([[3, 7, -1, -1], [3, 9, -1, -1]], dtype=torch.int32)
    counts = torch.tensor([[5.0, 1.0, 0, 0], [1.0, 4.0, 0, 0]])
    surv, valid, n = ops.postings_select(cols, counts, 3.0, 4, 10)
    assert surv.tolist() == [3, 9, 0, 0]
    assert valid.tolist() == [True, True, False, False] and int(n) == 2


def test_select_over_merge_equals_host_selection(rng):
    """Device select over merged rows == host `select_survivors` over their
    dense scatter (`dense_hit_counts`), as in the reference."""
    cand = torch.from_numpy(_cand(rng, 3, 128, 20, empty=0.6))
    mcols, mcnt = ops.postings_merge(cand, 20)
    surv, valid, _ = ops.postings_select(mcols, mcnt, 2.0, 32, 20)
    hits = TCD.dense_hit_counts(mcols.numpy(), mcnt.numpy(), 20)
    np.testing.assert_array_equal(hits, JCD.dense_hit_counts(
        mcols.numpy(), mcnt.numpy(), 20))
    np.testing.assert_array_equal(surv[valid].numpy(),
                                  TPL.select_survivors(hits, "safe", 2))


def test_postings_wrappers_refuse_cpu_tensors(rng):
    cand = torch.from_numpy(_cand(rng, 2, 16, 5))
    with pytest.raises(ValueError):
        TP.postings_merge(cand, 5)
    with pytest.raises(ValueError):
        TP.postings_select(cand, cand.float(), 1.0, 4, 5)


# ----------------------------------------------------------------------------
# the postings layout and the window probe
# ----------------------------------------------------------------------------

def _planes(rng, C=24, n=32, universe=400):
    """Key planes sharing keys across columns (long equal-key runs), with
    masked and PAD slots; keys distinct within a column."""
    kh = np.stack([rng.choice(universe, size=n, replace=False)
                   for _ in range(C)]).astype(np.uint32) * 7919 + 11
    mask = (rng.random((C, n)) < 0.8).astype(np.float32)
    kh[mask == 0] = np.uint32(JI.PAD_KEY)
    kh[0, :3] = np.uint32(JI.PAD_KEY)
    mask[0, :3] = 1.0            # a PAD key under a live mask never posts
    return kh, mask


def _torch_planes(kh, mask):
    return (torch.from_numpy(kh.view(np.int32).copy()),
            torch.from_numpy(mask))


@pytest.mark.parametrize("capacity", [None, 40])
def test_build_postings_matches_reference(rng, capacity):
    """Keys equal the reference's as u32 values; cols are equal too (the
    stable sort keeps column order inside an equal-key run)."""
    kh, mask = _planes(rng)
    want = JI.build_postings(kh, mask, capacity=capacity)
    got = TI.build_postings(*_torch_planes(kh, mask), capacity=capacity)
    assert got.E == want.E and got.used == want.used
    np.testing.assert_array_equal(got.keys.numpy().astype(np.uint32),
                                  want.keys)
    np.testing.assert_array_equal(got.cols.numpy(), want.cols)
    assert got.max_run() == want.max_run() > 1
    assert TCD.window_rung(got.max_run()) == JCD.window_rung(want.max_run())


def test_window_rung_matches_reference():
    for r in (0, 1, 8, 9, 100, 4096):
        assert TCD.window_rung(r) == JCD.window_rung(r)


def test_window_probe_on_reference_postings(rng):
    """The port's window probe over the reference's postings carried by
    `convert.postings_from_reference` gives the reference's merged hits."""
    kh, mask = _planes(rng)
    jp = JI.build_postings(kh, mask)
    W = JCD.window_rung(jp.max_run())
    B, n = 3, 32
    qk = np.stack([kh[i, :n] for i in (1, 5, 9)])
    qk[:, ::3] = np.uint32(5)                 # keys no column holds
    qm = (rng.random((B, n)) < 0.9).astype(np.float32)
    qm[qk == np.uint32(JI.PAD_KEY)] = 0.0     # a sketch never holds PAD live
    want = JCD.dense_hit_counts(*(np.asarray(x) for x in JR.postings_merge(
        JPL._postings_window_candidates(jnp.asarray(qk), jnp.asarray(qm),
                                        jnp.asarray(jp.keys),
                                        jnp.asarray(jp.cols), jp.E, W))),
        kh.shape[0])
    tp = convert.postings_from_reference(jp.keys, jp.cols, jp.used,
                                         device="cpu")
    cand = TPL.postings_window_candidates(
        torch.from_numpy(qk.view(np.int32).copy()), torch.from_numpy(qm),
        tp.keys, tp.cols, W)
    got = TCD.dense_hit_counts(*(x.numpy() for x in ops.postings_merge(cand, kh.shape[0])),
                               kh.shape[0])
    np.testing.assert_array_equal(got, want)
    # and the scan's exact counts over the same planes
    scan = ref.containment_hits_batched(
        torch.from_numpy(qk.view(np.int32).copy()), torch.from_numpy(qm),
        *_torch_planes(kh, mask))
    np.testing.assert_array_equal(got, scan.numpy())


@pytest.mark.parametrize("B", [1, 4])
def test_inverted_hits_equal_scan_hits(rng, B):
    """The two sources' `hit_counts` agree exactly on the port's own
    postings, PAD query slots and non-matching keys included."""
    kh, mask = _torch_planes(*_planes(rng, C=40, n=16))
    shard = TI.IndexShard(key_hash=kh, values=torch.zeros(40, 16), mask=mask,
                          col_min=torch.zeros(40), col_max=torch.zeros(40),
                          rows=torch.zeros(40))
    scan = TCD.ScanSource(shard)
    inv = TCD.InvertedSource(TI.build_postings(shard.key_hash, shard.mask),
                             C=40, n=16)
    rows = [2, 7, 11, 30][:B]
    q_kh = shard.key_hash[rows].clone()
    q_mask = shard.mask[rows].clone()
    q_kh[:, 1] = 5
    q_mask[:, 1] = 1.0
    q_mask[:, -2:] = 0.0
    qa = (q_kh, None, q_mask, None, None)
    got = inv.hit_counts(qa)
    np.testing.assert_array_equal(got, scan.hit_counts(qa))
    assert (got > 0).sum() > B
