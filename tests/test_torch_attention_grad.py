"""The attention gradient of the port: the backward's plain twin
(`ref.flash_attention_bwd`) against ``jax.vjp`` of the JAX package's plain
attention (`repro.kernels.ref.flash_attention`) and against torch autograd
of the forward twin; the `ops.FlashAttention` autograd function on the CPU;
and the hand-written backward kernel against its twin on the card (marked
``gpu``: skips without one).

Tolerances: float32 gradients within 1e-5 of each output's largest
magnitude (the twin and the oracles differ only in summation order, ≈
4e-7 here); on the card, float32 within 1e-5 and bfloat16 within 2e-2 of
the largest magnitude (bf16 outputs round at 2⁻⁸). The JAX side is
imported through the ``jx`` fixture, so on a machine with only the card's
software the ``gpu`` test still collects and runs.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref

TOL = 1e-5
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

#: (B, Hq, Hkv, Lq, Lk, D, causal, window): causal, GQA, a window, Lq <
#: Lk, non-causal, MHA with a window, and Lq > Lk, whose first 16 rows see
#: no key
CASES = [
    (2, 4, 2, 48, 48, 32, True, 0),
    (1, 4, 1, 40, 72, 64, True, 16),
    (2, 2, 2, 33, 50, 64, False, 0),
    (1, 4, 4, 24, 24, 64, False, 8),
    (1, 4, 2, 40, 24, 32, True, 0),
    (2, 8, 2, 17, 17, 32, True, 5),
]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    return SimpleNamespace(jax=jax, jnp=jax.numpy, ref=jref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, B, Hq, Hkv, Lq, Lk, D):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return draw(B, Hq, Lq, D), draw(B, Hkv, Lk, D), draw(B, Hkv, Lk, D), draw(B, Hq, Lq, D)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_backward_twin_matches_jax_vjp_and_autograd(jx, case):
    B, Hq, Hkv, Lq, Lk, D, causal, window = case
    q, k, v, do = _inputs(sum(case[:6]), B, Hq, Hkv, Lq, Lk, D)
    attn = lambda a, b, c: jx.ref.flash_attention(a, b, c, causal=causal, window=window)
    _, vjp = jx.jax.vjp(attn, q, k, v)
    want = [np.asarray(g) for g in vjp(jx.jnp.asarray(do))]
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o = ref.flash_attention(*t, causal=causal, window=window)
    got = ref.flash_attention_bwd(*t, o, torch.from_numpy(do), causal=causal, window=window)
    leaves = [x.clone().requires_grad_() for x in t]
    ref.flash_attention(*leaves, causal=causal, window=window).backward(torch.from_numpy(do))
    for name, g, w, a in zip("qkv", got, want, leaves):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        assert np.isfinite(w).all(), name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))
        assert _rel(g, a.grad) <= TOL, (name, _rel(g, a.grad))
    if Lq > Lk and causal:   # rows that see no key give and get nothing
        assert not got[0][:, :, :Lq - Lk].any()


def test_backward_twin_returns_the_inputs_dtypes():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 1, 4, 2, 16, 16, 32))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    o = ref.flash_attention(q, kb, vb)
    dq, dk, dv = ref.flash_attention_bwd(q, kb, vb, o, do)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.float32, torch.bfloat16, torch.bfloat16)
    o = ref.flash_attention(qb, kb, vb)
    dq, _, _ = ref.flash_attention_bwd(qb, kb, vb, o, do.bfloat16())
    assert dq.dtype == torch.bfloat16


@pytest.mark.parametrize("case", CASES[:2] + CASES[4:5])
def test_autograd_function_on_cpu_gives_the_twins_gradients(case):
    """`ops.flash_attention` with grad on: the forward twin's output and,
    through `FlashAttention`, exactly `ref.flash_attention_bwd`'s gradients,
    over the strided ``[B, L, H, D]`` views `layers.attend` passes."""
    B, Hq, Hkv, Lq, Lk, D, causal, window = case
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(7, B, Hq, Hkv, Lq, Lk, D))
    # the layout attend hands over: [B, L, H, D] tensors seen as [B, H, L, D]
    leaves = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
    views = [x.transpose(1, 2) for x in leaves]
    o = ops.flash_attention(*views, causal=causal, window=window)
    assert o.grad_fn is not None and type(o.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(o, ref.flash_attention(q, k, v, causal=causal, window=window))
    o.backward(do)
    want = ref.flash_attention_bwd(q, k, v, o.detach(), do, causal=causal, window=window)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad.transpose(1, 2), w)


def test_nothing_saved_without_grad():
    """Under ``no_grad`` and ``inference_mode`` (serving), and on inputs
    that need no gradient, the attention saves no tensor and records no
    graph; with grad on it saves q, k, v and o."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(5, 1, 4, 2, 16, 16, 32))
    packed = []

    def call(*ts):
        with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t,
                                                      lambda t: t):
            return ops.flash_attention(*ts)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        assert call(*leaves).grad_fn is None
    with torch.inference_mode():
        assert call(*leaves).grad_fn is None
    assert call(q, k, v).grad_fn is None
    assert packed == []
    out = call(*leaves)
    assert out.grad_fn is not None and len(packed) == 4
    want = ref.flash_attention(q, k, v)
    assert torch.equal(out.detach(), want)


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 1, 4, 2, 16, 16, 32))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bwd(q, k, v, q, do)


#: the card's sweep: every head dim in both dtypes, a window, whisper's
#: cross shape (non-causal, Lq < Lk), ragged Lq < Lk, rows with no key;
#: then the bf16 (tensor-core) route's edges: a window that cuts inside a
#: tile, non-causal Lq < Lk, rows with no key, tinyllama's group of 8 over
#: many tiles, and D 96 and 128 with a window
GPU_CASES = [
    (2, 8, 2, 200, 200, D, True, 0, dt)
    for D in (32, 64, 96, 128) for dt in (torch.float32, torch.bfloat16)
] + [
    (1, 5, 1, 300, 300, 64, True, 64, torch.float32),
    (1, 12, 12, 104, 375, 64, False, 0, torch.float32),
    (2, 4, 2, 37, 101, 64, True, 0, torch.bfloat16),
    (1, 8, 4, 90, 40, 64, True, 0, torch.float32),
] + [
    (1, 5, 1, 300, 300, 64, True, 40, torch.bfloat16),
    (1, 12, 12, 104, 375, 64, False, 0, torch.bfloat16),
    (1, 8, 4, 90, 40, 64, True, 0, torch.bfloat16),
    (1, 32, 4, 1024, 1024, 64, True, 0, torch.bfloat16),
    (1, 8, 2, 300, 300, 96, True, 100, torch.bfloat16),
    (1, 8, 2, 300, 300, 128, True, 100, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_cuda_backward_kernel_matches_twin(cuda, case):
    """The kernel against its twin on the card, over strided ``[B, L, H,
    D]`` views and an expanded (stride-0) output gradient; two launches are
    bit-equal; `FlashAttention`'s backward on CUDA is the kernel."""
    B, Hq, Hkv, Lq, Lk, D, causal, window, dt = case
    q, k, v, do = (torch.from_numpy(x).to(cuda, dt)
                   for x in _inputs(11, B, Hq, Hkv, Lq, Lk, D))
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    o = FA.flash_attention(q, k, v, causal=causal, window=window)
    before = FA.flash_attention_bwd.launches
    got = FA.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    again = FA.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.flash_attention_bwd.launches == before + 2
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    for g, a, w, x in zip(got, again, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert torch.equal(g, a)
        assert _rel(g.float().cpu(), w.float().cpu()) <= CARD_TOL[dt]
    if Lq > Lk and causal:
        assert not got[0][:, :, :Lq - Lk].any()
    # a stride-0 gradient (expanded) is copied, not refused
    ones = torch.ones((), device=cuda, dtype=dt).expand_as(o)
    got1 = FA.flash_attention_bwd(q, k, v, o, ones, causal=causal, window=window)
    want1 = ref.flash_attention_bwd(q, k, v, o, ones, causal=causal, window=window)
    for g, w in zip(got1, want1):
        assert _rel(g.float().cpu(), w.float().cpu()) <= CARD_TOL[dt]
    # through autograd: the backward kernel, not the twin
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    n = FA.flash_attention_bwd.launches
    ops.flash_attention(*leaves, causal=causal, window=window).backward(do)
    assert FA.flash_attention_bwd.launches == n + 1
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c for c in GPU_CASES
                                  if c[-1] == torch.bfloat16 and c[1] > c[2]])
def test_cuda_backward_group_splits_match_twin(cuda, monkeypatch, case):
    """Every KV head's group cut one query head a block (``DKDV_WALK`` 1):
    the partial dK and dV, summed by ``flash_bwd_dkdv_sum``, match the
    twin, and two launches are bit-equal."""
    monkeypatch.setattr(FA, "DKDV_WALK", 1)
    B, Hq, Hkv, Lq, Lk, D, causal, window, dt = case
    q, k, v, do = (torch.from_numpy(x).to(cuda, dt)
                   for x in _inputs(17, B, Hq, Hkv, Lq, Lk, D))
    o = FA.flash_attention(q, k, v, causal=causal, window=window)
    got = FA.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    again = FA.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert _rel(g.float().cpu(), w.float().cpu()) <= CARD_TOL[dt]


@pytest.mark.gpu
def test_cuda_backward_bf16_rows_must_be_aligned(cuda):
    """The tensor-core route stages rows by 16-byte copies: a bf16 q whose
    rows start off a 16-byte boundary is refused; such a gradient ``do`` is
    copied and gives the aligned launch's bits."""
    q, k, v, do = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                   for x in _inputs(13, 1, 4, 2, 64, 64, 32))
    o = FA.flash_attention(q, k, v)
    shifted = lambda x: torch.cat([x.flatten(), x.flatten()[:1]])[1:].view_as(x)
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention_bwd(shifted(q), k, v, o, do)
    got = FA.flash_attention_bwd(q, k, v, o, shifted(do).copy_(do))
    for g, w in zip(got, FA.flash_attention_bwd(q, k, v, o, do)):
        assert torch.equal(g, w)
