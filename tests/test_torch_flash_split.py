"""The numerical argument for the tensor-core attention kernel
(`csrc/flash_attention.cu`, ``flash_fwd``): its products run on TF32
tensor cores, whose operands keep 10 mantissa bits. Emulated here in
torch on the CPU, at the kernel's order of work (logits scaled by
log2(e)/√D, exp2, P·V, then the division by the row sum):

* split TF32 — x = hi + lo, hi rounded to TF32 (to nearest, ties away)
  and lo the remainder truncated to TF32 (the tensor cores drop an
  operand's low 13 bits), and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi —
  stays within 1e-5 of the JAX package's float32 reference
  (`repro.kernels.ref.flash_attention`);
* one TF32 product a step misses it by more than 1e-4, so the kernel may
  not take it;
* a bf16 value is a TF32 value (its low part is 0), so bf16 operands need
  one product a step.

Products of TF32 values are exact in float64, so the emulation sums the
terms in float64 and rounds once to float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR


def _truncate(bits):
    """int32 bit patterns → the TF32 values the tensor cores read: the low
    13 mantissa bits dropped."""
    return (bits & ~0x1FFF).view(torch.float32)


def _tf32(x):
    """float32 → the nearest TF32 value, ties away from zero: half a TF32
    ulp added to the bit pattern, then truncated."""
    return _truncate(x.contiguous().view(torch.int32) + 0x1000)


def _split(x):
    """x → (hi, lo) as the kernel feeds them: hi rounded, lo = x − hi
    (exact in float32) truncated."""
    hi = _tf32(x)
    return hi, _truncate((x - hi).contiguous().view(torch.int32))


def _matmul(a, b, passes: int):
    """a @ b on the tensor cores' TF32 operands: one product (``passes`` =
    1) or the split's three, in float64, rounded to float32."""
    if passes == 1:
        return (_tf32(a).double() @ _tf32(b).double()).float()
    ah, al = _split(a)
    bh, bl = _split(b)
    d = lambda x, y: x.double() @ y.double()
    return (d(al, bh) + d(ah, bl) + d(ah, bh)).float()


def _attention(q, k, v, causal, window, passes):
    """GQA attention with both products through `_matmul`, softmax in
    float32 as the kernel takes it; positions right-aligned."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    kq = k.repeat_interleave(Hq // Hkv, dim=1)
    vq = v.repeat_interleave(Hq // Hkv, dim=1)
    s = _matmul(q, kq.transpose(-1, -2), passes) * np.float32(np.log2(np.e) / np.sqrt(D))
    qpos = torch.arange(Lq)[:, None] + (Lk - Lq)
    kpos = torch.arange(Lk)[None, :]
    keep = torch.ones((Lq, Lk), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window > 0:
        keep &= kpos > qpos - window
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(-1, keepdim=True)
    return _matmul(p, vq, passes) / torch.clamp(l, min=1e-30)


CASES = [
    (1, 8, 1, 64, 64, 32, True, 0),       # D = 32, a group of 8
    (1, 16, 2, 96, 96, 64, True, 0),      # D = 64, tinyllama's group
    (1, 8, 1, 64, 64, 128, True, 0),      # D = 128
    (1, 8, 1, 80, 80, 64, True, 16),      # a window
    (1, 8, 1, 40, 24, 32, True, 0),       # Lq > Lk: the first rows see no key
    (2, 8, 1, 33, 70, 64, False, 0),      # no mask, Lq < Lk
]


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,window", CASES)
def test_split_tf32_attention_keeps_float32_accuracy(rng, B, Hq, Hkv, Lq, Lk, D,
                                                     causal, window):
    q = rng.normal(size=(B, Hq, Lq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Lk, D)).astype(np.float32)
    want = np.asarray(JR.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal, window=window), np.float64)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    split = _attention(*t, causal, window, passes=3).double().numpy()
    single = _attention(*t, causal, window, passes=1).double().numpy()
    assert np.isfinite(split).all()
    assert np.abs(split - want).max() <= 1e-5
    assert np.abs(single - want).max() > 1e-4
    if causal and Lq > Lk:
        assert (split[:, :, :Lq - Lk] == 0).all()


def test_tf32_rounding_and_split_are_exact_where_they_must_be(rng):
    """hi + lo recovers x to within 2^-21 of its magnitude; a bf16 value
    is its own TF32 rounding (its low part is 0)."""
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    hi, lo = _split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi.double() + lo.double()) - x.double()).abs().max()) \
        <= float(x.abs().max()) * 2.0 ** -21
    assert float((hi - x).abs().max()) > float(x.abs().max()) * 2.0 ** -14
    b = x.to(torch.bfloat16).float()
    assert torch.equal(_tf32(b), b) and bool((_split(b)[1] == 0).all())
