"""Dispatch to the port's kernels, shaped like ``repro.kernels.ops``.

The device of the tensors picks the path: CPU tensors go to the plain
PyTorch twin (`repro_torch.kernels.ref`), CUDA tensors to the hand-written
Hopper kernel, which launches or raises — there is no fallback from a
failed build or launch to the twin. Each CUDA wrapper counts its launches
(`LAUNCH_COUNTERS`), so a run can show its path went through the kernels.

`KernelConfig` and the single-query `sketch_join_moments` and
`containment_hits` keep the reference's legacy signatures: the reference's
Pallas kernels are single-query, its batched forms a vmap of them; here a
single query is one launch of the batched kernel at B = 1.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.kernels import build
from repro_torch.kernels import containment as _ct
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hash_build as _hb
from repro_torch.kernels import postings as _pm
from repro_torch.kernels import rank_transform as _rt
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sketch_join as _sj

#: the CUDA wrappers, each carrying a ``launches`` count
LAUNCH_COUNTERS = {
    "sketch_join_moments": _sj.sketch_join_moments_batched,
    "rank_moments": _rt.rank_moments,
    "qn_correlation": _rt.qn_correlation,
    "rank_transform": _rt.rank_transform,
    "containment_hits": _ct.containment_hits_batched,
    "postings_merge": _pm.postings_merge,
    "postings_select": _pm.postings_select,
    "hash_build": _hb.hash_build,
    "flash_attention": _fa.flash_attention,
    "flash_attention_bwd": _fa.flash_attention_bwd,
}


Backend = Literal["xla", "pallas", "interpret"]


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """The reference's kernel backend choice, kept so that a legacy
    `repro_torch.engine.query.QueryConfig` builds. In the port it picks no
    path: a CUDA tensor always runs the hand-written kernel and a CPU
    tensor its plain twin, whatever ``backend`` says — a backend that could
    send card data to the twin would hide the kernel."""
    backend: Backend = "xla"

    @property
    def interpret(self) -> bool:
        return self.backend == "interpret"

    @property
    def use_pallas(self) -> bool:
        return self.backend in ("pallas", "interpret")


def default_backend() -> Backend:
    """The reference's default: "pallas" where the accelerator is present
    (here a CUDA card), else "xla". Informational only (`KernelConfig`)."""
    return "pallas" if torch.cuda.is_available() else "xla"


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain path for device {t.device}")


def load_kernels(device: torch.device) -> None:
    """Build (at first use) and load every kernel library for ``device``;
    nothing to do on the CPU."""
    if torch.device(device).type == "cuda":
        for name in build.SOURCES:
            build.library(name)


def reset_launches() -> None:
    with build.LAUNCH_LOCK:
        for fn in LAUNCH_COUNTERS.values():
            fn.launches = 0


def launches() -> dict:
    with build.LAUNCH_LOCK:
        return {name: fn.launches for name, fn in LAUNCH_COUNTERS.items()}


def sketch_join_moments_batched(q_kh, q_val, q_mask, c_kh, c_val, c_mask,
                                with_aligned: bool = True):
    """Batched-query sketch join: ``q_* [B, nq]`` against shared candidates
    ``c_* [C, n]`` → (mom [B, C, 6], aligned [B, C, nq], hit [B, C, nq]);
    aligned/hit are None unless ``with_aligned``."""
    impl = (_sj.sketch_join_moments_batched if _on_cuda(q_kh)
            else _ref.sketch_join_moments_batched)
    return impl(q_kh, q_val, q_mask, c_kh, c_val, c_mask,
                with_aligned=with_aligned)


def sketch_join_moments(q_kh, q_val, q_mask, c_kh, c_val, c_mask,
                        cfg: KernelConfig = KernelConfig()):
    """Single-query sketch join: ``q_* [nq]`` against ``c_* [C, n]`` →
    (mom [C, 6], aligned [C, nq], hit [C, nq]) — the batched kernel (or
    twin) at B = 1, so it equals that query's row of a batch. ``cfg`` picks
    nothing (`KernelConfig`)."""
    mom, aligned, hit = sketch_join_moments_batched(
        q_kh[None], q_val[None], q_mask[None], c_kh, c_val, c_mask)
    return mom[0], aligned[0], hit[0]


def rank_moments(a, b, mask, kind: str = "spearman"):
    """Fused masked rank transform + moments: a, b, mask f32[..., n] →
    f32[..., 6] (``kind='rin'``: rankit-transformed ranks)."""
    if not _on_cuda(a):
        return _ref.rank_moments(a, b, mask, kind=kind)
    lead, n = a.shape[:-1], a.shape[-1]
    flat = lambda x: x.reshape(-1, n)
    return _rt.rank_moments(flat(a), flat(b), flat(mask), kind).reshape(*lead, 6)


def qn_correlation(a, b, mask):
    """Qn robust correlation per row: a, b, mask f32[..., n] → f32[...]."""
    if not _on_cuda(a):
        return _ref.qn_correlation(a, b, mask)
    lead, n = a.shape[:-1], a.shape[-1]
    flat = lambda x: x.reshape(-1, n)
    return _rt.qn_correlation(flat(a), flat(b), flat(mask)).reshape(lead)


def rank_transform(x, mask):
    """Weighted midranks per row (`ref.rank_transform`): x, mask f32
    [..., n] (mask may be bool) → f32[..., n], 0 in masked slots."""
    lead, n = x.shape[:-1], x.shape[-1]
    flat = lambda t: t.to(torch.float32).reshape(-1, n).contiguous()
    impl = _rt.rank_transform if _on_cuda(x) else _ref.rank_transform
    return impl(flat(x), flat(mask)).reshape(*lead, n)


def containment_hits_batched(q_kh, q_mask, c_kh, c_mask):
    """Stage-1 exact key-intersection counts: ``q_* [B, nq]`` against
    ``c_* [C, n]`` (int32 key patterns, f32 masks) → hits f32[B, C]."""
    impl = (_ct.containment_hits_batched if _on_cuda(q_kh)
            else _ref.containment_hits_batched)
    return impl(q_kh, q_mask, c_kh, c_mask)


def containment_hits(q_kh, q_mask, c_kh, c_mask,
                     cfg: KernelConfig = KernelConfig()):
    """Single-query stage-1 counts: ``q_* [nq]`` against ``c_* [C, n]`` →
    hits f32[C] — the batched kernel (or twin) at B = 1. ``cfg`` picks
    nothing (`KernelConfig`)."""
    return containment_hits_batched(q_kh[None], q_mask[None], c_kh, c_mask)[0]


def postings_merge(cand, C: int):
    """Per row of gathered window ids ``cand`` i32[B, L] (ids in [0, C)):
    each distinct id once with its count → (cols i32[B, L], counts
    f32[B, L])."""
    impl = _pm.postings_merge if _on_cuda(cand) else _ref.postings_merge
    return impl(cand, C)


def postings_select(cols, counts, floor, M: int, C: int):
    """The ascending union of eligible ids (count ≥ floor) across merged
    rows, cut to rung M → (surv i32[M], valid bool[M], n_surv i32[]);
    ids lie in [0, C)."""
    if _on_cuda(cols):
        return _pm.postings_select(cols, counts, floor, M, C)
    return _ref.postings_select(cols, counts, floor, M)


def hash_build(keys):
    """Murmur3 ``h``, Fibonacci ``fib`` and ``unit`` of 32-bit keys (i32
    bit patterns, any shape) → (h i32, fib i32, unit f32), h and fib as
    int32 bit patterns."""
    impl = _hb.hash_build if _on_cuda(keys) else _ref.hash_build
    return impl(keys)


def _attention_impls(q):
    """(forward, backward) for q's device: the kernels on CUDA, the twins
    on the CPU."""
    if _on_cuda(q):
        return _fa.flash_attention, _fa.flash_attention_bwd
    return _ref.flash_attention, _ref.flash_attention_bwd


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: on CUDA tensors the forward and backward
    kernels, on CPU tensors their plain twins. It saves q, k, v and o for
    the backward (`flash_attention` calls it only when a gradient is
    wanted)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o = _attention_impls(q)[0](q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = _attention_impls(q)[1](q, k, v, o, do, causal=ctx.causal,
                                            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal / sliding-window GQA attention: q [B, Hq, Lq, D], k and v
    [B, Hkv, Lk, D] (strided views, f32 or bf16 each) → [B, Hq, Lq, D] in
    q's dtype; positions right-aligned (query i sits at Lk − Lq + i).
    Differentiable: when grad mode is on and q, k or v requires a gradient
    it goes through `FlashAttention`, whose gradient is the backward kernel
    on CUDA and the twin's on the CPU; otherwise it is the forward alone,
    which saves nothing, so serving launches and allocates as before."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), int(window))
    return _attention_impls(q)[0](q, k, v, causal=causal, window=window)


# moment → statistics helpers shared by the engine
pearson_from_moments = _ref.pearson_from_moments
hoeffding_from_moments = _ref.hoeffding_from_moments
