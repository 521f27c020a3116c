"""Wrapper of the Hopper containment kernel (``csrc/containment.cu``).

Replaces the Pallas kernel ``repro.kernels.containment.containment_hits``
and its per-row vmap: one launch counts the exact key intersection of a
whole ``[B, nq]`` query batch with all ``[C, n]`` candidates. Semantics:
`repro_torch.kernels.ref.containment_hits_batched`, its plain twin.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sketch_join import MAX_N, check

#: a launch's shared memory without opting in to more: the sorted keys
#: (8 bytes each of next_pow2(n) ≤ MAX_N slots) and one count per row
SMEM_BYTES = 48 * 1024


def _launch_fn():
    f = build.library("containment").containment_hits_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [P] * 4 + [I] * 4 + [P, P]
    f.restype = I
    return f


def containment_hits_batched(q_kh, q_mask, c_kh, c_mask):
    """Launch the kernel: ``q_kh [B, nq]`` / ``c_kh [C, n]`` (int32 key
    patterns) with f32 masks → hits f32[B, C]."""
    dev = q_kh.device
    if dev.type != "cuda":
        raise ValueError(f"the containment kernel runs on CUDA, not {dev}")
    B, nq = q_kh.shape
    C, n = c_kh.shape
    if n > MAX_N:
        raise ValueError(f"sketch size {n} exceeds the kernel's {MAX_N}")
    np2 = 1 << max(n - 1, 0).bit_length()
    if np2 * 8 + B * 4 > SMEM_BYTES:
        raise ValueError(f"a {B}-row batch at n={n} exceeds the kernel's "
                         f"{SMEM_BYTES} bytes of shared memory")
    for t, name, dt, shape in ((q_kh, "q_kh", torch.int32, (B, nq)),
                               (q_mask, "q_mask", torch.float32, (B, nq)),
                               (c_kh, "c_kh", torch.int32, (C, n)),
                               (c_mask, "c_mask", torch.float32, (C, n))):
        check(t, name, dt, shape, dev)
    if B == 0 or C == 0 or n == 0 or nq == 0:
        return torch.zeros((B, C), dtype=torch.float32, device=dev)
    hits = torch.empty((B, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _launch_fn()(q_kh.data_ptr(), q_mask.data_ptr(),
                           c_kh.data_ptr(), c_mask.data_ptr(), B, nq, C, n,
                           hits.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"containment kernel launch failed: CUDA error {err}")
    build.count_launch(containment_hits_batched)
    return hits


containment_hits_batched.launches = 0
