"""Wrappers of the Hopper postings kernels (``csrc/postings.cu``).

``postings_merge`` replaces the Pallas kernel ``repro.kernels.postings.
postings_merge`` (per row of matched window ids: each distinct id once
with its count); ``postings_select`` replaces ``repro.kernels.postings.
postings_select`` (the ascending union of eligible ids across rows, cut to
a rung). Semantics: the plain twins `repro_torch.kernels.ref.
postings_merge` / `postings_select`, which both kernels equal bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.sketch_join import check

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: C signatures
_ARGTYPES = {
    "postings_merge_launch": [_P, _I, _I, _I, _P, _P, _P, _P],
    "postings_select_launch": [_P, _P, _LL, _F, _I, _I, _P, _P, _P, _P, _P],
}


@functools.cache
def _fn(name: str):
    """The library's launcher ``name``, typed once."""
    f = getattr(build.library("postings"), name)
    f.argtypes = _ARGTYPES[name]
    f.restype = _I
    return f


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def postings_merge(cand, C: int):
    """Launch the merge: ``cand`` i32[B, L] of ids in [0, C) (−1 in empty
    slots) → (cols i32[B, L], counts f32[B, L]), each row's distinct ids
    ascending at the front with their counts, then (−1, 0)."""
    dev = cand.device
    if dev.type != "cuda":
        raise ValueError(f"the postings_merge kernel runs on CUDA, not {dev}")
    B, L = cand.shape
    check(cand, "cand", torch.int32, (B, L), dev)
    C = int(C)
    if C < 0 or B > 65535:
        raise ValueError(f"column count C={C} must be ≥ 0 and rows B={B} at most 65535")
    cols = torch.empty((B, L), dtype=torch.int32, device=dev)
    counts = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B == 0 or L == 0:
        return cols, counts
    # per row: the id bitmap and a done-counter, the distinct-id total and
    # the bitmap words' prefix counts (csrc/postings.cu's MergeScratch)
    words = ((C + 31) // 32 + 3) // 4 * 4
    scratch = torch.empty((2 * B * words + 2 * B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _fn("postings_merge_launch")(
            cand.data_ptr(), B, L, C, scratch.data_ptr(),
            cols.data_ptr(), counts.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"postings_merge kernel launch failed: CUDA error {err}")
    build.count_launch(postings_merge)
    return cols, counts


def postings_select(cols, counts, floor, M: int, C: int):
    """Launch the select: merged ``cols`` i32[B, L] (ids in [0, C)) and
    ``counts`` f32[B, L], float32 ``floor`` → (surv i32[M], valid bool[M],
    n_surv i32[])."""
    dev = cols.device
    if dev.type != "cuda":
        raise ValueError(f"the postings_select kernel runs on CUDA, not {dev}")
    B, L = cols.shape
    check(cols, "cols", torch.int32, (B, L), dev)
    check(counts, "counts", torch.float32, (B, L), dev)
    M, C = int(M), int(C)
    if M < 0 or C < 0:
        raise ValueError(f"rung M={M} and column count C={C} must be ≥ 0")
    # the bitmap of eligible ids, then the kernel's done-counter
    scratch = torch.empty(((C + 31) // 32 + 1,), dtype=torch.int32, device=dev)
    surv = torch.empty((M,), dtype=torch.int32, device=dev)
    valid = torch.empty((M,), dtype=torch.bool, device=dev)
    n_surv = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _fn("postings_select_launch")(
            cols.data_ptr(), counts.data_ptr(), B * L,
            float(np.float32(floor)), C, M, scratch.data_ptr(),
            surv.data_ptr(), valid.data_ptr(), n_surv.data_ptr(),
            _stream(dev))
    if err:
        raise RuntimeError(f"postings_select kernel launch failed: CUDA error {err}")
    build.count_launch(postings_select)
    return surv, valid, n_surv


postings_merge.launches = 0
postings_select.launches = 0
