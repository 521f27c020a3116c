"""Wrappers of the Hopper rank-estimator kernels (``csrc/rank_transform.cu``).

``rank_moments`` replaces the Pallas kernel ``repro.kernels.rank_transform.
rank_moments`` (spearman and rin); ``qn_correlation`` replaces ``repro.
kernels.rank_transform.qn_correlation``; ``rank_transform`` replaces
``repro.kernels.rank_transform.rank_transform`` (the paper library's
midranks). Semantics: the plain twins `repro_torch.kernels.ref.
rank_moments` / `qn_correlation` / `rank_transform`. All take ``[R, n]``
rows; `repro_torch.kernels.ops` flattens leading axes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.sketch_join import check

MAX_N = 2048   # shared-memory bound of one row (Qn: three planes + sort)
_KINDS = {"spearman": 0, "rin": 1}


_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signatures: (a, b, mask, R, n, [kind, table,] out, stream)
_ARGTYPES = {
    "rank_moments_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "qn_correlation_launch": [_P, _P, _P, _I, _I, _P, _P],
    "rank_transform_launch": [_P, _P, _I, _I, _P, _P],
}


def _fn(name: str):
    f = getattr(build.library("rank_transform"), name)
    f.argtypes = _ARGTYPES[name]
    f.restype = _I
    return f


def _check_rows(a, b, mask, what: str):
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA, not {dev}")
    if a.dim() != 2:
        raise ValueError(f"{what}: expected [R, n] rows, got {tuple(a.shape)}")
    R, n = a.shape
    if n > MAX_N:
        raise ValueError(f"row width {n} exceeds the kernel's {MAX_N}")
    for t, name in ((a, "a"), (b, "b"), (mask, "mask")):
        check(t, name, torch.float32, (R, n), dev)
    return dev, R, n


def rank_moments(a, b, mask, kind: str = "spearman"):
    """Launch the kernel: a, b, mask f32[R, n] → f32[R, 6]."""
    if kind not in _KINDS:
        raise ValueError(f"unknown rank_moments kind: {kind!r}")
    dev, R, n = _check_rows(a, b, mask, "rank_moments")
    out = torch.empty((R, 6), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    table = ref.rankit_table(n, dev) if kind == "rin" else None
    with torch.cuda.device(dev):
        err = _fn("rank_moments_launch")(
            a.data_ptr(), b.data_ptr(), mask.data_ptr(), R, n, _KINDS[kind],
            table.data_ptr() if table is not None else None, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rank_moments kernel launch failed: CUDA error {err}")
    build.count_launch(rank_moments)
    return out


def qn_correlation(a, b, mask):
    """Launch the kernel: a, b, mask f32[R, n] → f32[R]."""
    dev, R, n = _check_rows(a, b, mask, "qn_correlation")
    out = torch.empty((R,), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    with torch.cuda.device(dev):
        err = _fn("qn_correlation_launch")(
            a.data_ptr(), b.data_ptr(), mask.data_ptr(), R, n, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"qn_correlation kernel launch failed: CUDA error {err}")
    build.count_launch(qn_correlation)
    return out


def rank_transform(x, mask):
    """Launch the kernel: x, mask f32[R, n] → f32[R, n]. Any n: the row
    streams through shared memory in tiles."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the rank_transform kernel runs on CUDA, not {dev}")
    if x.dim() != 2:
        raise ValueError(f"rank_transform: expected [R, n] rows, got "
                         f"{tuple(x.shape)}")
    R, n = x.shape
    check(x, "x", torch.float32, (R, n), dev)
    check(mask, "mask", torch.float32, (R, n), dev)
    out = torch.empty((R, n), dtype=torch.float32, device=dev)
    if R == 0 or n == 0:
        return out
    with torch.cuda.device(dev):
        err = _fn("rank_transform_launch")(
            x.data_ptr(), mask.data_ptr(), R, n, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rank_transform kernel launch failed: CUDA error {err}")
    build.count_launch(rank_transform)
    return out


rank_moments.launches = 0
qn_correlation.launches = 0
rank_transform.launches = 0
