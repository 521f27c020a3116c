"""Wrapper of the Hopper sketch-join kernel (``csrc/sketch_join.cu``).

Replaces the Pallas kernel ``repro.kernels.sketch_join.sketch_join_moments``
and its per-row vmap: one launch serves a whole ``[B, nq]`` query batch
against ``[C, n]`` candidates. Semantics: `repro_torch.kernels.ref.
sketch_join_moments_batched`, its plain twin.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: shared-memory bound: the kernel's hash table (32 bytes for each of
#: next_pow2(n) candidate slots up to 1024, 16 beyond) and the values must
#: fit the 48 KB a launch gets without opting in to more
MAX_N = 2048


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel takes."""
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _launch_fn():
    f = build.library("sketch_join").sketch_join_moments_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [P] * 6 + [I] * 4 + [P] * 4
    f.restype = I
    return f


def sketch_join_moments_batched(q_kh, q_val, q_mask, c_kh, c_val, c_mask,
                                with_aligned: bool = True):
    """Launch the kernel: ``q_* [B, nq]`` (int32 key patterns, f32 values
    and masks) against ``c_* [C, n]`` → (mom f32[B, C, 6], aligned and hit
    f32[B, C, nq] or None)."""
    dev = q_kh.device
    if dev.type != "cuda":
        raise ValueError(f"the sketch_join kernel runs on CUDA, not {dev}")
    B, nq = q_kh.shape
    C, n = c_kh.shape
    if n > MAX_N:
        raise ValueError(f"sketch size {n} exceeds the kernel's {MAX_N}")
    for t, name, dt, shape in ((q_kh, "q_kh", torch.int32, (B, nq)),
                               (q_val, "q_val", torch.float32, (B, nq)),
                               (q_mask, "q_mask", torch.float32, (B, nq)),
                               (c_kh, "c_kh", torch.int32, (C, n)),
                               (c_val, "c_val", torch.float32, (C, n)),
                               (c_mask, "c_mask", torch.float32, (C, n))):
        check(t, name, dt, shape, dev)
    mom = torch.empty((B, C, 6), dtype=torch.float32, device=dev)
    aligned = hit = None
    if with_aligned:
        aligned = torch.empty((B, C, nq), dtype=torch.float32, device=dev)
        hit = torch.empty((B, C, nq), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return mom, aligned, hit
    with torch.cuda.device(dev):
        err = _launch_fn()(
            q_kh.data_ptr(), q_val.data_ptr(), q_mask.data_ptr(),
            c_kh.data_ptr(), c_val.data_ptr(), c_mask.data_ptr(),
            B, nq, C, n, mom.data_ptr(),
            aligned.data_ptr() if with_aligned else None,
            hit.data_ptr() if with_aligned else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sketch_join kernel launch failed: CUDA error {err}")
    build.count_launch(sketch_join_moments_batched)
    return mom, aligned, hit


sketch_join_moments_batched.launches = 0
