"""Wrapper of the Hopper hashing kernel (``csrc/hash_build.cu``).

Replaces the Pallas kernel ``repro.kernels.hash_build.hash_build``: one
elementwise pass turns 32-bit join keys into their murmur3 hash ``h``, its
Fibonacci value ``fib`` and ``unit = fib / 2³²``, for any key count (the
Pallas ``m % block`` restriction is a TPU tiling artifact). Semantics:
`repro_torch.kernels.ref.hash_build`, its plain twin.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sketch_join import check


def _launch_fn():
    f = build.library("hash_build").hash_build_launch
    P = ctypes.c_void_p
    f.argtypes = [P] * 4 + [ctypes.c_longlong, P]
    f.restype = ctypes.c_int
    return f


def hash_build(keys):
    """Launch the kernel: ``keys`` i32 (any shape, the keys' bit patterns)
    → (h i32, fib i32, unit f32) of the same shape, h and fib as int32 bit
    patterns."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"the hash_build kernel runs on CUDA, not {dev}")
    check(keys, "keys", torch.int32, tuple(keys.shape), dev)
    h = torch.empty_like(keys)
    fib = torch.empty_like(keys)
    unit = torch.empty(keys.shape, dtype=torch.float32, device=dev)
    if keys.numel() == 0:
        return h, fib, unit
    with torch.cuda.device(dev):
        err = _launch_fn()(keys.data_ptr(), h.data_ptr(), fib.data_ptr(),
                           unit.data_ptr(), keys.numel(),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"hash_build kernel launch failed: CUDA error {err}")
    build.count_launch(hash_build)
    return h, fib, unit


hash_build.launches = 0
