"""Wrapper of the Hopper attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas kernel ``repro.kernels.flash_attention.flash_attention``:
the forward pass of causal / sliding-window GQA attention, for any Lq and
Lk (the Pallas ``Lq % block_q`` restriction is a TPU tiling artifact), with
q and k/v each float32 or bfloat16, over strided ``[B, H, L, D]`` views
whose last dimension is contiguous. Semantics:
`repro_torch.kernels.ref.flash_attention`, its plain twin.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: head dims the library instantiates
HEAD_DIMS = (32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch_fn():
    f = build.library("flash_attention").flash_attention_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [P] * 5 + [I] * 10 + [P]
    f.restype = I
    return f


def _check(t: torch.Tensor, name: str, shape: tuple, dev: torch.device) -> None:
    if t.device != dev or t.dtype not in _DTYPES or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected a float32 or bfloat16 tensor of shape "
                         f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.numel() and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous, "
                         f"strides {t.stride()}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the kernel: q [B, Hq, Lq, D], k and v [B, Hkv, Lk, D] → o
    [B, Hq, Lq, D] in q's dtype, laid out as ``[B, Lq, Hq, D]`` (so a
    caller's ``o.transpose(1, 2)`` is contiguous)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash_attention kernel runs on CUDA, not {dev}")
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of the kernel's {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    _check(q, "q", (B, Hq, Lq, D), dev)
    _check(k, "k", (B, Hkv, Lk, D), dev)
    _check(v, "v", (B, Hkv, Lk, D), dev)
    if v.dtype != k.dtype:
        raise ValueError(f"k is {k.dtype} but v is {v.dtype}")
    out = torch.empty((B, Lq, Hq, D), dtype=q.dtype, device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out)
                                         for i in range(3)))
    with torch.cuda.device(dev):
        err = _launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           ctypes.addressof(strides), B, Hq, Hkv, Lq, Lk, D,
                           int(bool(causal)), int(window), _DTYPES[q.dtype],
                           _DTYPES[k.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
