"""Wrappers of the Hopper attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) and the gradient that joins them.

Replaces the Pallas kernel ``repro.kernels.flash_attention.flash_attention``:
the forward pass of causal / sliding-window GQA attention, for any Lq and
Lk (the Pallas ``Lq % block_q`` restriction is a TPU tiling artifact), with
q and k/v each float32 or bfloat16, over strided ``[B, H, L, D]`` views
whose last dimension is contiguous. Semantics:
`repro_torch.kernels.ref.flash_attention`, its plain twin.

The wrapper picks the kernel by shape: a launch with at most
``SPLIT_ROWS`` query rows (positions × heads of a group) per (batch, KV
head) — decode — goes to ``flash_fwd_split``, which cuts the keys into
runs (`split_plan`) and needs a workspace; the rest to ``flash_fwd``.

`flash_attention_bwd` launches the gradient's kernels; the reference has
no Pallas backward, it differentiates XLA's attention. When q, k and v are
all bfloat16 (the training launch) they are the tensor-core kernels
``flash_bwd_stats`` (each row's log-sum-exp and rowsum(dO ∘ O)), then
``flash_bwd_dq_tc`` and ``flash_bwd_dkdv_tc``; float32 and mixed launches
take the float32 CUDA-core kernels ``flash_bwd_dq`` then
``flash_bwd_dkdv``. Its plain twin is
`repro_torch.kernels.ref.flash_attention_bwd`; the gradient that joins the
two kernels is `repro_torch.kernels.ops.FlashAttention`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: head dims the library instantiates
HEAD_DIMS = (32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the split-key kernel's most query rows per (batch, KV head) and its key
#: tile (``kDecRows``, ``kDecKeys`` in csrc/flash_attention.cu)
SPLIT_ROWS, SPLIT_TILE = 16, 64
#: SMs of each device, read once
_SMS: dict = {}
#: split-key workspace per (device, stream): a float32 buffer whose first
#: ``counters`` words are the done-counters (0 between launches), then the
#: partials
_WORKSPACE: dict = {}


def split_plan(B: int, Hkv: int, Lq: int, Lk: int, window: int, sms: int):
    """(splits, keys a split, first key) of the split-key kernel: the keys
    the masks leave to some row, ``[key0, Lk)`` (queries are right-aligned,
    so the last row sees key Lk − 1), cut into whole 64-key tiles so that
    the grid of B·Hkv·splits blocks is at least twice the ``sms`` SMs when
    the keys allow it."""
    key0 = max(0, Lk - Lq - window + 1) if window > 0 else 0
    keys = Lk - key0
    want = -(-2 * sms // (B * Hkv))
    per = max(SPLIT_TILE, keys // want // SPLIT_TILE * SPLIT_TILE)
    return max(1, -(-keys // per)), per, key0


def _workspace(dev: torch.device, stream: int, counters: int, floats: int):
    """(buffer, counter words) with at least ``counters`` zeroed counters
    and ``floats`` partial floats; allocated (zeroed) only when it grows."""
    key = (dev.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[1] < counters or ws[0].numel() - ws[1] < floats:
        have = (0, 0) if ws is None else (ws[1], ws[0].numel() - ws[1])
        cnt = -(-max(counters, have[0]) // 4) * 4   # keeps the partials 16-byte aligned
        ws = (torch.zeros(cnt + max(floats, have[1]), dtype=torch.float32,
                          device=dev), cnt)
        _WORKSPACE[key] = ws
    return ws


@functools.cache
def _launch_fn():
    """The library's launcher, typed once (a decode step calls it per layer)."""
    f = build.library("flash_attention").flash_attention_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [P] * 5 + [I] * 13 + [P] * 3
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    splits = per = key0 = 0
    done = part = None
    if Lq * (Hq // Hkv) <= SPLIT_ROWS:
        sms = _SMS.get(dev.index)
        if sms is None:
            sms = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
        splits, per, key0 = split_plan(B, Hkv, Lq, Lk, int(window), sms)
        buf, cnt = _workspace(dev, stream, B * Hkv,
                              B * Hkv * splits * Lq * (Hq // Hkv) * (D + 2))
        done = buf.data_ptr()
        part = done + 4 * cnt
    with torch.cuda.device(dev):
        err = _launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           ctypes.addressof(strides), B, Hq, Hkv, Lq, Lk, D,
                           int(bool(causal)), int(window), _DTYPES[q.dtype],
                           _DTYPES[k.dtype], splits, per, key0, done, part, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    build.count_launch(flash_attention)
    return out


flash_attention.launches = 0


@functools.cache
def _bwd_launch_fn():
    f = build.library("flash_attention_bwd").flash_attention_bwd_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [P] * 11 + [I] * 11 + [P] * 2
    f.restype = I
    return f


#: the most (query head, query tile) steps one ``flash_bwd_dkdv_tc`` block
#: walks where its KV head's group of query heads can be cut to stay under
DKDV_WALK = 128


@functools.lru_cache(maxsize=256)
def dkdv_splits(Hq: int, Hkv: int, Lq: int, Lk: int, causal: bool, window: int,
                walk: int) -> int:
    """The blocks among which ``flash_bwd_dkdv_tc`` cuts a KV head's group
    of query heads: the fewest (a divisor of the group) that keep the
    heaviest block's walk — the query tiles that see its 64 keys
    (``query_span`` in csrc/flash_attention_bwd.cu) times its heads —
    within ``walk`` steps, else one head a block. A function of the shape
    alone, so a launch's bits do not depend on the card."""
    group, off, tile = Hq // Hkv, Lk - Lq, 64
    most = 0
    for k0 in range(0, Lk, tile):
        k1 = min(k0 + tile, Lk)
        lo = min(Lq, max(0, k0 - off)) if causal else 0
        hi = min(Lq, max(0, k1 - 1 + window - off)) if window > 0 else Lq
        if hi > lo:
            most = max(most, -(-hi // tile) - lo // tile)
    return next(s for s in range(1, group + 1)
                if group % s == 0 and (most * (group // s) <= walk or s == group))


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every [.., .., L, D] row of ``t`` starts on a 16-byte boundary (the
    tensor-core kernels stage rows by 16-byte asynchronous copies)."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(t.stride(i) % step == 0 for i in range(3))


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True, window: int = 0):
    """Launch the gradient's kernels: given the forward's inputs, its output
    ``o`` and the loss's gradient ``do`` with respect to it (both [B, Hq,
    Lq, D] in q's dtype), return (dq, dk, dv) in q's, k's and v's shapes
    and dtypes, laid out ``[B, L, H, D]`` (as the forward's output, so the
    views `layers.attend` transposes back are contiguous).

    bf16 q and k/v take the tensor-core route: three kernels, every product
    a bf16 ``mma.sync`` with f32 sums, P and dS rounded to bf16 for the
    products that take them, dq, dk, dv rounded once; float32 and mixed
    dtypes take the float32 CUDA-core route. Either is deterministic: two
    launches give the same bits. ``do`` may be any strided view whose last
    dimension is contiguous; where it is not (a gradient autograd expanded
    from a scalar, stride 0), or on the bf16 route its rows are not 16-byte
    aligned, the wrapper makes a contiguous copy of it, the only copy it
    makes; q, k, v and o with unaligned rows are refused on that route. The
    row statistics go to an f32 workspace [2, B, Hq, Lq rounded up to 64]
    of its own."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash_attention_bwd kernel runs on CUDA, not {dev}")
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of the kernel's {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    tensor_cores = q.dtype == k.dtype == torch.bfloat16
    if do.numel() and ((do.shape[-1] > 1 and do.stride(-1) != 1)
                       or (tensor_cores and not _rows_aligned(do))):
        do = do.clone(memory_format=torch.contiguous_format)
    for t, name, shape in ((q, "q", (B, Hq, Lq, D)), (k, "k", (B, Hkv, Lk, D)),
                           (v, "v", (B, Hkv, Lk, D)), (o, "o", (B, Hq, Lq, D)),
                           (do, "grad_output", (B, Hq, Lq, D))):
        _check(t, name, shape, dev)
        if tensor_cores and t.numel() and not _rows_aligned(t):
            raise ValueError(f"{name}: bf16 rows must start on 16-byte boundaries, "
                             f"strides {t.stride()} at {t.data_ptr():#x}")
    if v.dtype != k.dtype:
        raise ValueError(f"k is {k.dtype} but v is {v.dtype}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o ({o.dtype}) and grad_output ({do.dtype}) must have "
                         f"q's dtype {q.dtype}")
    grad = lambda dt, H, L: torch.empty((B, L, H, D), dtype=dt, device=dev).transpose(1, 2)
    dq, dk, dv = grad(q.dtype, Hq, Lq), grad(k.dtype, Hkv, Lk), grad(k.dtype, Hkv, Lk)
    if Lq == 0 or B == 0:
        return dq, dk.zero_(), dv.zero_()
    if Lk == 0:
        return dq.zero_(), dk, dv
    # padded to whole 64-row tiles: each tile's run of statistics is 16-byte aligned
    stats = torch.empty((2, B, Hq, -(-Lq // 64) * 64), dtype=torch.float32, device=dev)
    splits = (dkdv_splits(Hq, Hkv, Lq, Lk, bool(causal), int(window), DKDV_WALK)
              if tensor_cores else 1)
    part = (torch.empty((2, splits, B, Hkv, Lk, D), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    strides = (ctypes.c_longlong * 24)(*(t.stride(i) for t in (q, k, v, o, do, dq, dk, dv)
                                         for i in range(3)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _bwd_launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               stats[0].data_ptr(), stats[1].data_ptr(),
                               ctypes.addressof(strides), B, Hq, Hkv, Lq, Lk, D,
                               int(bool(causal)), int(window), _DTYPES[q.dtype],
                               _DTYPES[k.dtype], splits,
                               None if part is None else part.data_ptr(), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    build.count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0

