"""Wrapper of the Hopper containment kernel (``csrc/containment.cu``).

Replaces the Pallas kernel ``repro.kernels.containment.containment_hits``
and its per-row vmap: one launch counts the exact key intersection of a
whole ``[B, nq]`` query batch with all ``[C, n]`` candidates. Semantics:
`repro_torch.kernels.ref.containment_hits_batched`, its plain twin.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sketch_join import MAX_N, check

#: shared memory a block may opt in to on an H100 (bytes)
SMEM_MAX = 232448
#: candidates a tile at most, and at least when C is small (one a warp:
#: the kernel's block is 32 warps, one an SM)
TILE, MIN_TILE = 128, 32
#: the longest query row: its table alone must fit one block
MAX_NQ = 8192
#: most query rows a pass (the payload's row field, ``kRowShift``)
MAX_ROWS = 4096
#: SMs of each device, read once
_SMS: dict = {}


class Plan(NamedTuple):
    """A launch's shape: ``rows`` query rows a pass (the last may hold
    fewer), ``passes`` of them (grid.y), a hash table of ``2**tbits``
    entries, ``tile`` candidates a tile, ``grid_x`` persistent blocks a
    pass and ``smem`` bytes of shared memory a block."""
    rows: int
    passes: int
    tbits: int
    tile: int
    grid_x: int
    smem: int


def _table_bits(rows: int, nq: int) -> int:
    """Entries for ``rows · nq`` keys at a load factor of at most ½."""
    return max(4, (2 * rows * nq - 1).bit_length())


def _smem(rows: int, nq: int, tile: int) -> int:
    """The table (8 bytes an entry), its filter (32 bits an entry) and the
    tile's counts."""
    return 12 * (1 << _table_bits(rows, nq)) + 4 * rows * tile


def plan(B: int, nq: int, C: int, sms: int) -> Plan:
    """The launch shape for ``B`` query rows of ``nq`` slots against ``C``
    candidates on a card of ``sms`` SMs: as many rows a pass as fit one
    block's shared memory, the passes evened out; tiles of 128 candidates,
    fewer (down to 32) when C would leave SMs without a tile; one block a
    tile up to one an SM."""
    if nq > MAX_NQ:
        raise ValueError(f"query rows of {nq} slots exceed the kernel's {MAX_NQ}")
    lo, hi = 1, max(1, min(B, MAX_ROWS))
    while lo < hi:      # the most rows whose table and tile fit
        mid = (lo + hi + 1) // 2
        if _smem(mid, nq, TILE) <= SMEM_MAX:
            lo = mid
        else:
            hi = mid - 1
    passes = -(-B // lo)
    rows = -(-B // passes)
    tile = TILE
    while tile > MIN_TILE and -(-C // tile) < sms:
        tile //= 2
    grid_x = max(1, min(-(-C // tile), sms))
    return Plan(rows, passes, _table_bits(rows, nq), tile, grid_x, _smem(rows, nq, tile))


def _launch_fn():
    f = build.library("containment").containment_hits_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [P] * 4 + [I] * 10 + [P, P]
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
    for t, name, dt, shape in ((q_kh, "q_kh", torch.int32, (B, nq)),
                               (q_mask, "q_mask", torch.float32, (B, nq)),
                               (c_kh, "c_kh", torch.int32, (C, n)),
                               (c_mask, "c_mask", torch.float32, (C, n))):
        check(t, name, dt, shape, dev)
    if B == 0 or C == 0 or n == 0 or nq == 0:
        return torch.zeros((B, C), dtype=torch.float32, device=dev)
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    p = plan(B, nq, C, sms)
    hits = torch.empty((B, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _launch_fn()(q_kh.data_ptr(), q_mask.data_ptr(),
                           c_kh.data_ptr(), c_mask.data_ptr(), B, nq, C, n,
                           p.rows, p.passes, p.tbits, p.tile, p.grid_x, p.smem,
                           hits.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"containment kernel launch failed: CUDA error {err}")
    build.count_launch(containment_hits_batched)
    return hits


containment_hits_batched.launches = 0
