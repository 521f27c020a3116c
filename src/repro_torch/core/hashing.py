"""Hash functions of Correlation Sketches (paper §3.1/§3.4), in PyTorch.

``h`` is MurmurHash3-32, the tuple identifier of a join key; ``h_u`` is
Fibonacci hashing of that identifier onto [0, 1).

PyTorch lacks shifts, addition and ``searchsorted`` on ``uint32``, so a
32-bit hash is held as ``int64`` in ``[0, 2³²)`` and every mixing step ends
with ``& MASK32`` (2³² − 1). The product of two 32-bit values does not fit in
``int64``, so `_mul32` multiplies by the constant's two 16-bit halves.

Keys enter as tensors of their bit pattern: ``int32`` holds a 32-bit key
(one 4-byte block), ``int64`` a 64-bit key (two little-endian blocks) —
`keys_tensor` makes them from numpy ``uint32``/``int32``/``uint64``/``int64``
arrays. Index planes and kernels carry hashes as the ``int32`` bit pattern
(`to_pattern`), which they only compare for equality.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

MASK32 = (1 << 32) - 1

# MurmurHash3 constants.
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M5 = 5
_N1 = 0xE6546B64
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35

#: Golden-ratio multiplier: floor(2^32 / phi), forced odd ⇒ bijective mod 2^32.
FIBONACCI_MULTIPLIER = 2654435769

DEFAULT_SEED = 0x9747B28C

#: Hash value reserved as the padding sentinel, in key space (PAD_KEY) and in
#: Fibonacci space (PAD_FIB): the all-ones 32-bit value, as in the reference.
#: `sentinel_safe` reserves both preimages.
SENTINEL_HASH = MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2³²`` for ``x`` in [0, 2³²) and a 32-bit constant ``c``,
    exact in ``int64``: each partial product stays below 2⁴⁸."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def _mix_block(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Mix one 4-byte block into the murmur3 state."""
    k = _mul32(k, _C1)
    k = _rotl32(k, 15)
    k = _mul32(k, _C2)
    h = h ^ k
    h = _rotl32(h, 13)
    return (_mul32(h, _M5) + _N1) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _F1)
    h = h ^ (h >> 13)
    h = _mul32(h, _F2)
    return h ^ (h >> 16)


def keys_tensor(keys, device=None) -> torch.Tensor:
    """A numpy key column as the tensor `murmur3_32` takes: 32-bit keys as
    their ``int32`` bit pattern, 64-bit keys as ``int64``."""
    keys = np.asarray(keys)
    if keys.dtype in (np.uint32, np.int32):
        arr = keys.view(np.int32)
    elif keys.dtype in (np.uint64, np.int64):
        arr = keys.view(np.int64)
    else:
        raise TypeError(f"unsupported key dtype {keys.dtype}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def murmur3_32(keys: torch.Tensor, seed: int = DEFAULT_SEED) -> torch.Tensor:
    """``h``: MurmurHash3-32 of integer keys (paper §3.1), elementwise.

    ``int32`` keys hash as one 4-byte block, ``int64`` keys as two
    little-endian blocks. Returns ``int64`` in [0, 2³²)."""
    if keys.dtype == torch.int32:
        h = torch.full(keys.shape, int(seed), dtype=torch.int64,
                       device=keys.device)
        h = _mix_block(h, keys.to(torch.int64) & MASK32)
        return _fmix32(h ^ 4)
    if keys.dtype == torch.int64:
        lo = keys & MASK32
        hi = (keys >> 32) & MASK32
        h = torch.full(keys.shape, int(seed), dtype=torch.int64,
                       device=keys.device)
        h = _mix_block(_mix_block(h, lo), hi)
        return _fmix32(h ^ 8)
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def murmur3_32_bytes(key: bytes, seed: int = DEFAULT_SEED) -> int:
    """Scalar murmur3-32 over raw bytes (the ingest path for string keys),
    matching the canonical smhasher implementation."""
    def mul(a, b):
        return (a * b) & MASK32

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & MASK32

    n = len(key)
    h = seed & MASK32
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(key[4 * i:4 * i + 4], "little")
        k = mul(rotl(mul(k, _C1), 15), _C2)
        h = (mul(rotl(h ^ k, 13), _M5) + _N1) & MASK32
    tail = key[nblocks * 4:]
    k1 = 0
    if len(tail) >= 3:
        k1 ^= tail[2] << 16
    if len(tail) >= 2:
        k1 ^= tail[1] << 8
    if len(tail) >= 1:
        k1 ^= tail[0]
        h ^= mul(rotl(mul(k1, _C1), 15), _C2)
    h ^= n
    h ^= h >> 16
    h = mul(h, _F1)
    h ^= h >> 13
    h = mul(h, _F2)
    h ^= h >> 16
    return h


def hash_string_keys(keys, seed: int = DEFAULT_SEED) -> np.ndarray:
    """murmur3-32 each (str|bytes) key → ``uint32`` array."""
    out = np.empty(len(keys), dtype=np.uint32)
    for i, k in enumerate(keys):
        out[i] = murmur3_32_bytes(k.encode("utf-8") if isinstance(k, str)
                                  else k, seed)
    return out


def fibonacci_u32(key_hash: torch.Tensor) -> torch.Tensor:
    """``h_u`` as a raw 32-bit value (``int64`` in [0, 2³²)): the golden-ratio
    multiplicative hash of h(k), whose order is the KMV order."""
    return _mul32(key_hash, FIBONACCI_MULTIPLIER)


def fibonacci_unit(key_hash: torch.Tensor) -> torch.Tensor:
    """``h_u(k)`` ∈ [0, 1) as float32 (paper §3.1/Fig. 2)."""
    return fibonacci_u32(key_hash).to(torch.float32) * (1.0 / 4294967296.0)


def unit_interval(fib_u32: torch.Tensor) -> torch.Tensor:
    """Raw Fibonacci values → [0, 1) float32, U(k) of the KMV estimators."""
    return fib_u32.to(torch.float32) * np.float32(1.0 / 4294967296.0)


def sentinel_safe(key_hash: torch.Tensor,
                  fib: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mask of hashes usable as sketch keys: neither the key-space sentinel
    nor the preimage of the Fibonacci-space sentinel. ``fib`` is
    `fibonacci_u32` of ``key_hash`` when the caller already has it."""
    if fib is None:
        fib = fibonacci_u32(key_hash)
    return (key_hash != SENTINEL_HASH) & (fib != SENTINEL_HASH)


def to_pattern(key_hash: torch.Tensor) -> torch.Tensor:
    """``int64`` hash in [0, 2³²) → its ``int32`` bit pattern."""
    return (((key_hash + 2**31) & MASK32) - 2**31).to(torch.int32)


def from_pattern(pattern: torch.Tensor) -> torch.Tensor:
    """``int32`` bit pattern → ``int64`` hash in [0, 2³²)."""
    return pattern.to(torch.int64) & MASK32
