"""Arrays placed block by block over a named mesh: the counterpart of
``jax.device_put(x, NamedSharding(mesh, spec))``.

A `ShardedTensor` holds its global shape and dtype, its `NamedSharding`,
and one block per device of the mesh, in the mesh's flat order. A dim
sharded over mesh axes ``(a, b)`` is cut into ``|a|·|b|`` equal blocks and
the device at coordinates (i_a, i_b) holds block ``i_a·|b| + i_b`` (major to
minor in the tuple's order, as JAX places them); a dim whose spec entry is
``None`` is whole on every device. A mesh axis the spec does not use holds
replicated copies: distinct tensors with equal contents, each updated by
whoever updates the array, so they stay equal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.sharding.rules import NamedSharding, spec_axes


@dataclasses.dataclass
class ShardedTensor:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding
    blocks: List[torch.Tensor]


def block_index(sharding: NamedSharding, ndim: int, flat: int) -> Tuple[int, ...]:
    """The block the device at flat position ``flat`` holds: its index along
    each dim (0 along a whole dim)."""
    mesh, coords = sharding.mesh, sharding.mesh.coords(flat)
    out = []
    for axes in spec_axes(sharding.spec, ndim):
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + coords[a]
        out.append(i)
    return tuple(out)


def block_slices(sharding: NamedSharding, shape, flat: int) -> Tuple[slice, ...]:
    """The global index of the device at ``flat``'s block."""
    bshape = sharding.shard_shape(shape)
    return tuple(slice(i * b, (i + 1) * b)
                 for i, b in zip(block_index(sharding, len(shape), flat), bshape))


def first_copies(sharding: NamedSharding, ndim: int) -> List[int]:
    """The flat positions that hold the first copy of each distinct block,
    in flat order: every block once, a replicated block at its first
    device."""
    seen, out = set(), []
    for flat in range(sharding.mesh.size):
        key = block_index(sharding, ndim, flat)
        if key not in seen:
            seen.add(key)
            out.append(flat)
    return out


def shard(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``x`` cut into ``sharding``'s blocks, each copied onto its mesh
    device: a new tensor per device, replicated copies included."""
    if sharding.mesh.devices is None:
        raise ValueError("an abstract mesh holds no blocks")
    shape = tuple(x.shape)
    bshape = sharding.shard_shape(shape)
    blocks = [torch.empty(bshape, dtype=x.dtype, device=dev).copy_(
        x[block_slices(sharding, shape, f)]) for f, dev in enumerate(sharding.mesh.devices)]
    return ShardedTensor(shape, x.dtype, sharding, blocks)


def gather(st: ShardedTensor, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole array on ``device`` (cast to ``dtype`` when given), from
    the first copy of each block."""
    out = torch.empty(st.shape, dtype=dtype or st.dtype, device=device)
    for f in first_copies(st.sharding, len(st.shape)):
        out[block_slices(st.sharding, st.shape, f)].copy_(st.blocks[f])
    return out


def zeros(shape, dtype: torch.dtype, sharding: NamedSharding) -> ShardedTensor:
    """A sharded array of zeros."""
    bshape = sharding.shard_shape(shape)
    return ShardedTensor(tuple(shape), dtype, sharding,
                         [torch.zeros(bshape, dtype=dtype, device=d) for d in sharding.mesh.devices])


def copies_equal(st: ShardedTensor) -> bool:
    """Whether every replicated copy equals its block's first copy bit for
    bit."""
    first: Dict[Tuple[int, ...], torch.Tensor] = {}
    for f, b in enumerate(st.blocks):
        key = block_index(st.sharding, len(st.shape), f)
        if key in first and not torch.equal(first[key], b.to(first[key].device)):
            return False
        first.setdefault(key, b)
    return True


def _map(fn, tree, *others):
    """``fn(leaf, *others' leaves at its place)`` over a nested tree of
    dicts and dataclasses (such as a `TrainState`; a `ShardedTensor` is a
    leaf), ``others`` of the same structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, (type, ShardedTensor)):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(tree)})
    return fn(tree, *others)


def device_put(tree, shardings):
    """Every tensor of ``tree`` sharded by its entry of ``shardings`` (a
    tree of `NamedSharding`s of the same structure); other leaves (host
    step counts) pass through."""
    return _map(lambda x, s: shard(x, s) if isinstance(x, torch.Tensor) else x, tree, shardings)


def gather_tree(tree, device):
    """``tree`` with every sharded array gathered whole onto ``device``."""
    return _map(lambda x: gather(x, device) if isinstance(x, ShardedTensor) else x, tree)


def leaves(tree) -> List[ShardedTensor]:
    """The sharded arrays of a nested tree, in its order."""
    out: List[ShardedTensor] = []
    _map(lambda x: out.append(x) if isinstance(x, ShardedTensor) else None, tree)
    return out
