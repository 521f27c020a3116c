"""The device mesh of the sharded engine (DESIGN.md §10).

A mesh is an ordered tuple of `torch.device`s. Shard ``d`` of a
column-sharded index keeps its block on ``mesh[d]`` and its launches go to
that device's queue; one process drives every shard, as the reference's
single controller drives its mesh through ``shard_map``. Nothing here
touches a device: building a mesh only names them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import device as D

Mesh = Tuple[torch.device, ...]


def make_host_mesh(ndev: Optional[int] = None,
                   device: D.DeviceLike = None) -> Mesh:
    """A flat mesh of ``ndev`` shards (default: one per visible CUDA card).

    More shards than cards place them round-robin on the cards, so one
    card can hold a 4-shard mesh (the counterpart of the reference tests'
    forced host devices). ``device="cpu"`` puts every shard on the CPU
    (one shard by default); a named card (``"cuda:1"``) holds every shard.
    With no card and no ``device`` this raises, like every entry point of
    the port."""
    if ndev is not None and int(ndev) < 1:
        raise ValueError(f"a mesh needs at least one shard, not {ndev}")
    dev = D.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        cards = torch.cuda.device_count()
        n = int(ndev or cards)
        return tuple(torch.device("cuda", i % cards) for i in range(n))
    return (dev,) * int(ndev or 1)


def as_mesh(mesh=None, device: D.DeviceLike = None) -> Mesh:
    """The mesh an engine entry point serves on: ``mesh`` itself (a
    sequence of devices), or a one-device mesh of ``device`` (the CUDA card
    unless it names another)."""
    if mesh is None:
        return (D.resolve(device),)
    if device is not None:
        raise ValueError("pass a mesh or a device, not both")
    mesh = tuple(torch.device(d) for d in mesh)
    if not mesh:
        raise ValueError("an empty mesh")
    return mesh
