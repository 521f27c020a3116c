"""Device meshes: the sharded engine's flat mesh (DESIGN.md §10) and
training's named mesh.

The engine's mesh is an ordered tuple of `torch.device`s. Shard ``d`` of a
column-sharded index keeps its block on ``mesh[d]`` and its launches go to
that device's queue; one process drives every shard, as the reference's
single controller drives its mesh through ``shard_map``.

Training's mesh (`NamedMesh`) names its axes, as ``jax.make_mesh`` does:
("data", "model") or ("pod", "data", "model"), with the devices in
row-major order of the axes (the last axis fastest). An abstract mesh has
axes and no devices, so the sharding rules can be evaluated for the
production meshes anywhere. Nothing here touches a device: building a mesh
only names them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class NamedMesh:
    """A mesh with named axes: ``axis_names`` and ``axis_sizes`` in order,
    and ``devices`` in row-major order of the axes (None for an abstract
    mesh). ``shape`` maps each name to its size, as a JAX mesh's does."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes) or len(set(self.axis_names)) != len(
                self.axis_names):
            raise ValueError(f"axes {self.axis_names} of sizes {self.axis_sizes}")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes {self.axis_sizes}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of {self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, flat: int) -> Dict[str, int]:
        """Each axis's index of the device at flat position ``flat``."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(flat, self.axis_sizes))))

    def flat(self, coords: Dict[str, int]) -> int:
        """The flat position of the device at ``coords`` (axes left out: 0)."""
        return int(np.ravel_multi_index(tuple(coords.get(a, 0) for a in self.axis_names),
                                        self.axis_sizes))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device: D.DeviceLike = None) -> NamedMesh:
    """A named mesh of ``prod(shape)`` devices, the counterpart of
    ``jax.make_mesh``: placed round-robin on the visible cards as
    `make_host_mesh` places shards (one card holds a 2 × 2 mesh), or all on
    ``device`` where it names one (``"cpu"``)."""
    shape = tuple(int(n) for n in shape)
    return NamedMesh(tuple(axis_names), shape, make_host_mesh(math.prod(shape), device))


def make_production_mesh(*, multi_pod: bool = False, device: D.DeviceLike = None) -> NamedMesh:
    """The reference's production layout: 16 × 16 (data, model), or 2 × 16
    × 16 (pod, data, model) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_abstract_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> NamedMesh:
    """A mesh of axes and no devices, for evaluating the sharding rules."""
    return NamedMesh(tuple(axis_names), tuple(int(n) for n in shape))
