"""Logical-axis → mesh-axis sharding rules (MaxText-style).

The port of ``repro.sharding.rules``. Every parameter declares *logical*
axes (("layers", "embed", "mlp"), …). A rule table maps logical axes to
mesh axes, subject to two guards applied per array:

  * divisibility — an axis is only sharded if its size divides evenly by the
    mesh axis product (uneven vocab sizes like hymba's 32001 fall back to
    replication);
  * uniqueness — a mesh axis is consumed at most once per array.

Rules are resolved in priority order, so e.g. MoE weights give "expert" the
first claim on the ``model`` axis and d_ff only shards when experts didn't.
The tables are the reference's, copied as data. A mesh here is anything
with a ``.shape`` mapping of axis name → size in axis order
(`repro_torch.launch.mesh.NamedMesh`, abstract or not).

The reference's ``constrain``, ``set_activation_mesh`` and
``act_constrain`` are hints to XLA's sharding propagation inside a traced
function; the port places every block explicitly
(`repro_torch.sharding.array`), so they have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence, Tuple

# axis → candidate mesh axes, in decreasing priority.
# "fsdp" composite = ("pod", "data") — parameters/optimizer state are fully
# sharded across all data-parallel devices (ZeRO-3).
DEFAULT_RULES: Mapping[str, Sequence[Tuple[str, ...]]] = {
    "expert": (("model",),),
    "vocab": (("model",),),
    "mlp": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "qdim": (("model",),),        # fused H*hd projections (hymba's 25 heads)
    "kvdim": (("model",),),
    "embed": (("pod", "data"), ("data",)),
    "ssm_inner": (("model",),),
    "batch": (("pod", "data"), ("data",)),
    "seq": (),                    # sequence kept unsharded by default
    # long-context decode KV cache: prefer whatever axes the batch didn't take
    "cache_seq": (("pod", "data", "model"), ("model",), ("pod", "data"), ("data",)),
    "layers": (),
    "window": (),
    "state": (),
    "conv": (),
    "dt": (),
    "frames": (),
    "patches": (),
    None: (),
}

# priority when several logical axes compete for the same mesh axis
_PRIORITY = ("expert", "vocab", "mlp", "heads", "kv_heads", "qdim", "kvdim",
             "ssm_inner", "batch", "cache_seq", "embed")

#: activation-axis rules: the embedding dim of an activation is *not*
#: FSDP-sharded; only batch / heads / mlp-hidden / vocab dims shard
ACT_RULES: Mapping[str, Sequence[Tuple[str, ...]]] = {
    "batch": (("pod", "data"), ("data",)),
    "heads": (("model",),),
    "act_mlp": (("model",),),
    "vocab": (("model",),),
    "expert": (("model",),),
    # MoE expert-capacity dim: sharded over the data axes
    "moe_cap": (("pod", "data"), ("data",), ("model",)),
    None: (),
}


class PartitionSpec(tuple):
    """One entry per array dim: ``None`` (whole on every device), a mesh
    axis name, or a tuple of names (the dim split over their product,
    major to minor). Printed as JAX prints its ``PartitionSpec``; a spec
    shorter than the array leaves the trailing dims whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def spec_axes(spec: PartitionSpec, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """The mesh axes of each of ``ndim`` dims, as a tuple per dim (empty
    where the dim is whole)."""
    if len(spec) > ndim:
        raise ValueError(f"{spec} has more entries than the array's {ndim} dims")
    out = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        out.append(() if e is None else (e,) if isinstance(e, str) else tuple(e))
    return tuple(out)


def _mesh_size(mesh, axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def logical_to_pspec(logical_axes: Sequence[str | None], shape: Sequence[int],
                     mesh, rules=None) -> PartitionSpec:
    """Resolve one array's logical axes to a `PartitionSpec`."""
    rules = rules or DEFAULT_RULES
    if len(logical_axes) != len(shape):
        raise ValueError(f"logical axes {logical_axes} for shape {tuple(shape)}")
    taken: set = set()
    out: list = [None] * len(shape)
    # resolve in global priority order so competition is deterministic
    order = sorted(
        range(len(shape)),
        key=lambda i: _PRIORITY.index(logical_axes[i]) if logical_axes[i] in _PRIORITY else 99,
    )
    for i in order:
        ax = logical_axes[i]
        for cand in rules.get(ax, ()):  # type: ignore[arg-type]
            cand = tuple(c for c in cand if c in mesh.shape)
            if not cand or any(c in taken for c in cand):
                continue
            size = _mesh_size(mesh, cand)
            if size > 1 and shape[i] % size == 0:
                out[i] = cand if len(cand) > 1 else cand[0]
                taken.update(cand)
                break
    return P(*out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A `PartitionSpec` over a mesh: how an array's blocks lie on the
    mesh's devices (`repro_torch.sharding.array`)."""
    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one device's block of an array of ``shape``;
        raises `ValueError` where a sharded dim does not divide."""
        out = []
        for size, axes in zip(shape, spec_axes(self.spec, len(shape))):
            n = _mesh_size(self.mesh, axes)
            if size % n:
                raise ValueError(f"dim of size {size} does not divide over {axes} ({n} ways)")
            out.append(size // n)
        return tuple(out)


def named_sharding(logical_axes, shape, mesh, rules=None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_pspec(logical_axes, shape, mesh, rules))
