"""The port's sharding helpers (`repro_torch.sharding`, the named meshes of
`repro_torch.launch.mesh`) against the JAX package's on the CPU.

Specs and block shapes are held to the reference exactly, for all ten
configs at full size, on abstract meshes (no devices on either side):
every parameter's `PartitionSpec` (`param_pspecs`) and block shape
(`NamedSharding.shard_shape`), the activation rules on a few shapes, and
`batch_shardings` for a batch that divides and one that does not. Then the
port's blocks: `shard` / `gather` round-trip bit for bit (a replicated
leaf, hymba's indivisible vocab of 32001 falling back to replication),
and the block a device holds is the one JAX places there, checked once in
a subprocess with 8 forced CPU devices (``jax.device_put`` and
``addressable_shards`` only; nothing is compiled).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as JR
from repro.launch import mesh as JM
from repro.models import params as JMP
from repro.sharding import rules as JRU
from repro.train import train_step as JTS
from repro_torch.configs import registry as R
from repro_torch.launch import mesh as M
from repro_torch.models import params as MP
from repro_torch.sharding import array as SA
from repro_torch.sharding import rules as RU
from repro_torch.train import train_step as TS

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

MESHES = [((16, 16), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 8), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


def _by_path(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _by_path(v, path + (k,))
        else:
            yield path + (k,), v


def _both(tree_jax, tree_port):
    want = {tuple(k.key for k in p): v for p, v in jax.tree_util.tree_flatten_with_path(
        tree_jax, is_leaf=lambda x: isinstance(x, JP))[0]}
    got = dict(_by_path(tree_port))
    assert set(got) == set(want)
    return [(path, got[path], want[path]) for path in sorted(got)]


@pytest.mark.parametrize("shape,axes", MESHES, ids=lambda x: "x".join(map(str, x)))
def test_param_specs_and_block_shapes_match_reference(shape, axes):
    """All ten configs at full size: each leaf's spec equal to the
    reference's, entry for entry, and its block shape equal to JAX's."""
    am, jam = M.make_abstract_mesh(shape, axes), JM.make_abstract_mesh(shape, axes)
    assert am.devices is None and am.shape == dict(jam.shape)
    for arch in sorted(R.ARCHS):
        cfg = R.get_config(arch)
        specs = dict(MP._leaves(MP.param_specs(cfg)))
        shardings = dict(_by_path(MP.param_shardings(cfg, am)))
        for path, got, want in _both(JMP.param_pspecs(JR.get_config(arch), jam),
                                     MP.param_pspecs(cfg, am)):
            assert isinstance(got, RU.PartitionSpec)
            assert tuple(got) == tuple(want) and repr(got) == repr(want), (arch, path)
            s = specs[path].shape
            assert shardings[path].spec == got
            assert shardings[path].shard_shape(s) == JNamedSharding(jam, want).shard_shape(s), \
                (arch, path)


def test_activation_rules_and_batch_shardings_match_reference():
    jam = JM.make_abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    am = M.make_abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    cases = [(("batch", None, "heads", None), (8, 128, 32, 64)),
             (("batch", None, "act_mlp"), (6, 128, 5632)),
             (("batch", None, "vocab"), (4, 16, 32001)),
             (("expert", "moe_cap", None), (8, 40, 128)),
             (("moe_cap", "act_mlp"), (6, 64))]
    for axes, shape in cases:
        want = JRU.logical_to_pspec(axes, shape, jam, JRU.ACT_RULES)
        assert tuple(RU.logical_to_pspec(axes, shape, am, RU.ACT_RULES)) == tuple(want), axes
    for mesh_shape, names in MESHES:
        jm, pm = JM.make_abstract_mesh(mesh_shape, names), M.make_abstract_mesh(mesh_shape, names)
        # 8 rows in 2 microbatches divide on the small meshes; 6 rows in 2
        # (3 a microbatch) on none, so the batch is replicated
        for rows in (8, 6, 512):
            spec = {"tokens": jax.ShapeDtypeStruct((rows, 16), np.int32),
                    "labels": jax.ShapeDtypeStruct((rows, 16), np.int32)}
            want = JTS.batch_shardings(JR.get_config("tinyllama-1.1b"), jm, spec, 2)
            got = TS.batch_shardings(R.get_config("tinyllama-1.1b"), pm,
                                     {k: torch.empty(v.shape, device="meta")
                                      for k, v in spec.items()}, 2)
            for k in spec:
                assert tuple(got[k].spec) == tuple(want[k].spec), (mesh_shape, rows, k)
                shp = (2, rows // 2, 16)
                assert got[k].shard_shape(shp) == want[k].shard_shape(shp)


def test_partition_spec_prints_as_jax_and_pickles():
    import pickle
    for entries in [(), (None, "data"), ("model", ("pod", "data")), (None, None, "model")]:
        spec = RU.P(*entries)
        assert repr(spec) == repr(JP(*entries))
        assert pickle.loads(pickle.dumps(spec)) == spec and type(spec) is RU.PartitionSpec
    with pytest.raises(ValueError):
        RU.spec_axes(RU.P("data", None, "model"), 2)


def test_meshes():
    prod = M.make_production_mesh(device="cpu")
    assert prod.shape == {"data": 16, "model": 16} and len(prod.devices) == 256
    pod = M.make_production_mesh(multi_pod=True, device="cpu")
    assert pod.axis_names == ("pod", "data", "model") and pod.size == 512
    mesh = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.coords(3) == {"data": 1, "model": 1} and mesh.flat({"data": 1}) == 2
    with pytest.raises(ValueError):
        M.NamedMesh(("data", "data"), (2, 2))
    with pytest.raises(ValueError):
        M.NamedMesh(("data",), (2,), (torch.device("cpu"),))


@pytest.mark.parametrize("shape,axes,leaf", [
    ((2, 2), ("data", "model"), "replicated over model"),
    ((2, 2, 2), ("pod", "data", "model"), "hymba vocab 32001"),
    ((2, 2, 2), ("pod", "data", "model"), "composite and model"),
    ((1, 8), ("data", "model"), "replicated everywhere"),
])
def test_shard_gather_round_trip_bit_for_bit(shape, axes, leaf):
    mesh = M.make_mesh(shape, axes, device="cpu")
    logical, dims = {
        "replicated over model": (("layers", "embed"), (3, 64)),
        "hymba vocab 32001": (("vocab", "embed"), (32001, 64)),
        "composite and model": (("layers", "embed", "mlp"), (2, 64, 48)),
        "replicated everywhere": (("layers", "embed"), (3, 20)),
    }[leaf]
    sharding = RU.named_sharding(logical, dims, mesh)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(dims).astype(np.float32))
    st = SA.shard(x, sharding)
    assert len(st.blocks) == mesh.size
    assert all(tuple(b.shape) == sharding.shard_shape(dims) for b in st.blocks)
    assert torch.equal(SA.gather(st, "cpu"), x) and SA.copies_equal(st)
    # every copy is its own tensor: updating one block touches no other
    ptrs = {b.data_ptr() for b in st.blocks}
    assert len(ptrs) == mesh.size and x.data_ptr() not in ptrs
    n_distinct = len(SA.first_copies(sharding, len(dims)))
    if leaf == "hymba vocab 32001":
        assert tuple(sharding.spec) == (None, ("pod", "data")) and n_distinct == 4
    if leaf == "replicated over model":
        assert tuple(sharding.spec) == (None, "data") and n_distinct == 2
    if leaf == "replicated everywhere":
        assert n_distinct == 1
    assert torch.equal(SA.gather(st, "cpu", torch.bfloat16), x.to(torch.bfloat16))
    # the last device holds a later copy wherever the leaf is replicated:
    # changing it breaks the copies' equality and not the gathered array
    replicated = n_distinct < mesh.size
    st.blocks[-1].add_(1.0)
    assert SA.copies_equal(st) != replicated
    assert torch.equal(SA.gather(st, "cpu"), x) == replicated


_PLACEMENT = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
pos = {d.id: int(i) for i, d in enumerate(mesh.devices.reshape(-1))}
x = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
out = {}
for name, spec in [("pod_data,model", P(("pod", "data"), "model")),
                   ("model,pod_data", P("model", ("pod", "data"))),
                   ("data_pod,None,model", P(("data", "pod"), None, "model")),
                   ("None,data", P(None, "data"))]:
    arr = jax.device_put(x, NamedSharding(mesh, spec))
    out[name] = {pos[s.device.id]: [[sl.start or 0, sl.stop if sl.stop is not None else n]
                                    for sl, n in zip(s.index, x.shape)]
                 for s in arr.addressable_shards}
print(json.dumps(out))
"""


def test_block_order_matches_jax_placement():
    """The block each mesh position holds equals the one JAX places at that
    position of its mesh, for composite axes in both orders."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", _PLACEMENT], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    mesh = M.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    specs = {"pod_data,model": RU.P(("pod", "data"), "model"),
             "model,pod_data": RU.P("model", ("pod", "data")),
             "data_pod,None,model": RU.P(("data", "pod"), None, "model"),
             "None,data": RU.P(None, "data")}
    for name, spec in specs.items():
        sharding = RU.NamedSharding(mesh, spec)
        for flat in range(8):
            got = [[s.start, s.stop] for s in SA.block_slices(sharding, (8, 4, 6), flat)]
            assert got == want[name][str(flat)], (name, flat)
