"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor the JAX package, and its entry points refuse to run
without a device when no CUDA card is present."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_GUARD = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
assert len(mods) >= 60, mods
for new in ("core.containment", "engine.candidates", "kernels.containment",
            "kernels.postings", "engine.lifecycle", "kernels.hash_build",
            "core.estimators", "core.join", "core.ranking",
            "engine.scheduler", "quickstart", "configs", "configs.base",
            "configs.registry", "models", "models.params", "models.layers",
            "models.transformer", "kernels.flash_attention", "launch",
            "launch.mesh", "launch.serve", "serve_queries", "engine.query",
            "configs.shapes", "train_augmented", "configs.grok1_314b",
            "configs.hymba_1_5b", "configs.llama4_maverick_400b",
            "configs.llava_next_mistral_7b", "configs.phi3_mini_3_8b",
            "configs.qwen15_0_5b", "configs.rwkv6_3b",
            "configs.starcoder2_15b", "configs.tinyllama_1_1b",
            "configs.whisper_small", "train", "train.optimizer",
            "train.train_step", "train.checkpoint", "train.compression",
            "train.fault", "launch.train", "sharding", "sharding.rules",
            "sharding.array"):
    assert "repro_torch." + new in mods, new
from repro_torch.launch import mesh
for fn in ("NamedMesh", "make_mesh", "make_production_mesh", "make_abstract_mesh",
           "make_host_mesh", "as_mesh"):
    assert callable(getattr(mesh, fn)), fn
assert "jax" not in sys.modules, "jax was imported"
bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not bad, bad
print("ok", len(mods))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(_SRC))
    out = subprocess.run([sys.executable, "-c", _GUARD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """With no card, an entry point called without ``device=`` raises
    instead of falling back to the CPU."""
    from repro_torch import convert
    from repro_torch.data.pipeline import multi_column_group
    from repro_torch.engine import index as TI
    from repro_torch.engine import lifecycle as TL
    from repro_torch.engine import serve as TSV

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables = [multi_column_group(np.random.default_rng(0), n_cols=2,
                                 n_max=600)]
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.build_index(tables, n=16)
    index = TI.build_index(tables, n=16, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSV.Server(index)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSV.build_query_sketches([tables[0].keys], [tables[0].values[0]], n=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.index_from_reference(index.shard, index.names, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.LiveIndex(n=16)
    live = TL.LiveIndex(n=16, device="cpu")
    live.append(tables)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSV.Server(live)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.LiveIndex.load("unused")
    from repro_torch.launch import train as LT
    with pytest.raises(RuntimeError, match="CUDA"):
        LT.train_loop("tinyllama-1.1b", smoke=True, steps=1, batch=2, seq=16, ckpt_dir=None)


def test_library_and_scheduler_need_a_device_without_cuda(monkeypatch):
    """With no card, `topk_query` and the quickstart called without
    ``device=`` raise, as does the `Server` an `AsyncScheduler` would
    drive; with ``device="cpu"`` both run."""
    from repro_torch import quickstart
    from repro_torch.core import build_sketch, hashing, stack_sketches, topk_query
    from repro_torch.data.pipeline import multi_column_group
    from repro_torch.engine import index as TI
    from repro_torch.engine import serve as TSV
    from repro_torch.engine.scheduler import AsyncScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    keys = rng.choice(1 << 20, size=300, replace=False).astype(np.uint32)
    sk = lambda: build_sketch(hashing.keys_tensor(keys),
                              torch.from_numpy(rng.normal(size=300).astype(np.float32)),
                              n=16)
    q, cands = sk(), stack_sketches([sk(), sk()])
    with pytest.raises(RuntimeError, match="CUDA"):
        topk_query(q, cands, k=2)
    assert topk_query(q, cands, k=2, device="cpu").indices.shape == (2,)
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])
    tables = [multi_column_group(rng, n_cols=2, n_max=600)]
    index = TI.build_index(tables, n=16, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncScheduler(TSV.Server(index))
    srv = TSV.Server(index, device="cpu")
    with AsyncScheduler(srv, workers=1) as sched:
        qs = TSV.build_query_sketches([tables[0].keys], [tables[0].values[0]],
                                      n=16, device="cpu")
        assert sched.query(qs, timeout=60)[1].shape == (1, 10)
