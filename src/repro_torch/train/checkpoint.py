"""Atomic, integrity-checked checkpoints of a `TrainState`, in the
reference's on-disk format.

The port of ``repro.train.checkpoint``. Layout (one directory per step):

    ckpt_dir/step_000123/
        manifest.json     — step, leaf paths, shapes, dtypes, crc32s
        arrays/<idx>.npy  — one file per leaf (the whole tensor)
        COMMITTED         — written last; absence ⇒ partial checkpoint

  * atomic: written into ``.tmp-step_*`` then renamed; a crash mid-write
    leaves no COMMITTED marker and `latest_step` skips it;
  * integrity-checked: crc32 of each leaf's bytes, verified on restore;
  * keep-N garbage collection.

The leaves are named and ordered as the reference names and orders its
``TrainState``'s: the paths are the strings JAX's ``keystr`` gives them
(``.params['blocks']['attn']['wk']`` … ``.opt.mu[…]``, ``.opt.nu[…]``,
``.opt.step``, ``.step``) in its flattening order (the dataclass fields in
order, each dict's keys sorted), and both step counts are int32 0-d arrays.
This module builds those strings itself (`leaf_items`). So a checkpoint
written by either package restores into the other, and for one state the
two manifests are equal.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.train import optimizer as OPT
from repro_torch.train.train_step import TrainState

COMMITTED = "COMMITTED"
#: the leaves that hold step counts: host integers in a `TrainState`
_STEPS = (".opt.step", ".step")


def _dict_items(tree: dict, prefix: str) -> Iterator[Tuple[str, object]]:
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            yield from _dict_items(v, path)
        else:
            yield path, v


def leaf_items(state: TrainState) -> Iterator[Tuple[str, object]]:
    """(path, leaf) of ``state`` in the reference's flattening order, each
    path as JAX's ``keystr`` writes it."""
    yield from _dict_items(state.params, ".params")
    yield from _dict_items(state.opt.mu, ".opt.mu")
    yield from _dict_items(state.opt.nu, ".opt.nu")
    yield ".opt.step", state.opt.step
    yield ".step", state.step


def _crc32(arr: np.ndarray) -> int:
    """Unsigned crc32 of the array's bytes in C order (= of
    ``arr.tobytes()``), the number the reference's manifest holds."""
    return zlib.crc32(np.ascontiguousarray(arr))


def _host(path: str, leaf) -> np.ndarray:
    if path in _STEPS:
        return np.asarray(int(leaf), np.int32)
    return leaf.detach().cpu().numpy()


def save(ckpt_dir: str, step: int, state: TrainState, keep: int = 3) -> str:
    """Write an atomic checkpoint of ``state`` as ``step``; returns its
    final path. Keeps the ``keep`` newest committed checkpoints."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)

    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(leaf_items(state)):
        arr = _host(path, leaf)
        np.save(os.path.join(tmp, "arrays", f"{i}.npy"), arr)
        manifest["leaves"].append({
            "path": path,
            "file": f"arrays/{i}.npy",
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc32": _crc32(arr),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    with open(os.path.join(tmp, COMMITTED), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _committed_steps(ckpt_dir: str) -> list:
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, COMMITTED)):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest committed checkpoint step, skipping partial writes."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, abstract_state: TrainState,
            device: D.DeviceLike = None) -> TrainState:
    """Load checkpoint ``step`` into a `TrainState` shaped as
    ``abstract_state`` (`train_step.abstract_state`: meta tensors), each
    leaf cast to its abstract dtype, on ``device`` (the CUDA card unless it
    names another). The steps come back as host integers.

    Raises `FileNotFoundError` without a committed checkpoint, `KeyError`
    for a leaf the checkpoint lacks, `IOError` on a crc mismatch and
    `ValueError` on a shape mismatch, as the reference does. The
    reference's ``shardings=`` (each leaf re-sharded over the current
    mesh) becomes ``device=``: the training mesh layout is not ported.
    """
    dev = D.resolve(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, COMMITTED)):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    loaded = {}
    for key, leaf in leaf_items(abstract_state):
        entry = by_path.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(path, entry["file"]))
        if _crc32(arr) != entry["crc32"]:
            raise IOError(f"crc mismatch for {key} — corrupted checkpoint")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model {tuple(leaf.shape)}")
        loaded[key] = (int(arr) if key in _STEPS
                       else torch.from_numpy(arr).to(dev, leaf.dtype))

    def tree(t: dict, prefix: str) -> dict:
        return {k: tree(v, f"{prefix}[{k!r}]") if isinstance(v, dict)
                else loaded[f"{prefix}[{k!r}]"] for k, v in t.items()}

    return TrainState(
        params=tree(abstract_state.params, ".params"),
        opt=OPT.AdamWState(mu=tree(abstract_state.opt.mu, ".opt.mu"),
                           nu=tree(abstract_state.opt.nu, ".opt.nu"),
                           step=loaded[".opt.step"]),
        step=loaded[".step"])


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = _committed_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
    # sweep stale tmp dirs from crashed writers
    for n in os.listdir(ckpt_dir):
        if n.startswith(".tmp-"):
            shutil.rmtree(os.path.join(ckpt_dir, n), ignore_errors=True)
