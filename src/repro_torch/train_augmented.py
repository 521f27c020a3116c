"""Sketch-driven data augmentation for model training (paper Examples 1–2),
on the PyTorch port: the JAX package's ``examples/train_augmented.py``.

  1. a base regression dataset (keyed rows + a target);
  2. 32 candidate feature tables — two drivers of the target, partly
     covering its keys, and 30 noise tables — indexed with sketches;
  3. one top-k join-correlation query (`engine.query.query`, k = 4, s4)
     finds which tables carry signal for the target;
  4. the discovered columns are joined in and a linear regression is fit
     with and without them: the RMSE falls;
  5. a short LM training run: the smoke tinyllama trains 30 steps through
     the full train loop (`launch.train.train_loop`).

    PYTHONPATH=src python -m repro_torch.train_augmented [--device cpu]

Runs on the CUDA cards (one index shard on each; the training on the
first) unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import build_sketch, hashing
from repro_torch.data.pipeline import Table, sbn_pair
from repro_torch.engine import index as IX
from repro_torch.engine import query as Q
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import train_loop


def discover_and_augment(device=None):
    """The example's discovery step → (picked table ids, their r̂, RMSE
    without and with the picked features)."""
    rng = np.random.default_rng(11)
    n = 6000
    keys = rng.choice(1 << 30, size=n, replace=False).astype(np.uint32)
    # target = f(two latent drivers) + noise
    z1 = rng.standard_normal(n).astype(np.float32)
    z2 = rng.standard_normal(n).astype(np.float32)
    target = (0.8 * z1 - 0.6 * z2 + 0.3 * rng.standard_normal(n)).astype(np.float32)

    # candidate tables: the two drivers (partially covering the keys) + noise
    tables = [
        Table(keys=keys[: int(0.8 * n)], values=z1[: int(0.8 * n)], name="driver1"),
        Table(keys=keys[int(0.2 * n):], values=z2[int(0.2 * n):], name="driver2"),
    ]
    for i in range(30):
        _, ty, _, _ = sbn_pair(rng, n_max=n)
        tables.append(Table(keys=ty.keys, values=ty.values, name=f"noise{i}"))

    mesh = make_host_mesh(device=device)
    pad = ((len(tables) + len(mesh) - 1) // len(mesh)) * len(mesh)
    idx = IX.build_index(tables, n=256, pad_to=pad, device=mesh[0])
    shard = IX.shard_for_mesh(idx, mesh)
    qsk = build_sketch(hashing.keys_tensor(keys, mesh[0]),
                       torch.from_numpy(target).to(mesh[0]), n=256)
    s, g, r, m = Q.query(shard, qsk, mesh, Q.QueryConfig(k=4, scorer="s4"))
    picked = [int(i) for i in g.cpu().numpy()[:2]]
    r_hat = r.cpu().numpy()[:2]
    print(f"discovered features: {[tables[i].name for i in picked]} "
          f"(r̂ = {np.round(r_hat, 3)})")
    assert set(picked) == {0, 1}, "should discover both drivers"

    # join the discovered features (mean-imputed where keys are missing)
    feats = []
    for i in picked:
        t = tables[i]
        kmap = dict(zip(t.keys.tolist(), t.values.tolist()))
        col = np.array([kmap.get(int(k), 0.0) for k in keys], np.float32)
        feats.append(col)
    X0 = np.ones((n, 1), np.float32)
    X1 = np.column_stack([np.ones(n)] + feats).astype(np.float32)

    def rmse(X):
        w = np.linalg.lstsq(X, target, rcond=None)[0]
        return float(np.sqrt(np.mean((X @ w - target) ** 2)))

    r0, r1 = rmse(X0), rmse(X1)
    print(f"regression RMSE: {r0:.3f} → {r1:.3f} after augmentation "
          f"({(1 - r1 / r0) * 100:.0f}% better)")
    assert r1 < 0.6 * r0
    return picked, r_hat, r0, r1


def short_lm_training(device=None):
    """The example's second half: the smoke tinyllama trained 30 steps of
    4 × 64 tokens by `launch.train.train_loop`, no checkpoint → its losses."""
    print("\ntraining a reduced tinyllama for 30 steps (full train loop):")
    state, losses = train_loop("tinyllama-1.1b", smoke=True, steps=30, batch=4,
                               seq=64, ckpt_dir=None, log_every=10, device=device)
    print(f"loss {losses[0]:.3f} → {losses[-1]:.3f}")
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: every CUDA card)")
    device = ap.parse_args(argv).device
    discover_and_augment(device)
    short_lm_training(device)


if __name__ == "__main__":
    main()
