"""Quickstart: build correlation sketches, estimate a join-correlation and
get a distribution-free confidence interval, with the PyTorch port.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""
import argparse

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import build_sketch, hoeffding_ci, sketch_join
from repro_torch.core import estimators as E
from repro_torch.core import hashing
from repro_torch.core.sketch import Agg
from repro_torch.engine.ingest import sketch_table


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = D.resolve(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # Two tables that share a join key (think: zip code), never joined.
    N = 50_000
    keys = rng.choice(1 << 30, size=N, replace=False).astype(np.uint32)
    xy = rng.multivariate_normal([0, 0], [[1, 0.8], [0.8, 1]],
                                 size=N).astype(np.float32)
    taxi_pickups = xy[:, 0]                  # table A: pickups per zip/hour
    keep = rng.random(N) < 0.4               # table B covers 40% of the keys
    precipitation = xy[keep, 1]              # table B: precipitation

    # Sketch each ⟨key, value⟩ column pair independently: O(n) memory each.
    t = lambda a: torch.from_numpy(a).to(dev)
    sk_a = build_sketch(hashing.keys_tensor(keys, dev), t(taxi_pickups),
                        n=256, agg=Agg.MEAN)
    sk_b = build_sketch(hashing.keys_tensor(keys[keep], dev), t(precipitation),
                        n=256, agg=Agg.MEAN)

    # Join the sketches (not the tables!) and estimate.
    sj = sketch_join(sk_a, sk_b)
    r = float(E.pearson(sj.a, sj.b, sj.mask))
    rho_s = float(E.spearman(sj.a, sj.b, sj.mask))
    ci = hoeffding_ci(sj.a[None], sj.b[None], sj.mask[None],
                      sj.c_low[None], sj.c_high[None], alpha=0.05)

    true_r = float(np.corrcoef(taxi_pickups[keep], precipitation)[0, 1])
    print(f"sketch join size        : {int(sj.m)} of n=256")
    print(f"estimated join rows     : {float(sj.join_size_estimate()):.0f} "
          f"(true {int(keep.sum())})")
    print(f"pearson  estimate       : {r:+.3f}   (true {true_r:+.3f})")
    print(f"spearman estimate       : {rho_s:+.3f}")
    # raw ρ_HFD bounds are unclipped (their length is the ranking risk
    # signal); clip for display since correlations live in [−1, 1]
    lo = max(float(ci.lo[0]), -1.0)
    hi = min(float(ci.hi[0]), 1.0)
    print(f"hoeffding 95% interval  : [{lo:+.3f}, {hi:+.3f}] "
          f"(raw length {float(ci.hi[0] - ci.lo[0]):.1f} — the s4 risk signal)")
    assert abs(r - true_r) < 0.2
    assert lo <= true_r <= hi

    # Whole-table ingest: every column of a table in one fused pass (the
    # key column hashed once, one shared sort per chunk), bit-identical to
    # sketching each column alone.
    stacked = sketch_table(keys, np.stack([taxi_pickups, xy[:, 1]]), n=256,
                           device=dev)
    assert torch.equal(stacked.key_hash[0], sk_a.key_hash)
    print(f"fused table ingest      : {stacked.key_hash.shape[0]} columns, "
          f"one program, bit-identical to the per-column build")


if __name__ == "__main__":
    main()
