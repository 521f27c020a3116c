"""Join-correlation query serving driver (the paper's end-to-end system),
on the PyTorch port.

Builds a sketch index over a synthetic table collection, shards it over
every device of the mesh (`repro_torch.launch.mesh.make_host_mesh`: one
shard per visible CUDA card) and serves top-k join-correlation queries,
reporting the latency percentiles of §5.5:

    PYTHONPATH=src python -m repro_torch.launch.serve --tables 2000 \\
        --queries 200 --sketch-size 256 --k 10 [--batch 32] [--device cpu]

``--batch 0`` runs the scan plan query by query; ``--batch B`` serves
through the batched `Server`. Runs on the CUDA card unless ``--device``
names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=1000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--sketch-size", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--estimator", default="pearson",
                    choices=("pearson", "spearman"))
    ap.add_argument("--scorer", default="s4", choices=("s1", "s2", "s4"))
    ap.add_argument("--rows-max", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0,
                    help="serve through the batched engine with this request "
                         "batch size (0 = sequential single-query loop)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: every CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.core import build_sketch, hashing
    from repro_torch.data.pipeline import Table, sbn_pair, skewed_pair
    from repro_torch.engine import index as IX
    from repro_torch.engine import plans as PL
    from repro_torch.engine import serve as SV
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device=args.device)
    rng = np.random.default_rng(args.seed)
    print(f"generating {args.tables} tables ...")
    tables, queries = [], []
    for i in range(args.tables):
        gen = sbn_pair if i % 2 == 0 else skewed_pair
        tx, ty, r, c = gen(rng, n_max=args.rows_max)
        tables.append(Table(keys=ty.keys, values=ty.values, name=f"t{i}"))
        if len(queries) < args.queries:
            queries.append(Table(keys=tx.keys, values=tx.values, name=f"q{i}",
                                 meta={"r": r}))

    ndev = len(mesh)
    pad = ((args.tables + ndev - 1) // ndev) * ndev
    t0 = time.time()
    idx = IX.build_index(tables, n=args.sketch_size, pad_to=pad,
                         device=mesh[0])
    if mesh[0].type == "cuda":
        torch.cuda.synchronize(mesh[0])
    build_s = time.time() - t0
    print(f"index built: {args.tables} columns, sketch n={args.sketch_size}, "
          f"{build_s:.1f}s ({args.tables/build_s:.0f} cols/s)")
    shard = IX.shard_for_mesh(idx, mesh)

    shape = PL.ShapePolicy(k_max=args.k)
    req = PL.Request(k=args.k, estimator=args.estimator, scorer=args.scorer)

    if args.batch > 0:
        # only buckets the request loop can actually select (≤ args.batch)
        buckets = tuple(b for b in (1, 8, 32) if b < args.batch) + (args.batch,)
        srv = SV.Server(idx, shape, request=req, buckets=buckets, mesh=mesh)
        srv.warmup(modes=("off",))
        qsks = SV.build_query_sketches([q.keys for q in queries],
                                       [q.values for q in queries],
                                       n=args.sketch_size, device=mesh[0])
        for s in range(0, len(queries), args.batch):
            srv.query_batch(qsks.map(lambda a, s=s: a[s:s + args.batch]))
        st = srv.throughput()
        print(f"batched serving (B≤{args.batch}): {st['queries']} queries in "
              f"{st['dispatches']} dispatches — per-query {st['per_query_ms']:.2f} ms, "
              f"{st['qps']:.0f} queries/sec, dispatch p50 {st['dispatch_p50_ms']:.1f} ms "
              f"p99 {st['dispatch_p99_ms']:.1f} ms")
        return

    ops = PL.request_operands(req)
    lat = []
    for i, qt in enumerate(queries):
        qsk = build_sketch(hashing.keys_tensor(qt.keys, mesh[0]),
                           torch.from_numpy(qt.values).to(mesh[0]),
                           n=args.sketch_size)
        t0 = time.time()
        s, g, r, m = (x.cpu().numpy() for x in PL.scan(
            *IX.query_arrays(qsk), shard, shape, ops))
        lat.append((time.time() - t0) * 1000)
        if i == 0:
            print("first query (incl. compile): "
                  f"{lat[0]:.1f} ms; top ids {g[:5]} r {np.round(r[:5], 3)}")
    lat = np.array(lat[1:]) if len(lat) > 1 else np.array(lat)
    print(f"query latency over {len(lat)} queries: "
          f"mean {lat.mean():.1f} ms  p50 {np.percentile(lat,50):.1f}  "
          f"p90 {np.percentile(lat,90):.1f}  p99 {np.percentile(lat,99):.1f}  "
          f"(paper §5.5: 94% < 100 ms on 1.5k tables)")


if __name__ == "__main__":
    main()
