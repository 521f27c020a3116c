#!/usr/bin/env python3
"""Drive the PyTorch port's join-correlation query paths on one CUDA card.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``); it imports only
``torch``, numpy and the port (``src/repro_torch``). Phases, each fatal on
failure (exit code 1, no result line):

  1. device   — a CUDA card must be present; its name and power limit
                (``nvidia-smi``) are printed.
  2. build    — the port's CUDA kernels build from ``src/repro_torch/csrc``.
  3. index    — a seeded corpus of 4096 ``multi_column_group`` tables × 32
                numeric columns × 1024 rows (C = 131072 columns, keys drawn
                from 2³⁰) is sketched on the card at n = 256; the planes of
                its first 128 tables must equal a CPU build.
  4. kernels  — each kernel runs at the shapes the query path gives it (a
                32-query bucket against one 128-candidate score chunk) and
                must match its plain PyTorch twin on the same inputs: 1e-5
                (sketch join), 1e-6 spearman / 2e-5 rin (rank moments),
                5e-5 (Qn). The chunk holds all columns of 4 tables and each
                query is a column of one of them cut to fewer rows, so a
                quarter of the join rows join, with m from ~70 to 256. Each
                kernel is timed beside its twin and its bound.
  5. slice    — with every launch count at 0, `Server.warmup` and then
                `Server.query_columns` on 64 planted queries (a group's
                latent column, sharing its keys) for every scorer ×
                estimator; each kernel must have launched, every planted
                query must find its group's best column in its pearson/s1
                top 10 and only its group's columns in its pearson/s4 top
                10, and on a 4096-column sub-index the card's
                top-k must equal the CPU plain path's (ids except near-ties,
                r and scores within 5e-5, m exactly).
  6. stage-1 kernels — containment_hits (the 32-query bucket against all C
                candidates; hits exactly equal), postings_merge (the
                bucket's real postings windows at the corpus's W; the
                (id, count) sets of every row equal) and postings_select
                (the merge output at the base rung, which overflows, and at
                the covering rung; surv, valid and n_surv bit-equal), each
                against its twin, timed beside the twin, its bound and —
                for postings_select — ``torch.unique``.
  7. two-stage — with every launch count at 0, two servers on the same
                index, ``candidates="scan"`` and ``"auto"`` (= inverted at
                this C), warm every prune mode and serve the 64 planted
                queries: ``prune="off"``, ``"safe"`` through both sources
                for every scorer × estimator, and ``"topm"`` for
                pearson/s4. Every kernel must have launched; safe and topm
                top-k must equal off's (ids except near-ties, r and scores
                within 5e-5, m exactly; topm because prune_m = 128 exceeds
                every row's eligible count); ``stage1_hits`` must be equal
                between the sources; ``search_joinable`` must rank each
                query's own table first; and on the 4096-column sub-index
                the card's safe/topm results through both sources must
                equal the CPU plain path's.

Output: a ``slice`` JSON line (per-request and per-bucket times), a
``two_stage`` JSON line (off vs safe(scan) vs safe(inverted): per-request
seconds, dispatch p50/p99, qps, stage counters, survivor rungs), the card's
name and power limit, a ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch  # noqa: E402

from repro_torch.data.pipeline import multi_column_group  # noqa: E402
from repro_torch.engine import index as TI  # noqa: E402
from repro_torch.engine import plans as PL  # noqa: E402
from repro_torch.engine import serve as SV  # noqa: E402
from repro_torch.engine import candidates as CD  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import containment as CT  # noqa: E402
from repro_torch.kernels import postings as PM  # noqa: E402
from repro_torch.kernels import rank_transform as RT  # noqa: E402
from repro_torch.kernels import sketch_join as SJ  # noqa: E402

SEED = 0
GROUPS, COLS, ROWS, N = 4096, 32, 1024, 256
#: the kernels of the scan path, and those stage 1 adds
SCAN_KERNELS = ("sketch_join_moments", "rank_moments", "qn_correlation")
STAGE1_KERNELS = ("containment_hits", "postings_merge", "postings_select")
N_QUERIES = 64
SUB_C = 4096
BUCKET = 32
TOL = 5e-5
#: H100 SXM data-sheet peaks: HBM bytes/s and
#: float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(nbytes: float, nops: float):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the float32 rate."""
    tb, to = nbytes / HBM_BYTES_S, nops / FP32_OPS_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def check_close(name: str, got, want, tol: float) -> float:
    """Fail unless |got − want| ≤ tol + tol·|want| everywhere (the tests'
    rtol = atol = tol); return the largest absolute difference."""
    worst = 0.0
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs()
        if d.numel() and not bool((d <= tol + tol * w.double().abs()).all()):
            fail(f"{name} differs from its twin beyond {tol}: "
                 f"max |diff| {float(d.max())}")
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def corpus():
    rng = np.random.default_rng(SEED)
    return [multi_column_group(rng, n_cols=COLS, n_rows=ROWS, name=f"g{i}",
                               keep_latent=True) for i in range(GROUPS)]


def planted(groups):
    """64 queries: the latent column of every other one of the first 128
    groups, with the group's keys; and each group's best column id."""
    gids = [2 * i for i in range(N_QUERIES)]
    keys = [groups[g].keys for g in gids]
    vals = [groups[g].meta["latent"] for g in gids]
    best = [g * COLS + int(np.argmax(np.abs(groups[g].meta["r"]))) for g in gids]
    return keys, vals, best


def phase_index(groups, dev):
    t0 = time.perf_counter()
    index = TI.build_index(groups, n=N, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    sh = index.shard
    if sh.num_columns != GROUPS * COLS:
        fail(f"index has {sh.num_columns} columns")
    planes = sum(t.numel() * t.element_size() for t in (sh.key_hash, sh.values, sh.mask))
    cpu = TI.build_index(groups[:SUB_C // COLS], n=N, device="cpu").shard
    if not torch.equal(sh.key_hash[:SUB_C].cpu(), cpu.key_hash):
        fail("card-built key planes differ from the CPU build")
    if not torch.equal(sh.mask[:SUB_C].cpu(), cpu.mask):
        fail("card-built masks differ from the CPU build")
    for f in ("values", "col_min", "col_max", "rows"):
        err = float((getattr(sh, f)[:SUB_C].cpu() - getattr(cpu, f)).abs().max())
        if not err <= 1e-6:
            fail(f"card-built {f} differ from the CPU build by {err}")
    say(f"index: C={sh.num_columns} n={N} planes={planes / 2**20:.1f} MiB "
        f"build_s={t_build:.3f} (matches the CPU build on {SUB_C} columns)")
    return index


def kernel_inputs(groups, chunk: int):
    """A 32-query bucket and a chunk of candidate ids whose joins are not
    empty: the chunk is every column of T = ``chunk // COLS`` planted
    tables, and query b is column b // T of table b % T cut to its first
    ROWS − 24·b rows — a partial key overlap, so m varies from row to row."""
    if chunk % COLS:
        fail(f"the path's {chunk}-candidate chunk is not whole tables")
    tabs = [2 * i for i in range(chunk // COLS)]
    ids = [g * COLS + j for g in tabs for j in range(COLS)]
    keys, vals = [], []
    for b in range(BUCKET):
        g, rows = groups[tabs[b % len(tabs)]], ROWS - 24 * b
        keys.append(g.keys[:rows])
        vals.append(g.values[b // len(tabs), :rows])
    return keys, vals, ids


def phase_kernels(index, bucket, dev):
    """Each kernel at its main-path shapes against its twin; timings."""
    keys, vals, ids = bucket
    sk = SV.build_query_sketches(keys, vals, n=N, device=dev)
    q_kh, q_val, q_mask, _, _ = TI.query_arrays(sk)
    sh = index.shard
    sel = torch.as_tensor(ids, device=dev)
    c = tuple(t[sel].contiguous() for t in (sh.key_hash, sh.values, sh.mask))
    B, nq, C, n = BUCKET, q_kh.shape[1], len(ids), N
    rows = {}

    args = (q_kh, q_val, q_mask) + c
    got = SJ.sketch_join_moments_batched(*args)
    want = ref.sketch_join_moments_batched(*args)
    torch.cuda.synchronize()
    err = check_close("sketch_join kernel", got, want, 1e-5)
    nbytes = B * nq * 12 + C * n * 12 + B * C * 6 * 4 + 2 * B * C * nq * 4
    nops = B * C * nq * (math.log2(n) + 6)
    rows["sketch_join_moments"] = dict(
        source="src/repro_torch/csrc/sketch_join.cu",
        replaces="src/repro/kernels/sketch_join.py:99",
        max_abs_err=err,
        ms=cuda_ms(lambda: SJ.sketch_join_moments_batched(*args), 50),
        plain_ms=cuda_ms(lambda: ref.sketch_join_moments_batched(*args), 10),
        work=(nbytes, nops))

    _, aligned, hit = got
    qv = (q_val[:, None, :] * hit).reshape(-1, nq)
    a, w = aligned.reshape(-1, nq), hit.reshape(-1, nq)
    m = (w > 0).sum(-1).double()
    joined, joined2 = int((m > 0).sum()), int((m >= 2).sum())
    if joined < B * COLS:
        fail(f"{joined} of the kernel phase's rows joined, expected {B * COLS}")
    errs = []
    for kind, tol in (("spearman", 1e-6), ("rin", 2e-5)):
        g, wt = RT.rank_moments(qv, a, w, kind), ref.rank_moments(qv, a, w, kind)
        torch.cuda.synchronize()
        errs.append(check_close(f"rank_moments kernel ({kind})", [g], [wt], tol))
    R = qv.shape[0]
    rows["rank_moments"] = dict(
        source="src/repro_torch/csrc/rank_transform.cu",
        replaces="src/repro/kernels/rank_transform.py:213",
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: RT.rank_moments(qv, a, w, "spearman"), 50),
        plain_ms=cuda_ms(lambda: ref.rank_moments(qv, a, w, "spearman"), 10),
        # the mask of every row; a and b of the rows that joined
        work=(R * nq * 4 + joined * nq * 8 + R * 6 * 4, float(4 * (m * m).sum())))

    g, wt = RT.qn_correlation(qv, a, w), ref.qn_correlation(qv, a, w)
    torch.cuda.synchronize()
    err = check_close("qn_correlation kernel", [g], [wt], TOL)
    ml = m[m >= 2]
    lg = torch.log2(ml)
    rows["qn_correlation"] = dict(
        source="src/repro_torch/csrc/rank_transform.cu",
        replaces="src/repro/kernels/rank_transform.py:302",
        max_abs_err=err,
        ms=cuda_ms(lambda: RT.qn_correlation(qv, a, w), 20),
        plain_ms=cuda_ms(lambda: ref.qn_correlation(qv, a, w), 3),
        work=(R * nq * 4 + joined2 * nq * 8 + R * 4,
              float(4 * (ml * lg * lg / 2 + 31 * ml * lg).sum())))
    say(f"kernels: B={B} nq={nq} chunk={C} n={n} rows={R} joined_rows={joined} "
        f"m_range=[{int(m[m > 0].min())}, {int(m.max())}] — each matches its twin")
    return rows


def top_agree(want, got, what: str):
    ws, wi, wr, wm = want
    gs, gi, gr, gm = got
    fin = np.isfinite(ws)
    if not (np.array_equal(np.isfinite(gs), fin)
            and np.allclose(gs[fin], ws[fin], rtol=TOL, atol=TOL)
            and np.allclose(gr, wr, rtol=TOL, atol=TOL)
            and np.array_equal(gm, wm)):
        fail(f"{what}: top-k scores/r/m differ")
    for q, p in zip(*np.nonzero(gi != wi)):
        row = ws[q]
        if not any(abs(row[p] - row[j]) <= TOL
                   for j in (p - 1, p + 1) if 0 <= j < row.shape[0]):
            fail(f"{what}: query {q} rank {p}: id {gi[q, p]}, want "
                 f"{wi[q, p]}")


def device_busy(srv, keys, vals, req):
    """One request of one bucket under torch.profiler: wall ms, the share
    of it the card spent in kernels, and the kernels that took the most.
    The profiler slows the host, so the share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.query_columns(keys, vals, request=req)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return dict(wall_ms=wall_us / 1e3,
                busy_share=sum(by_name.values()) / wall_us if by_name else None,
                top_kernels_ms={n[:48]: us / 1e3 for n, us in top})


def phase_slice(index, keys, vals, best, dev):
    requests = [PL.Request(estimator=e, scorer=s)
                for e in PL.ESTIMATORS for s in PL.FAST_SCORERS]
    srv = SV.Server(index, buckets=(1, 8, BUCKET))
    ops.reset_launches()
    t0 = time.perf_counter()
    srv.warmup(modes=("off",))
    t_warm = time.perf_counter() - t0
    per_req = {}
    results = {}
    for req in requests:
        t0 = time.perf_counter()
        results[(req.estimator, req.scorer)] = srv.query_columns(keys, vals, request=req)
        per_req[f"{req.estimator}/{req.scorer}"] = time.perf_counter() - t0
    launches = ops.launches()
    if not all(launches[k] > 0 for k in SCAN_KERNELS):
        fail(f"a kernel of the path was not launched: {launches}")
    # the query joins only its own table: under pearson/s1 (rank by |r|)
    # the table's best column is in the top 10, and under pearson/s4 the
    # top 10 are columns of that table. (s4 scales |r| by 1 − the CI length
    # normalised over the row's eligible candidates, so the longest-CI
    # column scores 0 and the best |r| need not make the s4 top 10.)
    ids_s1 = results[("pearson", "s1")][1]
    ids_s4 = results[("pearson", "s4")][1]
    missed = [q for q in range(N_QUERIES) if best[q] not in ids_s1[q]]
    if missed:
        fail(f"planted columns missing from the pearson/s1 top-10: {missed}")
    strays = [q for q in range(N_QUERIES)
              if (ids_s4[q] // COLS != best[q] // COLS).any()]
    if strays:
        fail(f"pearson/s4 top-10 holds columns of other tables: {strays}")
    s4_hits = sum(best[q] in ids_s4[q] for q in range(N_QUERIES))
    for (est, sc), out in results.items():
        if not np.isfinite(out[0][:, 0]).all():
            fail(f"{est}/{sc}: a query found no eligible candidate")
    by_bucket = {}
    for B, nq, dt in srv.dispatch_log:
        by_bucket.setdefault(B, []).append((nq, dt))
    buckets = {str(B): dict(dispatches=len(v),
                            p50_ms=1e3 * float(np.median([d for _, d in v])),
                            qps=sum(q for q, _ in v) / sum(d for _, d in v))
               for B, v in sorted(by_bucket.items())}
    tp = srv.throughput()

    # the card against the CPU plain path on a sub-index
    sub = TI.SketchIndex(shard=TI.IndexShard(*(t[:SUB_C] for t in (
        index.shard.key_hash, index.shard.values, index.shard.mask,
        index.shard.col_min, index.shard.col_max, index.shard.rows))),
        names=index.names[:SUB_C], n=N)
    card = SV.Server(sub, buckets=(1, 8, BUCKET))
    plain = SV.Server(sub, buckets=(1, 8, BUCKET), device="cpu")
    t0 = time.perf_counter()
    for req in requests:
        what = f"sub-index {req.estimator}/{req.scorer}"
        top_agree(plain.query_columns(keys, vals, request=req),
                  card.query_columns(keys, vals, request=req), what)
    t_cpu = time.perf_counter() - t0
    busy = {f"{r.estimator}/{r.scorer}": device_busy(card, keys[:BUCKET], vals[:BUCKET], r)
            for r in (PL.Request(estimator="pearson"), PL.Request(estimator="qn"))}
    line = dict(columns=srv.C, n=N, queries=N_QUERIES, warmup_s=t_warm,
                request_s=per_req, buckets=buckets, qps=tp["qps"],
                dispatch_p50_ms=tp["dispatch_p50_ms"],
                dispatch_p99_ms=tp["dispatch_p99_ms"], launches=launches,
                profiled_sub_index_bucket=busy,
                best_in_s4_top10=s4_hits, sub_index_check_s=t_cpu)
    say("slice " + json.dumps(line))
    say(f"slice: {len(requests)} requests × {N_QUERIES} queries served; "
        f"planted tables found; card == CPU plain path on {SUB_C} columns")
    return launches


def phase_stage1_kernels(index, keys, vals, dev):
    """The stage-1 kernels at the two-stage path's shapes against their
    twins: the first 32 planted queries against the whole index."""
    sk = SV.build_query_sketches(keys[:BUCKET], vals[:BUCKET], n=N, device=dev)
    q_kh, _, q_mask, _, _ = TI.query_arrays(sk)
    sh = index.shard
    B, nq, C, n = BUCKET, q_kh.shape[1], sh.num_columns, N
    rows = {}

    args = (q_kh, q_mask, sh.key_hash, sh.mask)
    got = CT.containment_hits_batched(*args)
    want = ref.containment_hits_batched(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"containment_hits kernel differs from its twin in "
             f"{int((got != want).sum())} of {got.numel()} counts")
    if int((got >= COLS).sum()) < B * COLS:
        fail("the planted queries do not join their own tables' columns")
    # bytes: the candidate key and mask planes, the queries, the hits;
    # operations: one compare per element of a sorted merge of each pair
    rows["containment_hits"] = dict(
        source="src/repro_torch/csrc/containment.cu",
        replaces="src/repro/kernels/containment.py:68",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: CT.containment_hits_batched(*args), 20),
        plain_ms=cuda_ms(lambda: ref.containment_hits_batched(*args), 2, 1),
        library_ms=None,
        work=(C * n * 8 + B * nq * 8 + B * C * 4, float(B * C * (nq + n))))

    src = CD.InvertedSource(TI.build_postings(sh.key_hash, sh.mask), C=C, n=n)
    cand = PL.postings_window_candidates(q_kh, q_mask, src.keys, src.cols,
                                         src.W)
    L = cand.shape[1]
    mc, mn = PM.postings_merge(cand)
    wc, wn = ref.postings_merge(cand)
    torch.cuda.synchronize()
    dense = lambda c, k: CD.dense_hit_counts(c.cpu().numpy(), k.cpu().numpy(), C)
    if not (np.array_equal(dense(mc, mn), dense(wc, wn))
            and torch.equal((mc >= 0).sum(-1), (wc >= 0).sum(-1))):
        fail("postings_merge kernel: a row's (id, count) set differs from the twin's")
    if not np.array_equal(dense(mc, mn), got.cpu().numpy()):
        fail("postings_merge counts differ from the containment hits")
    rows["postings_merge"] = dict(
        source="src/repro_torch/csrc/postings.cu",
        replaces="src/repro/kernels/postings.py:173",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: PM.postings_merge(cand), 50),
        plain_ms=cuda_ms(lambda: ref.postings_merge(cand), 10),
        library_ms=None,
        # a comparison sort of every row
        work=(B * L * 12, float(B * L * math.log2(L))))

    floor = float(PL.request_operands(PL.Request())[3])
    n_surv = int(ref.postings_select(mc, mn, floor, 1)[2])
    rung = PL.prune_rung(n_surv, PL.ShapePolicy().prune_base, C)
    for M in (PL.ShapePolicy().prune_base, rung):
        g = PM.postings_select(mc, mn, floor, M, C)
        w = ref.postings_select(mc, mn, floor, M)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(g, w)):
            fail(f"postings_select kernel differs from its twin at rung {M}")
    elig = mc[(mc >= 0) & (mn >= floor)]
    rows["postings_select"] = dict(
        source="src/repro_torch/csrc/postings.cu",
        replaces="src/repro/kernels/postings.py:129",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: PM.postings_select(mc, mn, floor, rung, C), 50),
        plain_ms=cuda_ms(lambda: ref.postings_select(mc, mn, floor, rung), 10),
        library_ms=cuda_ms(lambda: torch.unique(elig, sorted=True), 50),
        work=(B * L * 8 + rung * 5 + 4, float(B * L)))
    say(f"stage-1 kernels: B={B} nq={nq} C={C} n={n} E={src.E} W={src.W} "
        f"L={L} n_surv={n_surv} rungs=({PL.ShapePolicy().prune_base}, {rung})"
        f" — each matches its twin")
    return rows


def _served(srv, sk, req):
    """One request: (results, host seconds, its dispatch latencies)."""
    n0 = len(srv.dispatch_log)
    t0 = time.perf_counter()
    out = srv.query_batch(sk, request=req)
    dt = time.perf_counter() - t0
    return out, dt, [t for _, _, t in list(srv.dispatch_log)[n0:]]


def _stages(srv):
    """{stage: (count, seconds)} of a server so far."""
    return {k: (v["count"], v["total_s"])
            for k, v in srv.throughput()["stages"].items()}


def phase_two_stage(index, keys, vals, dev):
    """prune="safe"/"topm" through both candidate sources against "off"."""
    sk = SV.build_query_sketches(keys, vals, n=N, device=dev)
    own = np.array([2 * i for i in range(N_QUERIES)])   # planted tables
    # one bucket size, so every mode serves the same 32-query dispatches
    srv = {c: SV.Server(index, PL.ShapePolicy(candidates=c), buckets=(BUCKET,))
           for c in ("scan", "auto")}
    if srv["auto"].candidates != "inverted":
        fail(f"candidates='auto' resolved to {srv['auto'].candidates} at C={srv['auto'].C}")
    t0 = time.perf_counter()
    for s in srv.values():
        s.warmup(modes=PL.PRUNE_MODES)
    t_warm = time.perf_counter() - t0
    stages0 = {c: _stages(s) for c, s in srv.items()}

    ops.reset_launches()
    requests = [PL.Request(estimator=e, scorer=sc)
                for e in PL.ESTIMATORS for sc in PL.FAST_SCORERS]
    modes = {"off": (srv["scan"], "off"), "safe(scan)": (srv["scan"], "safe"),
             "safe(inverted)": (srv["auto"], "safe"),
             "topm(scan)": (srv["scan"], "topm"),
             "topm(inverted)": (srv["auto"], "topm")}
    per_req = {m: {} for m in modes}
    lat = {m: [] for m in modes}
    results = {}
    for req in requests:
        name = f"{req.estimator}/{req.scorer}"
        for m, (server, prune) in modes.items():
            if prune == "topm" and name != "pearson/s4":
                continue
            out, dt, ls = _served(server, sk, dataclasses.replace(req, prune=prune))
            results[(m, name)] = out
            per_req[m][name] = dt
            lat[m] += ls
    hits = {c: s.stage1_hits(sk) for c, s in srv.items()}
    joins = {c: s.search_joinable(keys, k=COLS, metric="containment")
             for c, s in srv.items()}
    launches = ops.launches()
    if not all(v > 0 for v in launches.values()):
        fail(f"a kernel of the two-stage path was not launched: {launches}")

    for (m, name), out in results.items():
        if m != "off":
            top_agree(results[("off", name)], out, f"{m} {name} against off")
        if not np.isfinite(out[0][:, 0]).all():
            fail(f"{m} {name}: a query found no eligible candidate")
    if not np.array_equal(hits["scan"], hits["auto"]):
        fail("stage1_hits differ between the scan and inverted sources")
    for c, res in joins.items():
        if not (res.ids // COLS == own[:, None]).all():
            fail(f"search_joinable ({c}): a query's top {COLS} are not its own table")
    stages = {c: {k: dict(count=n - stages0[c].get(k, (0, 0.0))[0],
                          total_s=t - stages0[c].get(k, (0, 0.0))[1])
                  for k, (n, t) in _stages(s).items()}
              for c, s in srv.items()}
    survivors = [len(PL.select_survivors(hits["scan"][i:i + BUCKET], "safe"))
                 for i in range(0, N_QUERIES, BUCKET)]

    # the card against the CPU plain path on a sub-index, both sources
    sub = TI.SketchIndex(shard=TI.IndexShard(*(t[:SUB_C] for t in (
        index.shard.key_hash, index.shard.values, index.shard.mask,
        index.shard.col_min, index.shard.col_max, index.shard.rows))),
        names=index.names[:SUB_C], n=N)
    t0 = time.perf_counter()
    for c in ("scan", "inverted"):
        pol = PL.ShapePolicy(candidates=c)
        card = SV.Server(sub, pol, buckets=(1, 8, BUCKET))
        plain = SV.Server(sub, pol, buckets=(1, 8, BUCKET), device="cpu")
        for req in requests + [PL.Request(prune="topm")]:
            req = req if req.prune == "topm" else dataclasses.replace(req, prune="safe")
            top_agree(plain.query_columns(keys, vals, request=req),
                      card.query_columns(keys, vals, request=req),
                      f"sub-index {c} {req.prune} {req.estimator}/{req.scorer}: card vs CPU")
    t_cpu = time.perf_counter() - t0

    pct = lambda x, q: 1e3 * float(np.percentile(x, q))
    line = dict(
        columns=srv["scan"].C, n=N, queries=N_QUERIES, warmup_s=t_warm,
        request_s=per_req,
        dispatch_p50_ms={m: pct(v, 50) for m, v in lat.items()},
        dispatch_p99_ms={m: pct(v, 99) for m, v in lat.items()},
        qps={m: N_QUERIES * len(v) / sum(v.values()) for m, v in per_req.items()},
        stages=stages,
        # the scan server's "scan" stage also counts its off dispatches
        fallback_scans={
            "scan": stages["scan"].get("scan", {}).get("count", 0) - len(lat["off"]),
            "auto": stages["auto"].get("scan", {}).get("count", 0)},
        survivors_per_32_queries=survivors,
        safe_rung_scan=[PL.prune_rung(max(n, srv["scan"].k_max),
                                      PL.ShapePolicy().prune_base, srv["scan"].C)
                        for n in survivors],
        fused_rung=srv["auto"]._fused_rung, window=srv["auto"].source().W,
        launches=launches, sub_index_check_s=t_cpu)
    say("two_stage " + json.dumps(line))
    say(f"two-stage: off == safe(scan) == safe(inverted) for {len(requests)} "
        f"requests × {N_QUERIES} queries, topm == off for pearson/s4; "
        f"stage1_hits equal across sources; joinability finds own tables; "
        f"card == CPU plain path on {SUB_C} columns")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"device: {torch.cuda.get_device_name(0)} ({card}); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    ops.load_kernels(dev)
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for name in build.SOURCES:
        for ln in build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                say(f"  {name}: {ln.strip()}")

    t0 = time.perf_counter()
    groups = corpus()
    keys, vals, best = planted(groups)
    say(f"corpus: {GROUPS} tables × {COLS} columns × {ROWS} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    index = phase_index(groups, dev)
    bucket = kernel_inputs(groups, SV.Server(index, buckets=(BUCKET,)).chunk_for(BUCKET))
    del groups
    rows = phase_kernels(index, bucket, dev)
    launches = phase_slice(index, keys, vals, best, dev)
    rows.update(phase_stage1_kernels(index, keys, vals, dev))
    launches.update({k: v for k, v in phase_two_stage(index, keys, vals, dev).items()
                     if k in STAGE1_KERNELS})

    kernels = []
    for name, row in rows.items():
        b, by = bound_ms(*row.pop("work"))
        row.setdefault("library_ms", None)
        kernels.append(dict(name=name, route="cuda", launches=launches[name],
                            bound_ms=b, bound_by=by, **row))
    say(card)
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
