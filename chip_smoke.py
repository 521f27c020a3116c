#!/usr/bin/env python3
"""Drive the PyTorch port's join-correlation query paths (on one device
and column-sharded over a device mesh), its serving drivers, its legacy
query API and the paper's augmentation example, its LM
serving paths (dense, hybrid SSM, encoder–decoder, MoE, RWKV6) and LM
training (the attention's backward kernel, tinyllama-1.1b trained at full
size, resumed from a checkpoint under the training driver's supervisor
and sharded over a mesh, and grok-1's MoE layers on a mesh), on one CUDA
card.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``); it imports only
``torch``, numpy and the port (``src/repro_torch``). ``python3
chip_smoke.py --speed DIR`` instead compares this tree's kernels with
those of another checkout ``DIR`` in one call (see `speed`). Phases, each
fatal on failure (exit code 1, no result line):

  1. device   — a CUDA card must be present; its name and power limit
                (``nvidia-smi``) are printed.
  2. build    — the port's CUDA kernels build from ``src/repro_torch/csrc``.
  3. index    — a seeded corpus of 4096 ``multi_column_group`` tables × 32
                numeric columns × 1024 rows (C = 131072 columns, keys drawn
                from 2³⁰) is sketched on the card at n = 256 with the fused
                ingest engine (the default), which must launch hash_build;
                the loop engine's card build must equal it bit for bit
                (keys, masks, values and statistics: the corpus keys are
                unique), and the planes of its first 128 tables must equal
                a CPU build. Build seconds: fused (first and warm), loop.
  3b. hash_build — the kernel against its twin, all three outputs bit-equal,
                on the corpus's 4 194 304 keys, on one ingest batch's keys
                (the path's launch shape) and on edge keys (0, 2³² − 1 and
                the murmur preimages of the two sentinels; m = 4093); timed
                at the batch shape beside its twin and its bound (16 bytes
                a key), by CUDA events (the wrapper's issue rate) and by
                ``torch.profiler`` (the kernels' device time).
  4. kernels  — each kernel runs at the shapes the query path gives it (a
                32-query bucket against one 128-candidate score chunk) and
                must match its plain PyTorch twin on the same inputs: 1e-5
                (sketch join), 1e-6 spearman / 2e-5 rin (rank moments),
                5e-5 (Qn). The chunk holds all columns of 4 tables and each
                query is a column of one of them cut to fewer rows, so a
                quarter of the join rows join, with m from ~70 to 256. The
                sketch join also runs moments-only (its moments bit-equal to
                a full launch's) and at the 1- and 8-query buckets' shapes
                (the path's 512-candidate chunks). Each kernel is timed
                beside its twin and its bound. Qn is also
                checked and timed (CUDA events and ``torch.profiler``) at
                (b) a 128-candidate chunk that no row of the bucket joins
                and (c) the library's chunk (planted query 0 against 16384
                candidates), then at wider sketches (n = 512 and 2048;
                4096 rows of which 1024 join, and 16384 of which 32 do),
                and checked at edge rows (m = 0–3, all-tied values, m = n
                with and without ties, unjoined rows between joined ones;
                n = 7, 256, 257, 1000 and 2048). rank_moments is checked
                and timed (CUDA events and ``torch.profiler``) at (b) and
                at the wider sketches too.
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
                candidates, the 8- and 1-query buckets against all C, and
                the 32-query bucket against one delta segment's 16384
                columns; hits exactly equal), postings_merge (the
                bucket's real postings windows at the corpus's W, and the
                same rows folded into C = 131071, 45 and 1 with an id at
                C − 1, a row of −1 and a row of one id; cols and counts
                bit-equal, and the counts equal to the containment hits)
                and postings_select
                (the merge output at the base rung, which overflows, and at
                the covering rung, and at C = 131071, 1000 and 1 with an
                eligible id at C − 1; surv, valid and n_surv bit-equal),
                each against its twin, timed beside the twin, its bound and
                — for both postings kernels, also by ``torch.profiler`` —
                one ``torch.unique`` call (for the merge, of row·C + id over
                the live slots, with the counts).
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
  8. lifecycle — with every launch count at 0, a `LiveIndex(n=256,
                delta_cap=16384)` on the card appends groups 0–3839 in one
                call (8 segments, the last half full) and serves the 64
                planted queries through ``candidates="scan"`` and
                ``"auto"`` with ``prune="safe"`` and ``"off"``: s1/s2 top-k
                must equal a static `Server` over the index's first 122880
                columns. Groups 3840–4095 are appended mid-serving; planted
                queries on 8 of them must find their own table. The tables
                of 16 planted queries are deleted: none of their columns may
                reach a top-k, a `stage1_hits` count or `search_joinable`.
                `compact()` leaves one segment whose planes equal the
                index's at the surviving ids, bit for bit, and whose 12
                scorer × estimator ``safe`` requests and off pearson/s4
                equal a static `Server` over those columns. ``save`` and
                ``load`` round-trip every array bit for bit and serve an
                equal top-k. Every kernel must have launched. The same
                mutations over the first 128 tables (``delta_cap=1024``) on
                the card and on the CPU give equal top-k.

  4b. rank_transform — the kernel against its twin at the library path's
                shape (planted query 0's join samples against the first
                16384-candidate chunk) and at edge shapes (n = 1, 7, 257,
                2049, 4100: ties, NaNs, all-masked rows, and leading axes
                that are not contiguous, through ``ops``): ranks equal bit
                for bit with 0/1 masks, within 1e-5 with fractional
                weights. Timed beside its twin and its bound, by CUDA
                events and by ``torch.profiler``.
  9. library  — with every launch count at 0, the paper library's
                `topk_query` on the card for the 64 planted queries against
                the whole corpus (a candidate stack made from the index),
                for pearson, spearman, rin and qn × s1, s2 and s4, and
                pearson/s3 with the bootstrap on the 4096-column
                sub-corpus: rank_transform and qn_correlation must have
                launched, every planted best column must be in its
                pearson/s1 top 10, and on the sub-corpus the card must
                equal the CPU plain path (the 12 combinations for 4
                queries; s3 for 2 queries on 512 columns; ids except
                near-ties, r and scores within 5e-5, m exactly).
  10. scheduler — an `AsyncScheduler` over a static ``candidates="auto"``
                `Server`: with ``workers=1``, 16 tickets of mixed requests
                and widths each equal a direct `Server.query_batch` bit for
                bit; with ``workers=2``, open-loop Poisson arrivals of
                one-query ``safe`` tickets at 3× the sequential rate for
                10 s (goodput, ticket latency p50/p99, deadline misses at
                a 50 ms SLO, mean coalesce width, the dispatches made),
                and the same arrivals with one worker; then queries race
                appends, deletes and refreshes of a live index on the card
                (128 tables): no ticket may fail, and once the mutations
                stop the scheduler's results equal direct calls.
  10b. sharded — the phase-3 index column-sharded over a 4-shard mesh
                (`make_host_mesh(4)`: four shards on the one card, or one
                on each of four cards), with every launch count at 0: two
                servers (``candidates="scan"`` and ``"inverted"``) warm
                every prune mode and serve 32 planted queries (the latent
                columns of every 128th group, so each shard holds the
                targets of 8) for every
                scorer × estimator × prune mode (``off`` through the scan
                server: it is the same scan through either) and
                ``stage1_hits``; one 32-query off dispatch must launch the
                sketch join (and the rank or Qn kernel) 4 × one block's
                chunk count and ``stage1_hits`` the containment kernel
                once a shard. `distributed_build_table` sketches the first
                128 tables with their rows in 4 blocks over the mesh: key
                sets equal the fused build's, values within 1e-3, rows
                within 0.5. Every query kernel and hash_build must have
                launched (those counts join the ``kernels`` line). Then
                one-device servers on the same card serve the same
                requests: every result must be bit-identical (scores, ids,
                r, m, hit counts), and every shard must rank some column.
                The 32-query off dispatch is timed (CUDA events, p50/p99 of
                10) at 4 shards and on one device. Last, the two serving
                drivers run on the card: ``launch.serve --tables 2000
                --queries 200 --batch 32`` and ``serve_queries`` at its
                defaults.
  10c. legacy — the legacy query API on the phase-3 index, with every
                launch count at 0: (a) `engine.query.query()` for 8 of 32
                planted queries × the four estimators (s4) must equal
                each query's row of a 32-query `Server.query_batch` bit
                for bit and rank a column of its planted table first; each
                call launches the sketch join (and the rank or Qn kernel)
                once per 512-candidate chunk; p50/p99 of a call by CUDA
                events and by the host clock; (b) at B = 32,
                `make_query_fn` (four estimators), `make_stage1_fn` (==
                `Server.stage1_hits`) → `select_survivors` →
                `make_pruned_query_fn` at the covering rung, and
                `make_topm_query_fn` must equal `Server` bit for bit; (c)
                `QueryServer` on the index and `LiveQueryServer` on a
                `LiveIndex` of the lifecycle phase's shape (3840 tables, 8
                segments), each warmed and serving under ``off`` and
                ``safe``, equal `Server` bit for bit (the −inf rows'
                ids apart); (d) `query()` on the index sharded over a
                4-shard mesh equals one device bit for bit; (e) the
                augmentation example (`repro_torch.train_augmented`) on the
                card finds both drivers and cuts the RMSE below 0.6×; (f)
                its training half (`short_lm_training`: the smoke tinyllama,
                30 steps of 4 × 64 tokens through `launch.train`) gives 30
                finite losses and launches flash_attention 2 × 2 and its
                backward 2 times a step (those counts join the ``kernels``
                line). The sketch join, rank_moments, qn_correlation,
                containment_hits and hash_build must have launched.
  11. flash_attention — the kernel against its twin (2e-3 with a float32
                output, 2e-2 with bfloat16: the reference sweep's
                tolerances; 1e-4 at the prefill shape, where the split-TF32
                tensor-core path must keep float32 accuracy) at the LM
                path's prefill shape (q [4, 32, 2016, 64] f32, k/v [4, 4,
                2016, 64] f32, causal) and decode shape
                (q [4, 32, 1, 64] f32 over a [4, 4, 2048, 64] bf16 cache), the
                reference sweep's five cases, hymba's 25-over-5 heads at L =
                2048 with window 1024 and without, ragged edges (Lq = Lk
                = 37, Lq = 1, Lq > Lk causal, whose first rows see no key:
                0) and more shapes of the split-key decode kernel (2017
                keys, hymba's decode with window 1024, 4 positions × 4
                heads with window 16), and the launch shapes the hybrid and
                encoder-decoder paths add (whisper's non-causal encoder, q
                and k/v [4, 12, 1500, 64] f32; its cross-attention prefill,
                416 queries on 1500 keys, and decode, one query on the bf16
                cross cache; hymba's ring decode, q [4, 25, 1, 64] f32 on a
                full [4, 5, 1024, 64] bf16 ring; hymba's prefill, q [4, 25,
                2048, 64] on k/v [4, 5, 2048, 64] f32, causal; whisper's
                decoder self-attention, q and k/v [4, 12, 416, 64] f32,
                causal; hymba's global-layer decode, q [4, 25, 1, 64] f32
                on a [4, 5, 2080, 64] bf16 cache) and head dim 128 (grok's
                causal prefill, q [4, 48, 2048, 128] on k/v [4, 8, 2048,
                128] f32, and split-key decode, 48 query heads on 8 bf16 KV
                heads of 2080 positions; llama4's decode, 40 on 8), each
                also timed beside its twin, its bound and one SDPA call,
                with the compiler's registers and spills of the D = 128
                instantiations; timed at the dense
                path's two shapes beside its twin and its bound (at
                prefill the tensor-core route's: three
                TF32 products a float32 product at the TF32 rate, with the
                float32 CUDA-core bound beside it),
                by CUDA events and ``torch.profiler``, and beside one
                ``scaled_dot_product_attention`` call (a yardstick, never on
                the path; at the decode shape on the cache cast to float32
                before the timed calls, as SDPA takes one dtype).
  12. lm      — tinyllama-1.1b at full width (22 layers, f32 weights from
                SEED, bf16 cache as its config says) serves 4 prompts of
                2016 tokens from ``lm_batch``: ``prefill`` and 32 greedy
                ``decode_step``s; with every launch count at 0, the path
                must launch flash_attention 22 + 22 × 32 times. Checks: (a)
                the same calls with every attention on the twin (logits
                within LM_TOL of the largest, caches within 2e-2); (b) the
                reference's cache check in float32: prefill and decode
                logits equal ``forward_logits`` within 2e-3 and 5e-3 of the
                largest logit; (c) at 2 layers on 1 × 256 tokens, prefill
                and 4 decode steps equal the CPU plain path (LM_TOL).
  12b. lm_hybrid — hymba-1.5b at full width and depth (32 layers, 29 of
                them sliding-window 1024 with ring caches, 3 global; each
                attention ∥ a Mamba SSM) serves 4 × 2048-token prompts (8
                SSM chunks of 256) and 32 greedy steps: 32 + 32 × 32
                flash_attention launches; checks (a)–(c) as for lm, every
                cache field compared, (c) at 2 layers on 1280 tokens so the
                ring wraps; the SSM's and its doubling scan's card time by
                CUDA events around each call.
  12c. lm_encdec — whisper-small (12 encoder + 12 decoder layers) encodes
                4 × 1500 frames from ``lm_batch`` and serves the first 416
                target tokens + 32 greedy steps (its 448-token context):
                12 + 24 + 24 × 32 launches (encoder, self- and
                cross-attention); checks (a)–(c), (c) at 2 + 2 layers.
  12d. lm_moe — grok-1 at full width (d 6144, 48/8 heads of 128, 8
                experts top-2, d_ff 32768), 2 of its 64 layers (45.8 GB
                of f32 weights), serves 4 × 2048 tokens (capacity 2560 an
                expert, gather dispatch; the line counts the dropped
                slots) + 32 greedy steps (every expert, gate-weighted): 2
                + 2 × 32 launches; (b) on one sequence with dense MoE on
                both sides (capacity depends on a call's tokens), (c) at
                1 layer on 256 tokens after the served weights are
                released (the host's MemAvailable read first).
  12e. lm_moe_pair — llama4-maverick at full matrix widths: one (dense,
                MoE) pair, 64 of its 128 experts top-1 + a shared expert
                (42.1 GB); two attentions a pair, so 2 × (1 + 32)
                launches; (b) as for lm_moe, (c) with 8 experts.
  12f. lm_rwkv — rwkv6-3b at full width and depth (32 layers), 4 × 2048
                tokens (32 WKV chunks of 64) + 32 steps: no attention, no
                launch; the line adds the time mix's and the WKV's card
                ms by CUDA events. Every length is a multiple of 64 (the
                reference's chunk rule runs any other as one chunk): (b)
                pads the full sequence to one.
  13. attention_bwd — the attention gradient's kernel
                (``csrc/flash_attention_bwd.cu``) against its twin
                (`ref.flash_attention_bwd`; float32 within 1e-5 and
                bfloat16 within 2e-2 of each output's largest magnitude),
                and two launches bit-equal, at the training path's launch
                (tinyllama: q [2, 32, 2048, 64] bf16, k/v [2, 4, 2048,
                64], causal), the mesh replica's launch (q [1, 32, 2048,
                64]) and a sweep: head dims 32, 64, 96, 128 in
                both dtypes, window 1024, whisper's cross shape (416
                queries on 1500 keys, non-causal), ragged Lq < Lk and rows
                with no key; timed at the training launch (CUDA events and
                ``torch.profiler``) beside its twin, its bound (five
                products a kept pair at the BF16 tensor-core rate, the
                float32 CUDA-core figure beside it) and the backward
                alone of one SDPA call.
  14. train   — tinyllama-1.1b at full width and depth (22 layers, d 2048,
                32/4 heads, vocab 32000): f32 master weights from SEED,
                forward in bf16, 4 × 2048 tokens of the memorisable batch
                (tokens = position mod 17) in 2 microbatches, every layer
                recomputed in the backward, AdamW (lr 1e-3, warmup 5), 30
                steps with every launch count at 0. Checks: (i) the loss
                falls below half the first, every loss and gradient norm
                finite; (ii) every parameter leaf gets a finite, nonzero
                gradient; (iii) flash_attention launches 2 × 22 × 2 and
                its backward 22 × 2 a step; (iv) at 2 layers in float32
                on a short batch, the card's loss and every gradient leaf
                through the kernels equal the twin path's on the card and
                the CPU plain path's (TRAIN_TOL of each leaf's largest
                entry); (v) there 1 and 2 microbatches give the same
                gradients; (vi) two 3-step runs from SEED are bit-equal
                (library ops found not deterministic on the card are
                named, and then the runs may differ by RESTART_SHARE of
                the smallest step's lr). The line: step ms
                p50/p99 (CUDA events, steps 5–30), tokens/s, peak memory,
                one step's card ms in products, attention forward and
                backward, optimizer and the rest (``torch.profiler``).
  15. train_loop — the same model and 4 × 2048 tokens per step (from
                ``lm_batch`` and SEED) through the training driver
                (`launch.train.train_loop`, default AdamW), with every
                launch count at 0: (a) 6 steps uninterrupted; (b)
                `fault.run_with_restart` over 6 steps checkpointing every 3
                into a temporary directory (its free bytes printed first;
                under 2.2 × a state's 13.2 GB the phase fails), a failure
                injected after step 4 on the first call only. Checks: one
                restart, resumed at step 3; steps 3 and 6 committed; the
                resumed losses and the final state (parameters, both
                moments, both steps) equal to (a)'s by (vi)'s rule; every
                loss finite; the failed run's state released before the
                resumed run restores; flash_attention launched 14 × 2 × 22
                × 2 = 1232 times and its backward 616 (joining the
                ``kernels`` line). The line: each save's and the restore's
                seconds, the checkpoint's bytes, the free bytes, step ms
                p50 by the host clock, the straggler monitor's flags, the
                peak allocated bytes.
  16. train_mesh — the same model sharded over a 2 × 2 ("data", "model")
                mesh of the card (`launch.mesh.make_mesh`: four mesh
                devices on one H100, one queue; ZeRO-3 state by
                `train_step.state_shardings`), the memorisable 4 × 2048
                batch in 2 microbatches, 2 data replicas of one row each:
                (i) at 2 layers in float32, one `make_train_step(mesh=)`
                step against the one-device step (loss within 2e-5
                relative, gradient norm 1e-5, `tests/test_torch_train.py`'s
                tolerances) and `accumulate_grads_mesh` against
                `accumulate_grads` (1e-3 of each leaf's largest entry), the
                mesh step run twice bit-equal; (ii) at full depth in bf16,
                3 one-device steps, that state freed (checked by the bytes
                allocated), then 3 mesh steps with every launch count at
                0: each loss finite and within 1e-2 of the one-device
                run's, every replicated copy bit-identical after each step,
                flash_attention launched 2 × 22 × 2 × 2 = 176 times a step
                and its backward 88 (joining the ``kernels`` line); (iii)
                the sharded state saved (13.2 GB) and restored with
                ``shardings=`` onto a (4, 1) mesh and with ``device=`` onto
                the card: each, gathered, bit-equal to the saved state.
                The line: step ms p50 (CUDA events), tokens/s, peak
                memory, one step's card ms in gathers, gradient reduction,
                products, attention forward and backward, AdamW and the
                rest (``torch.profiler``), launches, save and restore
                seconds, the checks' largest differences.
  17. train_mesh_moe — grok-1 (hf:xai-org/grok-1) at its published
                attention, expert and vocab widths (d 6144, 48/8 heads of
                128, 8 experts top-2, capacity factor 1.25, vocab 131072),
                2 of 64 layers, d_ff 32768 → 4096 (2.99 B parameters,
                36 GB of f32 state), on the same mesh, batch and AdamW:
                (i) at d_ff 1024 in float32, `accumulate_grads_mesh`
                against `accumulate_grads` and one mesh step against one
                device's (train_mesh's tolerances), the mesh step twice
                bit-equal, slots dropped in the batch (capacity 1280 an
                expert over a microbatch's 4096 tokens), and a naive split
                (each replica its own capacity, 640, no offsets) more than
                10 × the loss tolerance from one device's loss; (ii) at
                the phase's cut in bf16, 3 one-device steps, freed, then 3
                mesh steps: losses within 1e-2 of one device's, copies
                bit-identical, 16 and 8 attention launches a step (joining
                the ``kernels`` line). The line: step ms p50 and
                tokens/s of both, peak memory, the slots dispatched per
                layer and C, the slots dropped per microbatch and layer
                by one device and by the mesh's routing records, one mesh
                step's card ms in gathers, reduction, products, MoE
                dispatch and combine, attention forward and backward,
                AdamW and the rest.

Output: a ``slice`` JSON line (per-request and per-bucket times), a
``two_stage`` JSON line (off vs safe(scan) vs safe(inverted): per-request
seconds, dispatch p50/p99 — for ``off`` also by estimator —, qps, stage
counters, survivor rungs), a
``lifecycle`` JSON line (append, delete, compact, save, load and refresh
seconds, appended columns/s, segment counts, and 32-query call p50/p99
with 8 segments and with 1), a ``library`` JSON line (ms per query per
estimator, launches), a ``scheduler`` JSON line (sequential qps, load
goodput, latencies, misses, coalescing, the race's ticket counts), a
``sharded`` JSON line (warmup and sweep seconds, launches, per-shard
launch counts, ranked ids per shard, the off dispatch p50/p99 at 4 shards
and on one device, the row-sharded build's error and seconds), the two
drivers' own lines, a ``legacy`` JSON line (calls, bit-identity checks,
single-query p50/p99 by CUDA events and the host clock, launches per
kernel, the augmentation example's picks and RMSE), an
``lm`` JSON line (prefill seconds and tokens/s, decode ms per step p50 and
p99, peak device memory, flash_attention launches, the checks' errors and
a profile of one prefill and one decode step: attention, matrix products,
the rest), ``lm_hybrid``, ``lm_encdec``, ``lm_moe``, ``lm_moe_pair`` and
``lm_rwkv`` JSON lines of the same form (hymba's with the SSM's and its
scan's card ms, whisper's with frames/s, the MoE lines with the prefill's
capacity and dropped slots, rwkv6's with the time mix's and WKV's ms),
an ``attention_bwd`` summary line, a ``train`` JSON line (the 30 losses and
gradient norms, step ms p50/p99, tokens/s, peak memory, launches a step,
checks (iv)–(vi), a one-step card profile),
a ``train_loop`` JSON line (save and restore seconds, checkpoint and free
bytes, host step ms, restarts, bit-equality, launches), a ``train_mesh``
JSON line (step ms, tokens/s, peak memory, a one-step card profile,
launches, save and restore seconds, checks (i)–(iii)), a
``train_mesh_moe`` JSON line (both step times, peak memory, the slots
dispatched and dropped, a one-step card profile, checks (i)–(ii)),
a ``phases`` JSON line (seconds per phase),
the card's name and power limit, a ``kernels`` JSON line, and as the last
line ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import inspect
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch  # noqa: E402

from repro_torch.core import hashing  # noqa: E402
from repro_torch.core import join as JN  # noqa: E402
from repro_torch.core import ranking as RK  # noqa: E402
from repro_torch.core.sketch import Agg, CorrelationSketch  # noqa: E402
from repro_torch.data.pipeline import multi_column_group  # noqa: E402
from repro_torch.engine import index as TI  # noqa: E402
from repro_torch.engine import ingest as TG  # noqa: E402
from repro_torch.engine import lifecycle as LC  # noqa: E402
from repro_torch.engine import plans as PL  # noqa: E402
from repro_torch.engine import serve as SV  # noqa: E402
from repro_torch.engine.scheduler import AsyncScheduler  # noqa: E402
from repro_torch.engine import candidates as CD  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.configs import registry as LMR  # noqa: E402
from repro_torch.data.pipeline import lm_batch  # noqa: E402
from repro_torch.kernels import containment as CT  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import params as LMP  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import optimizer as OPT  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.kernels import hash_build as HB  # noqa: E402
from repro_torch.kernels import postings as PM  # noqa: E402
from repro_torch.kernels import rank_transform as RT  # noqa: E402
from repro_torch.kernels import sketch_join as SJ  # noqa: E402
from repro_torch import serve_queries  # noqa: E402
from repro_torch import train_augmented  # noqa: E402
from repro_torch.engine import query as Q  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

SEED = 0
GROUPS, COLS, ROWS, N = 4096, 32, 1024, 256
#: the kernels of the scan path, those stage 1 adds, the live index's,
#: and the paper library's
SCAN_KERNELS = ("sketch_join_moments", "rank_moments", "qn_correlation")
STAGE1_KERNELS = ("containment_hits", "postings_merge", "postings_select")
LIFECYCLE_KERNELS = SCAN_KERNELS + STAGE1_KERNELS + ("hash_build",)
LIBRARY_KERNELS = ("rank_transform", "qn_correlation")
N_QUERIES = 64
SUB_C = 4096
BUCKET = 32
TOL = 5e-5
#: the lifecycle phase: groups of its first append, its delta capacity,
#: planted queries on groups appended mid-serving, planted queries whose
#: tables it deletes, and the corpus and delta capacity of its rehearsal
#: on both devices
LIVE_FIRST = GROUPS * 15 // 16
LIVE_CAP = GROUPS * COLS // 8
N_NEW = 8
N_DELETED = 16
MINI_GROUPS = SUB_C // COLS
MINI_CAP = SUB_C // 4
#: 32-query calls timed per latency sample set (safe, off)
LAT_CALLS = (8, 4)
#: rank_transform's edge widths and rows per width
EDGE_N = (1, 7, 257, 2049, 4100)
EDGE_ROWS = 48
#: qn_correlation's edge widths (a small one, the path's, one past a
#: warp's 256 values, one for four warps a scale, the widest the kernel
#: takes) and rows
QN_EDGE_N = (7, 256, 257, 1000, RT.MAX_N)
QN_EDGE_ROWS = 24
#: Qn also at wider sketches, the kernel's other paths: (n, rows, joined
#: rows), the kernel phase's bucket (many rows join) and the library's
#: chunk (few do)
QN_WIDE = ((512, 4096, 1024), (512, 16384, 32), (2048, 4096, 1024), (2048, 16384, 32))
#: postings_select's edge cases (C, M): C not a multiple of 32, with an
#: eligible id at C − 1, and C = 1
SELECT_EDGES = ((131071, 1024), (1000, 64), (1, 4))
#: the library's card-vs-CPU check: queries for the 12 combinations, and
#: queries and columns for s3
LIB_CPU_QUERIES = 4
BOOT_CPU = (2, 512)
#: the scheduler phase: mixed tickets, load seconds and multiple of the
#: sequential rate, SLO, tickets timed sequentially, live-race tables
SCHED_TICKETS = 16
LOAD_S = 10.0
LOAD_FACTOR = 3.0
SLO_MS = 50.0
SEQ_CALLS = 64
RACE_STEPS = 4
#: the sharded phase: its mesh's shards (on the cards round-robin), the
#: planted queries it serves, timed dispatches per side, and the tables of
#: its row-sharded build
SHARDS = 4
SHARD_QUERIES = 32
SHARD_TIMED = 10
SHARD_BUILD_TABLES = 128
#: the two drivers the sharded phase runs on the card, at their defaults
#: (launch.serve at the size its docstring gives)
SERVE_ARGS = ["--tables", "2000", "--queries", "200", "--batch", "32"]
#: the legacy phase: planted queries of its 32-query batch, those run one by
#: one, and the kernels its paths launch
LEGACY_QUERIES = 32
LEGACY_SINGLE = 8
LEGACY_KERNELS = SCAN_KERNELS + ("containment_hits", "hash_build")
#: the example's training half (`train_augmented.short_lm_training`): its
#: steps, each launching both attention kernels once a layer (and the
#: forward once more in the recomputation)
SHORT_STEPS = 30
LM_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd")
#: the LM phase: the config served at full width, prompts × prompt tokens
#: and greedy steps (2016 + 32 = tinyllama's published 2048-token
#: context), and the card-vs-CPU check's layers, tokens and steps
LM_CONFIG = LMR.get_config("tinyllama-1.1b")
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2016, 32
LM_CPU = (2, 256, 4)
#: the hybrid LM phase: hymba-1.5b at full width and depth, 4 × 2048-token
#: prompts + LM_NEW steps (8 SSM chunks of SSM_CHUNK, the reference's
#: default; the 1024-wide rings wrap, the 3 global caches hold 2080);
#: card vs CPU at 2 layers (a global and a windowed one) on 1280 tokens,
#: so the ring wraps there too
HYBRID_CONFIG = LMR.get_config("hymba-1.5b")
HYBRID_PROMPT = 2048
HYBRID_CPU = (2, 1280, 4)
SSM_CHUNK = 256
#: the encoder–decoder LM phase: whisper-small (12 + 12 layers), 4 × 1500
#: frames (its encoder context) from ``lm_batch``, the first 416 target
#: tokens + LM_NEW steps = its 448-token text context; card vs CPU at 2 +
#: 2 layers: (layers, prompt, steps, frames)
ENCDEC_CONFIG = LMR.get_config("whisper-small")
ENCDEC_FRAMES, ENCDEC_PROMPT = 1500, 416
ENCDEC_CPU = (2, 416, 4, 1500)
#: the MoE LM phase: grok-1 at full width (d 6144, 48/8 heads of 128, 8
#: experts top-2, d_ff 32768, vocab 131072), 2 of its 64 layers — 45.8 GB
#: of f32 weights; a third layer would need 65.5 — 4 × 2048-token prompts
#: (T = 8192: capacity 2560 an expert) + LM_NEW steps; check (b) on one of
#: the four sequences (dense dispatch materialises [T, E, d_ff]); card vs
#: CPU at 1 layer on 256 tokens (a ≈ 26 GB host copy)
MOE_CONFIG = dataclasses.replace(LMR.get_config("grok-1-314b"), num_layers=2)
MOE_PROMPT = 2048
MOE_CPU = (1, 256, 4, 0)
#: the interleaved-pair phase: llama4-maverick at full matrix widths (d
#: 5120, 40/8 heads of 128, d_ff 8192, vocab 202048, top-1 + a shared
#: expert), one (dense, MoE) pair = 2 of its 48 layers, 64 of its 128
#: experts — 42.1 GB of f32 weights; all 128 would be 74.3 — 4 × 2048
#: tokens (capacity int(1.25·8192/64) = 160); card vs CPU with 8 experts
PAIR_CONFIG = dataclasses.replace(LMR.get_config("llama4-maverick-400b-a17b"),
                                  num_layers=2, num_experts=64)
PAIR_CPU = (2, 256, 4, 0)
PAIR_CPU_EXPERTS = 8
#: the RWKV6 phase: rwkv6-3b at full width and depth (32 layers, d 2560, 40
#: heads of 64; 12.3 GB of f32 weights), 4 × 2048-token prompts (32 WKV
#: chunks of WKV_CHUNK) + LM_NEW steps. Lengths stay multiples of
#: WKV_CHUNK: the reference's chunk rule runs any other length as one
#: chunk, a [B, T, T, H, 64] tensor (≈ 170 GB at 2047 tokens)
RWKV_CONFIG = LMR.get_config("rwkv6-3b")
RWKV_PROMPT = 2048
RWKV_CPU = (2, 256, 4, 0)
WKV_CHUNK = 64
#: the training phase: tinyllama-1.1b at full width and depth, f32 master
#: weights, bf16 forward, TRAIN_BATCH × TRAIN_SEQ tokens in TRAIN_MB
#: microbatches, TRAIN_STEPS steps of AdamW (TRAIN_OPT); the step times
#: are read from step TRAIN_TIMED_FROM on
TRAIN_CONFIG = LMR.get_config("tinyllama-1.1b")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS, TRAIN_TIMED_FROM = 4, 2048, 2, 30, 5
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5)
#: checks (iv)–(v): (layers, sequences, tokens) of the cut float32 model;
#: check (vi): steps of each run
TRAIN_CUT = (2, 2, 256)
TRAIN_RESTART_STEPS = 3
#: the train_loop phase: the same model and tokens through the training
#: driver, LOOP_STEPS steps, a checkpoint every LOOP_EVERY, a failure after
#: step LOOP_FAIL_AT; the checkpoint directory needs LOOP_DISK_SHARE × a
#: state's bytes free (two committed checkpoints at once)
LOOP_STEPS, LOOP_EVERY, LOOP_FAIL_AT = 6, 3, 4
LOOP_DISK_SHARE = 2.2
#: the train_mesh phase: TRAIN_CONFIG's state sharded over a MESH_SHAPE mesh
#: of MESH_AXES on the card, the train phase's batch; (i) one step at
#: MESH_CUT layers in float32; (ii) MESH_STEPS steps at full depth; (iii)
#: the saved state restored onto MESH_ELASTIC and onto one device
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
MESH_ELASTIC = ((4, 1), ("data", "model"))
MESH_STEPS, MESH_CUT = 3, 2
#: the train_mesh_moe phase: grok-1 at its published attention, expert and
#: vocab widths, 2 of 64 layers and d_ff 32768 → 4096 (one full layer is
#: 4.92 B parameters, 59 GB of f32 state with AdamW's moments: none trains
#: on 80 GB); (i) at d_ff MOE_CHECK_DFF in float32, where one device's
#: gradients and the mesh's fit together
MOE_TRAIN_CONFIG = dataclasses.replace(LMR.get_config("grok-1-314b"), num_layers=2,
                                       d_ff=4096)
MOE_CHECK_DFF = 1024
#: (i): tests/test_torch_train.py:41's loss and gradient-norm tolerances
MESH_LOSS_TOL, MESH_NORM_TOL = 2e-5, 1e-5
#: (ii): each bf16 loss within this share of the one-device run's
MESH_BF16_TOL = 1e-2
#: (vi) where a library op of the step is not deterministic: the share of
#: the smallest step's lr that two runs may differ by
RESTART_SHARE = 0.1
#: (iv)–(v): max |difference| over each leaf's largest |entry|
TRAIN_TOL = 1e-3
#: the backward kernel against its twin, by dtype: of each output's
#: largest magnitude
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: the backward's kernels' names: flash_bwd_stats, flash_bwd_dq_tc and
#: flash_bwd_dkdv_tc (bf16, tensor cores), flash_bwd_dq and flash_bwd_dkdv
#: (float32 and mixed dtypes, CUDA cores)
BWD_KERNEL = "flash_bwd"
#: the bf16 route's kernels, each timed alone at the training launch (a
#: name fragment each) and each held to issue bf16 tensor-core products
#: (HMMA.16816.F32.BF16) and asynchronous copies (LDGSTS) in its SASS
BWD_PARTS = ("flash_bwd_stats", "flash_bwd_dq", "flash_bwd_dkdv")
BWD_TC_KERNELS = ("flash_bwd_stats", "flash_bwd_dq_tc", "flash_bwd_dkdv_tc")
BWD_SASS_OPS = ("HMMA.16816.F32.BF16", "LDGSTS")
#: name fragments of cuBLAS's matrix-product kernels (nvjet: its bf16
#: kernels on Hopper)
PRODUCT_KERNELS = ("gemm", "xmma", "cutlass", "nvjet")
#: (a) kernel path vs twin path and (c) card vs CPU: max |logit
#: difference| over the largest |logit|, the unit of (b)'s 2e-3 / 5e-3
LM_TOL = 2e-3
#: kernel vs twin, by output dtype: the reference sweep's tolerances
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
#: the name the attention kernels share: flash_fwd (many query rows) and
#: flash_fwd_split (decode), which combines its splits in its last blocks
FLASH_KERNEL = "flash_fwd"
#: the sketch join's other launch shapes: the one- and 8-query buckets
JOIN_BUCKETS = (1, 8)
#: H100 SXM data-sheet peaks: HBM bytes/s, float32 operations/s outside
#: the tensor cores, and dense TF32 and BF16 tensor-core operations/s
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
TF32_OPS_S = 495e12
BF16_OPS_S = 989e12
#: flash_fwd's split TF32: three TF32 products for each float32 product
SPLIT_TF32_PRODUCTS = 3
#: the attention kernel against its twin at the LM path's float32 prefill
#: shape (split TF32 keeps float32 accuracy; one TF32 product misses ~1e-3)
PREFILL_TOL = 1e-4
#: the flash_attention cases timed as well as checked: the launch shapes
#: of the hybrid and encoder-decoder paths
PATH_CASES = ("whisper encoder", "cross prefill", "cross decode", "hymba ring decode",
              "hymba prefill", "whisper self prefill", "hymba global decode",
              "grok prefill", "grok decode", "llama4 decode", "grok train replica")
#: postings_merge's edge cases: C (the path's rows folded into [0, C))
MERGE_EDGES = (131071, 45, 1)


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


def kernel_us(fn, reps: int = 1):
    """``reps`` calls of ``fn`` under ``torch.profiler`` (CUPTI): device
    µs per kernel name, the wall µs of the calls, and the launches recorded
    per kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name, counts = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            counts[e.name] = counts.get(e.name, 0) + 1
    return by_name, wall_us, counts


def profiled_ms(fn, reps: int, name: str, tries: int = 3):
    """Mean device time per call of ``fn`` in kernels whose name holds
    ``name`` (after one warm call); None unless one of ``tries`` sessions
    records them for every call: a session has come back with none or
    only some of the kernels' records, which would read low."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        by_name, _, counts = kernel_us(fn, reps)
        n = sum(c for k, c in counts.items() if name in k)
        if n and n % reps == 0:
            return sum(v for k, v in by_name.items() if name in k) / 1e3 / reps
    return None


def bound_ms(nbytes: float, nops: float, ops_s: float = FP32_OPS_S):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the route's rate (float32 CUDA cores unless
    ``ops_s`` says otherwise)."""
    tb, to = nbytes / HBM_BYTES_S, nops / ops_s
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


def _built(groups, dev, engine):
    t0 = time.perf_counter()
    index = TI.build_index(groups, n=N, engine=engine, device=dev)
    torch.cuda.synchronize()
    return index, time.perf_counter() - t0


def phase_index(groups, dev):
    ops.reset_launches()
    index, t_cold = _built(groups, dev, "fused")
    launched = ops.launches()["hash_build"]
    if not launched:
        fail("the fused index build did not launch hash_build")
    sh = index.shard
    if sh.num_columns != GROUPS * COLS:
        fail(f"index has {sh.num_columns} columns")
    planes = sum(t.numel() * t.element_size() for t in (sh.key_hash, sh.values, sh.mask))
    loop, t_loop = _built(groups, dev, "loop")
    for f in ("key_hash", "mask", "values", "col_min", "col_max", "rows"):
        if not torch.equal(getattr(sh, f), getattr(loop.shard, f)):
            fail(f"fused and loop card builds differ in {f}")
    del loop
    # the first build also loads every kernel it meets: time a warm one
    t_build = _built(groups, dev, "fused")[1]
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
        f"build_s={t_build:.3f} (fused, {launched} hash_build launches; "
        f"{t_cold:.3f} the first time) loop_build_s={t_loop:.3f} (fused == "
        f"loop on every plane; matches the CPU build on {SUB_C} columns)")
    return index


def _edge_keys():
    """0, 2³² − 1 and the murmur3 preimages of the key-space sentinel and of
    the Fibonacci sentinel's preimage (murmur3 is a bijection on 32-bit
    keys, so each step inverts)."""
    M = 1 << 32
    inv = lambda x: pow(int(x), -1, M)
    rotr = lambda x, r: ((x >> r) | (x << (32 - r))) & (M - 1)
    unxs = lambda y, s: y ^ (y >> s) ^ ((y >> s) >> s)

    def preimage(target):
        h = unxs(target, 16)
        h = unxs((h * inv(0xC2B2AE35)) % M, 13)
        h = unxs((h * inv(0x85EBCA6B)) % M, 16) ^ 4
        h = ((h - 0xE6546B64) * inv(5)) % M
        k = (rotr(h, 13) ^ 0x9747B28C) * inv(0x1B873593) % M
        return rotr(k, 15) * inv(0xCC9E2D51) % M

    fib_star = (0xFFFFFFFF * inv(2654435769)) % M
    return np.array([0, 0xFFFFFFFF, preimage(0xFFFFFFFF), preimage(fib_star)],
                    np.uint32)


def phase_hash_build(groups, dev):
    """hash_build against its twin on the corpus keys, one ingest batch's
    keys (the path's launch shape) and edge keys; timed at the batch."""
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
    corpus_keys = as_t(np.concatenate([g.keys for g in groups]))
    batch = TG._batches(groups)[0]
    batch_keys = as_t(np.stack([g.keys for g in batch]))
    edge = np.random.default_rng(SEED).integers(0, 1 << 32, size=4093,
                                                dtype=np.uint64).astype(np.uint32)
    edge[:4] = _edge_keys()
    edge_keys = as_t(edge)
    for what, keys in (("corpus", corpus_keys), ("batch", batch_keys), ("edge", edge_keys)):
        got, want = HB.hash_build(keys), ref.hash_build(keys)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"hash_build kernel differs from its twin on the {what} keys")
    h, fib, _ = HB.hash_build(edge_keys[:4])
    if int(h[2]) != -1 or int(fib[3]) != -1:
        fail("the sentinel preimages do not hash onto the sentinels")
    m = batch_keys.numel()
    row = dict(source="src/repro_torch/csrc/hash_build.cu",
               replaces="src/repro/kernels/hash_build.py:66", max_abs_err=0.0,
               ms=cuda_ms(lambda: HB.hash_build(batch_keys), 100),
               plain_ms=cuda_ms(lambda: ref.hash_build(batch_keys), 10),
               library_ms=None,
               # 4 bytes in, 12 out; murmur3 + Fibonacci + convert: 24
               # integer operations and 2 float ones a key
               work=(16 * m, 26.0 * m))
    row["device_ms"] = profiled_ms(lambda: HB.hash_build(batch_keys), 20, "hash_build")
    corpus_ms = cuda_ms(lambda: HB.hash_build(corpus_keys), 20)
    corpus_dev = profiled_ms(lambda: HB.hash_build(corpus_keys), 10, "hash_build")
    say(f"hash_build: corpus m={corpus_keys.numel()} ({corpus_ms:.4f} ms events, "
        f"{corpus_dev} ms device), batch {tuple(batch_keys.shape)} "
        f"({row['ms']:.4f} ms events, {row['device_ms']} ms device, twin "
        f"{row['plain_ms']:.4f} ms), edge m={edge_keys.numel()} — each equals "
        f"its twin bit for bit")
    return {"hash_build": row}


def kernel_inputs(groups, chunk: int, B: int = BUCKET):
    """A B-query bucket and a chunk of candidate ids whose joins are not
    empty: the chunk is every column of T = ``chunk // COLS`` planted
    tables, and query b is column b // T of table b % T cut to its first
    ROWS − 24·b rows — a partial key overlap, so m varies from row to row."""
    if chunk % COLS:
        fail(f"the path's {chunk}-candidate chunk is not whole tables")
    tabs = [2 * i for i in range(chunk // COLS)]
    ids = [g * COLS + j for g in tabs for j in range(COLS)]
    keys, vals = [], []
    for b in range(B):
        g, rows = groups[tabs[b % len(tabs)]], ROWS - 24 * b
        keys.append(g.keys[:rows])
        vals.append(g.values[b // len(tabs), :rows])
    return keys, vals, ids


def _join_args(index, bucket, dev):
    """The sketch join's operands for a bucket of ``kernel_inputs``."""
    bkeys, bvals, ids = bucket
    sk = SV.build_query_sketches(bkeys, bvals, n=N, device=dev)
    q_kh, q_val, q_mask, _, _ = TI.query_arrays(sk)
    sel = torch.as_tensor(ids, device=dev)
    sh = index.shard
    return (q_kh, q_val, q_mask) + tuple(t[sel].contiguous()
                                          for t in (sh.key_hash, sh.values, sh.mask))


def _join_row(args, with_aligned: bool):
    """The sketch join against its twin at ``args`` (1e-5), with the
    moments of a moments-only launch equal to a full launch's bit for bit;
    timed by CUDA events and ``torch.profiler`` beside its twin."""
    B, nq = args[0].shape
    C, n = args[3].shape
    got = SJ.sketch_join_moments_batched(*args)
    lean = SJ.sketch_join_moments_batched(*args, with_aligned=False)
    want = ref.sketch_join_moments_batched(*args)
    torch.cuda.synchronize()
    err = check_close(f"sketch_join kernel at B={B}, C={C}", got, want, 1e-5)
    if not torch.equal(lean[0], got[0]):
        fail(f"sketch_join at B={B}, C={C}: a moments-only launch's moments differ "
             f"from a full launch's")
    kern = lambda: SJ.sketch_join_moments_batched(*args, with_aligned=with_aligned)
    return dict(
        source="src/repro_torch/csrc/sketch_join.cu",
        replaces="src/repro/kernels/sketch_join.py:99",
        shape=dict(B=B, nq=nq, C=C, n=n, with_aligned=with_aligned),
        max_abs_err=err, ms=cuda_ms(kern, 50),
        device_ms=profiled_ms(kern, 20, "sketch_join_kernel"),
        plain_ms=cuda_ms(lambda: ref.sketch_join_moments_batched(
            *args, with_aligned=with_aligned), 10),
        # query and candidate planes in, moments (and aligned/hit) out
        work=(B * nq * 12 + C * n * 12 + B * C * 6 * 4
              + (2 * B * C * nq * 4 if with_aligned else 0),
              B * C * nq * (math.log2(n) + 6)))


def phase_kernels(index, buckets, keys, vals, dev):
    """Each kernel at its main-path shapes against its twin; timings.
    ``buckets``: `kernel_inputs` by bucket width (BUCKET and JOIN_BUCKETS);
    ``keys``/``vals``: the planted queries (the first is the library's)."""
    _, _, ids = buckets[BUCKET]
    args = _join_args(index, buckets[BUCKET], dev)
    q_kh, q_val, q_mask = args[:3]
    sh = index.shard
    sel = torch.as_tensor(ids, device=dev)
    B, nq, C, n = BUCKET, q_kh.shape[1], len(ids), N
    rows = {"sketch_join_moments": _join_row(args, True),
            "sketch_join_moments (moments only)": dict(_join_row(args, False),
                                                       kernel="sketch_join_moments")}
    for bw in JOIN_BUCKETS:
        rows[f"sketch_join_moments (B={bw})"] = dict(
            _join_row(_join_args(index, buckets[bw], dev), True), kernel="sketch_join_moments")
    got = SJ.sketch_join_moments_batched(*args)

    _, aligned, hit = got
    qv = (q_val[:, None, :] * hit).reshape(-1, nq)
    a, w = aligned.reshape(-1, nq), hit.reshape(-1, nq)
    m = (w > 0).sum(-1).double()
    joined, joined2 = int((m > 0).sum()), int((m >= 2).sum())
    if joined < B * COLS:
        fail(f"{joined} of the kernel phase's rows joined, expected {B * COLS}")
    R = qv.shape[0]
    # Qn and rank_moments at (a) this bucket, (b) a chunk of the bucket's
    # scan that no row joins (the next four tables), Qn also at (c) the
    # library's chunk (planted query 0 against the first RK.CHUNK columns),
    # then both at wider sketches, and Qn at edge rows
    c_b = tuple(t[sel + COLS].contiguous() for t in (sh.key_hash, sh.values, sh.mask))
    _, al_b, hit_b = SJ.sketch_join_moments_batched(q_kh, q_val, q_mask, *c_b)
    q0 = SV.build_query_sketches(keys[:1], vals[:1], n=N, device=dev).map(lambda t: t[0])
    sj = JN.sketch_join(q0, index_sketches(index, RK.CHUNK))
    qn_in = {"a": (qv, a, w),
             "b": ((q_val[:, None, :] * hit_b).reshape(-1, nq), al_b.reshape(-1, nq),
                   hit_b.reshape(-1, nq)),
             "c": (sj.a, sj.b, sj.mask.to(torch.float32))}
    rng = np.random.default_rng(SEED)
    for nw_, rw_, jw_ in QN_WIDE:
        qn_in[f"n{nw_}_{rw_}x{jw_}"] = _qn_wide_rows(rng, nw_, rw_, jw_, dev)

    rm_shapes = {}
    for key, (x, y, wm) in qn_in.items():
        if key == "c":
            continue
        errs = []
        for kind, tol in (("spearman", 1e-6), ("rin", 2e-5)):
            g, wt = RT.rank_moments(x, y, wm, kind), ref.rank_moments(x, y, wm, kind)
            torch.cuda.synchronize()
            errs.append(check_close(f"rank_moments kernel ({kind}) at shape ({key})", [g], [wt],
                                    tol))
        mk = (wm > 0).sum(-1).double()
        spear = lambda: RT.rank_moments(x, y, wm, "spearman")
        rm_shapes[key] = dict(
            rows=x.shape[0], n=x.shape[1], joined_rows=int((mk > 0).sum()), max_abs_err=max(errs),
            ms=cuda_ms(spear, 20), device_ms=profiled_ms(spear, 10, "rank_moments_kernel"),
            plain_ms=cuda_ms(lambda: ref.rank_moments(x, y, wm, "spearman"), 3),
            # the mask of every row, a and b of the rows that joined; what
            # the function needs of operations: a comparison sort of each
            # side (m·⌈log2 m⌉ compares) and the six sums of a valid slot
            work=(x.shape[0] * x.shape[1] * 4 + int((mk > 0).sum()) * x.shape[1] * 8
                  + x.shape[0] * 6 * 4,
                  float((2 * mk * torch.ceil(torch.log2(mk.clamp(min=1))) + 6 * mk).sum())))
    for sh_row in rm_shapes.values():
        sh_row["bound_ms"], sh_row["bound_by"] = bound_ms(*sh_row.pop("work"))
    rows["rank_moments"] = dict(
        source="src/repro_torch/csrc/rank_transform.cu",
        replaces="src/repro/kernels/rank_transform.py:213",
        max_abs_err=rm_shapes["a"]["max_abs_err"],
        ms=cuda_ms(lambda: RT.rank_moments(qv, a, w, "spearman"), 50),
        device_ms=rm_shapes["a"]["device_ms"],
        plain_ms=cuda_ms(lambda: ref.rank_moments(qv, a, w, "spearman"), 10),
        shapes=rm_shapes,
        # the mask of every row; a and b of the rows that joined
        work=(R * nq * 4 + joined * nq * 8 + R * 6 * 4, float(4 * (m * m).sum())))

    shapes, errs = {}, []
    for key, (x, y, wm) in qn_in.items():
        g, wt = RT.qn_correlation(x, y, wm), ref.qn_correlation(x, y, wm)
        torch.cuda.synchronize()
        errs.append(check_close(f"qn_correlation kernel at shape ({key})", [g], [wt], TOL))
        mk = (wm > 0).sum(-1).double()
        mk2 = mk[mk >= 2]
        lk2 = torch.log2(mk2)
        shapes[key] = dict(
            rows=x.shape[0], n=x.shape[1], joined_rows=int((mk >= 2).sum()), max_abs_err=errs[-1],
            ms=cuda_ms(lambda: RT.qn_correlation(x, y, wm), 20),
            device_ms=profiled_ms(lambda: RT.qn_correlation(x, y, wm), 10, "qn_kernel"),
            plain_ms=cuda_ms(lambda: ref.qn_correlation(x, y, wm), 3),
            work=(x.shape[0] * x.shape[1] * 4 + int((mk >= 2).sum()) * x.shape[1] * 8
                  + x.shape[0] * 4, float(4 * (mk2 * lk2 * lk2 / 2 + 31 * mk2 * lk2).sum())))
        del g, wt, x, y, wm
    del qn_in
    for ne in QN_EDGE_N:
        x, y, wm = _qn_edge_rows(rng, ne, dev)
        errs.append(check_close(f"qn_correlation kernel at edge rows, n={ne}",
                                [RT.qn_correlation(x, y, wm)], [ref.qn_correlation(x, y, wm)],
                                TOL))
    for sh_row in shapes.values():
        sh_row["bound_ms"], sh_row["bound_by"] = bound_ms(*sh_row.pop("work"))
    ml = m[m >= 2]
    lg = torch.log2(ml)
    rows["qn_correlation"] = dict(
        source="src/repro_torch/csrc/rank_transform.cu",
        replaces="src/repro/kernels/rank_transform.py:302",
        max_abs_err=max(errs),
        ms=shapes["a"]["ms"], device_ms=shapes["a"]["device_ms"],
        plain_ms=shapes["a"]["plain_ms"], shapes=shapes,
        work=(R * nq * 4 + joined2 * nq * 8 + R * 4,
              float(4 * (ml * lg * lg / 2 + 31 * ml * lg).sum())))
    say(f"kernels: B={B} nq={nq} chunk={C} n={n} rows={R} joined_rows={joined} "
        f"m_range=[{int(m[m > 0].min())}, {int(m.max())}]; sketch join also at B="
        f"{', '.join(f'{bw} (C={len(buckets[bw][2])})' for bw in JOIN_BUCKETS)} and "
        f"moments only; rank_moments also at ({', '.join(k for k in rm_shapes if k != 'a')}) "
        f"— each matches its twin")
    return rows


def index_sketches(index, cols=None) -> CorrelationSketch:
    """The index's first ``cols`` columns (all when None) as a stack of
    sketches for the paper library: values as MEAN accumulators of count
    1, so they finalise to the index's values exactly."""
    sh = index.shard
    sel = slice(0, cols)
    valid = sh.mask[sel] > 0
    return CorrelationSketch(
        key_hash=hashing.from_pattern(sh.key_hash[sel]), acc=sh.values[sel],
        cnt=valid.to(torch.float32), order=torch.zeros_like(sh.values[sel]),
        mask=valid, col_min=sh.col_min[sel], col_max=sh.col_max[sel],
        rows=sh.rows[sel], agg=Agg.MEAN)


def _edge_rows(rng, n, dev):
    """EDGE_ROWS rows of width n: ties, NaNs in valid and masked slots, two
    all-masked rows, 0/1 masks; and fractional weights with some zeros."""
    x = (np.round(rng.normal(size=(EDGE_ROWS, n)) * 3) / 3).astype(np.float32)
    x[0, : (n + 1) // 2] = np.nan
    x[5, ::3] = np.nan
    mask = (rng.random((EDGE_ROWS, n)) < 0.8).astype(np.float32)
    mask[1] = mask[4] = 0.0
    frac = rng.uniform(0.0, 1.0, size=(EDGE_ROWS, n)).astype(np.float32)
    frac[2, ::2] = 0.0
    frac[4] = 0.0
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(x), t(mask), t(frac)


def _qn_wide_rows(rng, n, R, joined, dev):
    """Qn rows wider than the path's sketches: R rows of width n of which
    ``joined`` (a multiple of 32) join, in runs of 32 spread evenly, as a
    table's columns join together; m uniform in [n/4, n]."""
    a = rng.normal(size=(R, n)).astype(np.float32)
    b = (0.6 * a + rng.normal(size=(R, n))).astype(np.float32)
    mask = np.zeros((R, n), np.float32)
    step = R // (joined // 32)
    for r in (s + i for s in range(0, joined // 32 * step, step) for i in range(32)):
        mask[r, rng.choice(n, rng.integers(n // 4, n + 1), replace=False)] = 1.0
    t = lambda x: torch.from_numpy(x).to(dev)
    return t(a), t(b), t(mask)


def _qn_edge_rows(rng, n, dev):
    """QN_EDGE_ROWS rows of width n ≥ 4: m = 0, 1, 2 and 3; valid values
    that all tie in a (scale 0, so r = 0) and in b; m = n without ties and
    with them; then rows of m = 0 or 1 between joined rows, so that one
    block of four rows holds both."""
    R = QN_EDGE_ROWS
    a = (np.round(rng.normal(size=(R, n)) * 2) / 2).astype(np.float32)
    b = (0.6 * a + rng.normal(size=(R, n))).astype(np.float32)
    mask = (rng.random((R, n)) < 0.75).astype(np.float32)
    for r in range(4):
        mask[r] = 0.0
        mask[r, rng.choice(n, r, replace=False)] = 1.0
    a[4] = 1.5
    b[5] = -0.25
    a[6] = rng.permutation(n) * 0.37 + 0.1
    b[6] = rng.permutation(n) * -0.61 + 2.0
    mask[6:8] = 1.0
    mask[8::2] = 0.0
    mask[8::4, rng.integers(n)] = 1.0
    t = lambda x: torch.from_numpy(x).to(dev)
    return t(a), t(b), t(mask)


def phase_rank_transform(index, keys, vals, dev):
    """rank_transform against its twin at the library path's shape and at
    edge shapes; timings."""
    q = SV.build_query_sketches(keys[:1], vals[:1], n=N, device=dev).map(lambda t: t[0])
    sj = JN.sketch_join(q, index_sketches(index, RK.CHUNK))
    x, w = sj.a, sj.mask.to(torch.float32)
    got, want = RT.rank_transform(x, w), ref.rank_transform(x, w)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("rank_transform kernel differs from its twin at the library shape")
    m = sj.m.double()
    live = int((m > 0).sum())
    if live < COLS:
        fail(f"only {live} rows of the library chunk joined planted query 0")
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for n in EDGE_N:
        xe, we, wf = _edge_rows(rng, n, dev)
        g, wt = RT.rank_transform(xe, we), ref.rank_transform(xe, we)
        torch.cuda.synchronize()
        if not torch.equal(g, wt):
            fail(f"rank_transform kernel differs from its twin at n={n}")
        if not (g[1] == 0).all() or not (g[4] == 0).all():
            fail(f"rank_transform kernel: a masked row is not zero at n={n}")
        worst = max(worst, check_close(f"rank_transform kernel, fractional weights, n={n}",
                                       [RT.rank_transform(xe, wf)],
                                       [ref.rank_transform(xe, wf)], 1e-5))
        # leading axes that are not contiguous, through ops
        big = torch.zeros((EDGE_ROWS, 2, n), device=dev)
        bigw = torch.zeros((EDGE_ROWS, 2, n), device=dev)
        big[:, 1], bigw[:, 1] = xe, we
        view = big[:, 1].unflatten(0, (2, EDGE_ROWS // 2))
        if view.is_contiguous():
            fail("the ops check's view is contiguous")
        g = ops.rank_transform(view, bigw[:, 1].unflatten(0, (2, EDGE_ROWS // 2)))
        torch.cuda.synchronize()
        if not torch.equal(g.reshape(EDGE_ROWS, n), wt):
            fail(f"ops.rank_transform over a non-contiguous view differs at n={n}")
    R, n = x.shape
    row = dict(source="src/repro_torch/csrc/rank_transform.cu",
               replaces="src/repro/kernels/rank_transform.py:130",
               max_abs_err=worst,
               ms=cuda_ms(lambda: RT.rank_transform(x, w), 50),
               device_ms=profiled_ms(lambda: RT.rank_transform(x, w), 20,
                                     "rank_transform"),
               plain_ms=cuda_ms(lambda: ref.rank_transform(x, w), 5),
               library_ms=None,
               # every weight, x of the rows that joined, every rank out;
               # two compares for each pair of valid slots of a live row
               work=(R * n * 8 + live * n * 4, float(2 * (m * m).sum())))
    say(f"rank_transform: library chunk R={R} n={n} live_rows={live} "
        f"({row['ms']:.4f} ms events, {row['device_ms']} ms device, twin "
        f"{row['plain_ms']:.4f} ms); edge n={list(EDGE_N)} × {EDGE_ROWS} rows "
        f"(ties, NaNs, masked rows, a non-contiguous view) — equal to its twin, "
        f"fractional weights within 1e-5 (max |diff| {worst})")
    return {"rank_transform": row}


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


def device_busy(fn):
    """One call of ``fn`` under torch.profiler: wall ms, the share of it
    the card spent in kernels, and the kernels that took the most. The
    profiler slows the host, so the share is a lower bound."""
    by_name, wall_us, _ = kernel_us(fn)
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
    busy = {f"{r.estimator}/{r.scorer}": device_busy(
                lambda r=r: card.query_columns(keys[:BUCKET], vals[:BUCKET], request=r))
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
    # also the 8- and 1-query buckets, and the 32-query bucket against one
    # delta segment of the live index (its first LIVE_CAP columns)
    ct_args = {"bucket": args}
    for bw in JOIN_BUCKETS:
        ct_args[f"B={bw}"] = (q_kh[:bw].contiguous(), q_mask[:bw].contiguous(), sh.key_hash,
                              sh.mask)
    ct_args["segment"] = (q_kh, q_mask, sh.key_hash[:LIVE_CAP], sh.mask[:LIVE_CAP])
    ct_shapes = {}
    for key, a_ in ct_args.items():
        g, wt = CT.containment_hits_batched(*a_), ref.containment_hits_batched(*a_)
        torch.cuda.synchronize()
        if not torch.equal(g, wt):
            fail(f"containment_hits kernel differs from its twin at shape ({key}) in "
                 f"{int((g != wt).sum())} of {g.numel()} counts")
        Bk, Ck = a_[0].shape[0], a_[2].shape[0]
        kern = lambda: CT.containment_hits_batched(*a_)
        ct_shapes[key] = dict(
            B=Bk, C=Ck, ms=cuda_ms(kern, 20), device_ms=profiled_ms(kern, 10, "containment"),
            plain_ms=cuda_ms(lambda: ref.containment_hits_batched(*a_), 2, 1),
            work=(Ck * n * 8 + Bk * nq * 8 + Bk * Ck * 4, float(Bk * Ck * (nq + n))))
        del g, wt
    for sh_row in ct_shapes.values():
        sh_row["bound_ms"], sh_row["bound_by"] = bound_ms(*sh_row.pop("work"))
    # bytes: the candidate key and mask planes, the queries, the hits;
    # operations: one compare per element of a sorted merge of each pair
    rows["containment_hits"] = dict(
        source="src/repro_torch/csrc/containment.cu",
        replaces="src/repro/kernels/containment.py:68",
        max_abs_err=0.0,
        ms=ct_shapes["bucket"]["ms"], device_ms=ct_shapes["bucket"]["device_ms"],
        plain_ms=ct_shapes["bucket"]["plain_ms"],
        library_ms=None, shapes=ct_shapes,
        work=(C * n * 8 + B * nq * 8 + B * C * 4, float(B * C * (nq + n))))

    src = CD.InvertedSource(TI.build_postings(sh.key_hash, sh.mask), C=C, n=n)
    cand = PL.postings_window_candidates(q_kh, q_mask, src.keys, src.cols,
                                         src.W)
    L = cand.shape[1]
    mc, mn = merge(PM.postings_merge, cand, C)
    wc, wn = merge(ref.postings_merge, cand, C)
    torch.cuda.synchronize()
    if not (torch.equal(mc, wc) and torch.equal(mn, wn)):
        fail("postings_merge kernel differs from its twin")
    dense = lambda c, k: CD.dense_hit_counts(c.cpu().numpy(), k.cpu().numpy(), C)
    if not np.array_equal(dense(mc, mn), got.cpu().numpy()):
        fail("postings_merge counts differ from the containment hits")
    # edge cases: the same rows with ids folded into [0, Ce), Ce − 1 in row
    # 0, a row of −1 only and a row of Ce − 1 repeated L times
    for Ce in MERGE_EDGES:
        ce = torch.where(cand >= 0, cand % Ce, -1)
        ce[0, :3], ce[1], ce[2] = Ce - 1, -1, Ce - 1
        g, w = merge(PM.postings_merge, ce, Ce), merge(ref.postings_merge, ce, Ce)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(g, w)):
            fail(f"postings_merge kernel differs from its twin at C={Ce}")
    # the library yardstick: one torch.unique of (row, id) keys of the live
    # slots, built outside the timed window; it must give the merge's pairs
    keys = (torch.arange(B, device=dev, dtype=torch.int64)[:, None] * C + cand)[cand >= 0]
    uniq = lambda: torch.unique(keys, sorted=True, return_counts=True)
    uk, uc = uniq()
    live = mc >= 0
    rows_ = torch.arange(B, device=dev, dtype=torch.int64)[:, None].expand(B, L)
    if not (torch.equal(uk, (rows_ * C + mc)[live]) and torch.equal(uc.float(), mn[live])):
        fail("torch.unique (the merge's yardstick) differs from the merge")
    kern = lambda: merge(PM.postings_merge, cand, C)
    rows["postings_merge"] = dict(
        source="src/repro_torch/csrc/postings.cu",
        replaces="src/repro/kernels/postings.py:173",
        max_abs_err=0.0,
        ms=cuda_ms(kern, 50),
        # the merge's own kernels (not the memset of its scratch)
        device_ms=profiled_ms(kern, 20, "postings_merge"),
        plain_ms=cuda_ms(lambda: merge(ref.postings_merge, cand, C), 10),
        library_ms=cuda_ms(uniq, 50),
        library="torch.unique(row * C + id, sorted=True, return_counts=True) over the "
                "live slots, keys built outside the timed window",
        # the ids in, cols and counts out; one bitmap mark a slot
        work=(B * L * 12, float(B * L)))

    floor = float(PL.request_operands(PL.Request())[3])
    n_surv = int(ref.postings_select(mc, mn, floor, 1)[2])
    base = PL.ShapePolicy().prune_base
    rung = PL.prune_rung(n_surv, base, C)
    for M in (base, rung):
        g = PM.postings_select(mc, mn, floor, M, C)
        w = ref.postings_select(mc, mn, floor, M)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(g, w)):
            fail(f"postings_select kernel differs from its twin at rung {M}")
    # edge cases: the same rows with ids folded into [0, Ce), one of them
    # Ce − 1; below floor counts stay ineligible
    for Ce, Me in SELECT_EDGES:
        ce = torch.where(mc >= 0, mc % Ce, -1)
        ce[0, 0], mn_e = Ce - 1, mn.clone()
        mn_e[0, 0] = floor
        g = PM.postings_select(ce, mn_e, floor, Me, Ce)
        w = ref.postings_select(ce, mn_e, floor, Me)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(g, w)):
            fail(f"postings_select kernel differs from its twin at C={Ce}, M={Me}")
    elig = mc[(mc >= 0) & (mn >= floor)]
    rows["postings_select"] = dict(
        source="src/repro_torch/csrc/postings.cu",
        replaces="src/repro/kernels/postings.py:129",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: PM.postings_select(mc, mn, floor, rung, C), 50),
        # the select's own kernels (not the memset of its scratch)
        device_ms=profiled_ms(lambda: PM.postings_select(mc, mn, floor, rung, C), 20,
                              "postings"),
        base_rung_ms=cuda_ms(lambda: PM.postings_select(mc, mn, floor, base, C), 50),
        base_rung_device_ms=profiled_ms(lambda: PM.postings_select(mc, mn, floor, base, C),
                                        20, "postings"),
        plain_ms=cuda_ms(lambda: ref.postings_select(mc, mn, floor, rung), 10),
        library_ms=cuda_ms(lambda: torch.unique(elig, sorted=True), 50),
        work=(B * L * 8 + rung * 5 + 4, float(B * L)))
    say(f"stage-1 kernels: B={B} nq={nq} C={C} n={n} E={src.E} W={src.W} "
        f"L={L} n_surv={n_surv} rungs=({base}, {rung}); containment_hits also at "
        f"B = {', '.join(str(b) for b in JOIN_BUCKETS)} and against {LIVE_CAP} columns; "
        f"postings_merge bit-equal also at C = {list(MERGE_EDGES)}; postings_select also at "
        f"(C, M) = {list(SELECT_EDGES)} — each matches its twin")
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
    off_by_est = {}  # the scan's dispatches of each estimator's requests
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
            if m == "off":
                off_by_est.setdefault(req.estimator, []).extend(ls)
    hits = {c: s.stage1_hits(sk) for c, s in srv.items()}
    joins = {c: s.search_joinable(keys, k=COLS, metric="containment")
             for c, s in srv.items()}
    launches = ops.launches()
    if not all(launches[k] > 0 for k in SCAN_KERNELS + STAGE1_KERNELS):
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
        off_dispatch_ms_by_estimator={e: dict(p50=pct(v, 50), p99=pct(v, 99), dispatches=len(v))
                                      for e, v in off_by_est.items()},
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


def _sub_index(index, ids):
    """The static index of columns ``ids`` of ``index``, in that order."""
    sh = index.shard
    sel = torch.as_tensor(ids, device=sh.key_hash.device)
    return TI.SketchIndex(shard=TI.IndexShard(*(t[sel] for t in (
        sh.key_hash, sh.values, sh.mask, sh.col_min, sh.col_max, sh.rows))),
        names=[index.names[i] for i in ids], n=N)


def _calls(srv, sk, req, calls):
    """Seconds of ``calls`` 32-query calls (cycling over the queries)."""
    out = []
    for c in range(calls):
        s = (c * BUCKET) % N_QUERIES
        part = sk.map(lambda t: t[s:s + BUCKET])
        t0 = time.perf_counter()
        srv.query_batch(part, request=req)
        out.append(time.perf_counter() - t0)
    return out


def _pct(x, q):
    return 1e3 * float(np.percentile(x, q))


def _no_dead(what, out, dead):
    ids = out[1] if isinstance(out, tuple) else out.ids
    if np.isin(ids, dead).any():
        fail(f"{what}: a deleted column reached the results")


def mini_script(groups, keys, vals, dev):
    """The lifecycle's mutations over the first MINI_GROUPS tables on one
    device: append most, serve, append the rest, delete the tables of the
    first N_DELETED planted queries, serve, compact, serve. Returns the
    results in order."""
    first = MINI_GROUPS * 15 // 16
    live = LC.LiveIndex(n=N, delta_cap=MINI_CAP, device=dev)
    srv = {c: SV.Server(live, PL.ShapePolicy(candidates=c), buckets=(BUCKET,),
                        device=dev) for c in ("scan", "inverted")}
    sk = SV.build_query_sketches(keys, vals, n=N, device=dev)
    safe = PL.Request(prune="safe", scorer="s1")
    out = []
    live.append(groups[:first])
    out += [srv[c].query_batch(sk, request=safe) for c in srv]
    live.append(groups[first:MINI_GROUPS])
    for i in range(N_DELETED):
        live.delete(f"g{2 * i}")
    out += [srv[c].query_batch(sk, request=safe) for c in srv]
    live.compact()
    out += [srv["scan"].query_batch(sk, request=PL.Request()),
            srv["inverted"].query_batch(sk, request=PL.Request(prune="safe"))]
    return out, live.stats()


def phase_lifecycle(groups, index, keys, vals, dev):
    """The live index on the card through appends, serving, deletes,
    compaction and a snapshot, against static servers on the index."""
    sk = SV.build_query_sketches(keys, vals, n=N, device=dev)
    ids_first = list(range(LIVE_FIRST * COLS))
    line = {}
    ops.reset_launches()

    # 1. one append of the first groups: 7.5 delta segments
    live = LC.LiveIndex(n=N, delta_cap=LIVE_CAP, device=dev)
    t0 = time.perf_counter()
    live.append(groups[:LIVE_FIRST])
    torch.cuda.synchronize()
    line["append_s"] = time.perf_counter() - t0
    line["append_cols_per_s"] = LIVE_FIRST * COLS / line["append_s"]
    line["segments_after_append"] = live.stats()["segments"]
    if live.stats()["segments"] != -(-LIVE_FIRST * COLS // LIVE_CAP):
        fail(f"append made {live.stats()} segments")

    # 2. serve across the segments; s1/s2 against a static server
    srv = {c: SV.Server(live, PL.ShapePolicy(candidates=c), buckets=(BUCKET,))
           for c in ("scan", "auto")}
    static = {c: SV.Server(_sub_index(index, ids_first),
                           PL.ShapePolicy(candidates=c), buckets=(BUCKET,))
              for c in ("scan", "auto")}
    if any(e.exec.candidates != "inverted" for e in srv["auto"]._view):
        fail("candidates='auto' did not resolve to the inverted source per segment")
    t0 = time.perf_counter()
    for s in list(srv.values()) + list(static.values()):
        s.warmup(modes=("off", "safe"), include_ladder=False)
    line["warmup_s"] = time.perf_counter() - t0
    checks = [(c, PL.Request(prune="safe", scorer=sc, estimator=e))
              for c in ("scan", "auto") for sc in ("s1", "s2")
              for e in ("pearson", "spearman", "qn")]
    checks += [("scan", PL.Request(scorer=sc)) for sc in ("s1", "s2")]
    for c, req in checks:
        top_agree(static[c].query_batch(sk, request=req),
                  srv[c].query_batch(sk, request=req),
                  f"8 segments {c} {req.prune} {req.estimator}/{req.scorer} vs static")
    lat8 = {"safe(inverted)": _calls(srv["auto"], sk, PL.Request(prune="safe"),
                                     LAT_CALLS[0]),
            "off": _calls(srv["scan"], sk, PL.Request(), LAT_CALLS[1])}
    del static

    # 3. append the rest mid-serving; queries on new groups find them
    t0 = time.perf_counter()
    live.append(groups[LIVE_FIRST:])
    torch.cuda.synchronize()
    line["append_mid_serving_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s in srv.values():
        s.refresh()
    line["refresh_s"] = (time.perf_counter() - t0) / len(srv)
    new = [LIVE_FIRST + j * ((GROUPS - LIVE_FIRST) // N_NEW) for j in range(N_NEW)]
    nk = [groups[g].keys for g in new]
    nv = [groups[g].meta["latent"] for g in new]
    for c, s in srv.items():
        got = s.query_columns(nk, nv, request=PL.Request(prune="safe", scorer="s1"))
        if not (got[1][:, 0] // COLS == np.array(new)).all():
            fail(f"{c}: a query on a table appended mid-serving missed it: {got[1][:, 0]}")
    line["segments_after_second_append"] = live.stats()["segments"]

    # 4. delete the tables of the first N_DELETED planted queries
    t0 = time.perf_counter()
    gone = sum(live.delete(f"g{2 * i}") for i in range(N_DELETED))
    line["delete_s"] = time.perf_counter() - t0
    if gone != N_DELETED * COLS:
        fail(f"delete tombstoned {gone} columns")
    dead = np.array([2 * i * COLS + j for i in range(N_DELETED) for j in range(COLS)])
    for c, s in srv.items():
        for req in (PL.Request(prune="safe"), PL.Request(prune="safe", scorer="s1"),
                    PL.Request(prune="off" if c == "scan" else "topm")):
            _no_dead(f"{c} {req.prune}/{req.scorer}", s.query_batch(sk, request=req), dead)
        hits = s.stage1_hits(sk)
        if hits[:, dead].any():
            fail(f"{c}: stage1_hits counts a deleted column")
        if not ((hits[N_DELETED:] > 0).sum(1) >= COLS).all():
            fail(f"{c}: stage1_hits lost a surviving table")
        _no_dead(f"{c} search_joinable", s.search_joinable(keys, k=COLS), dead)

    # 5. compact into one segment: planes and answers of a static index
    t0 = time.perf_counter()
    base = live.compact()
    torch.cuda.synchronize()
    line["compact_s"] = time.perf_counter() - t0
    keep = np.setdiff1d(np.arange(GROUPS * COLS), dead)
    if base.capacity != LC.ladder_rung(keep.size, LIVE_CAP) or base.used != keep.size:
        fail(f"compaction gave capacity {base.capacity}, {base.used} columns")
    got = base.to_index_shard()
    sel = torch.as_tensor(keep, device=dev)
    for f in ("key_hash", "values", "mask", "col_min", "col_max", "rows"):
        if not torch.equal(getattr(got, f)[:keep.size],
                           getattr(index.shard, f)[sel].cpu()):
            fail(f"compacted {f} differ from the index at the surviving ids")
    survivors = _sub_index(index, keep.tolist())
    static = {c: SV.Server(survivors, PL.ShapePolicy(candidates=c), buckets=(BUCKET,))
              for c in ("scan", "auto")}
    t0 = time.perf_counter()
    for s in srv.values():
        s.refresh()
    line["refresh_after_compact_s"] = (time.perf_counter() - t0) / len(srv)
    line["segments_after_compact"] = live.stats()["segments"]
    reqs = [("auto", PL.Request(prune="safe", estimator=e, scorer=sc))
            for e in PL.ESTIMATORS for sc in PL.FAST_SCORERS]
    for c, req in reqs + [("scan", PL.Request())]:
        want = static[c].query_batch(sk, request=req)
        top_agree(want, srv[c].query_batch(sk, request=req),
                  f"compacted {c} {req.prune} {req.estimator}/{req.scorer} vs static")
    del static, survivors
    lat1 = {"safe(inverted)": _calls(srv["auto"], sk, PL.Request(prune="safe"),
                                     LAT_CALLS[0]),
            "off": _calls(srv["scan"], sk, PL.Request(), LAT_CALLS[1])}

    # 6. snapshot round trip
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        live.save(tmp)
        line["save_s"] = time.perf_counter() - t0
        line["snapshot_mib"] = sum(os.path.getsize(os.path.join(tmp, f))
                                   for f in os.listdir(tmp)) / 2**20
        t0 = time.perf_counter()
        loaded = LC.LiveIndex.load(tmp, device=dev)
        line["load_s"] = time.perf_counter() - t0
    for a, b in zip(live.segments(), loaded.segments()):
        for f in LC._SEG_FIELDS:
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                fail(f"snapshot round trip changed segment {a.sid} {f}")
    req = PL.Request(prune="safe")
    want = srv["auto"].query_batch(sk, request=req)
    again = SV.Server(loaded, PL.ShapePolicy(candidates="auto"), buckets=(BUCKET,))
    if not all(np.array_equal(x, y) for x, y in zip(want, again.query_batch(sk, request=req))):
        fail("the loaded snapshot serves a different top-k")
    launches = ops.launches()
    if not all(launches[k] > 0 for k in LIFECYCLE_KERNELS):
        fail(f"a kernel of the lifecycle path was not launched: {launches}")

    # 7. the same mutations on the card and on the CPU
    t0 = time.perf_counter()
    card_out, card_stats = mini_script(groups, keys, vals, dev)
    cpu_out, cpu_stats = mini_script(groups, keys, vals, torch.device("cpu"))
    if card_stats != cpu_stats:
        fail(f"card and CPU live indexes differ: {card_stats} vs {cpu_stats}")
    for i, (w, g) in enumerate(zip(cpu_out, card_out)):
        top_agree(w, g, f"{MINI_GROUPS}-table mutation script step {i}: card vs CPU")
    line["mini_script_check_s"] = time.perf_counter() - t0

    line.update(
        columns=GROUPS * COLS, n=N, delta_cap=LIVE_CAP, queries=N_QUERIES,
        served={c: {k: s.throughput()[k] for k in ("queries", "dispatches", "qps")}
                for c, s in srv.items()},
        call_p50_ms_8_segments={m: _pct(v, 50) for m, v in lat8.items()},
        call_p99_ms_8_segments={m: _pct(v, 99) for m, v in lat8.items()},
        call_p50_ms_1_segment={m: _pct(v, 50) for m, v in lat1.items()},
        call_p99_ms_1_segment={m: _pct(v, 99) for m, v in lat1.items()},
        launches=launches)
    say("lifecycle " + json.dumps(line))
    say(f"lifecycle: {LIVE_FIRST} + {GROUPS - LIVE_FIRST} tables appended "
        f"({line['segments_after_second_append']} segments), s1/s2 == static "
        f"across segments, new tables found, {N_DELETED} tables deleted and "
        f"never served, compacted planes == index at the survivors and 13 "
        f"requests == static, snapshot round trip bit-identical, "
        f"{MINI_GROUPS}-table script card == CPU")
    return launches


def _as_rows(res):
    """A `QueryResult` as top_agree's one-row (scores, ids, r, m) arrays."""
    return tuple(t.cpu().numpy()[None] for t in (res.scores, res.indices,
                                                  res.r, res.m))


def phase_library(index, keys, vals, best, dev):
    """The paper library's top-k query on the card over the whole corpus,
    s3 on the sub-corpus, and the card against the CPU plain path."""
    cands, sub = index_sketches(index), index_sketches(index, SUB_C)
    qs = SV.build_query_sketches(keys, vals, n=N, device=dev)
    one = lambda q: qs.map(lambda t: t[q])
    combos = [(e, sc) for e in PL.ESTIMATORS for sc in PL.FAST_SCORERS]
    boot_gen = lambda q: torch.Generator().manual_seed(SEED + q)
    ops.reset_launches()
    ms, results = {}, {}
    for est, sc in combos:
        t0 = time.perf_counter()
        for q in range(N_QUERIES):
            results[(est, sc, q)] = RK.topk_query(one(q), cands, k=10, estimator=est,
                                                  scorer=sc, device=dev)
        torch.cuda.synchronize()
        ms[f"{est}/{sc}"] = 1e3 * (time.perf_counter() - t0) / N_QUERIES
    t0 = time.perf_counter()
    boot = [RK.topk_query(one(q), sub, k=10, scorer="s3", bootstrap=True,
                          generator=boot_gen(q), device=dev) for q in range(N_QUERIES)]
    torch.cuda.synchronize()
    ms["pearson/s3 (sub-corpus)"] = 1e3 * (time.perf_counter() - t0) / N_QUERIES
    launches = ops.launches()
    if not all(launches[k] > 0 for k in LIBRARY_KERNELS):
        fail(f"a kernel of the library path was not launched: {launches}")

    missed = [q for q in range(N_QUERIES)
              if best[q] not in results[("pearson", "s1", q)].indices.tolist()]
    if missed:
        fail(f"library: planted columns missing from the pearson/s1 top-10: {missed}")
    for (est, sc, q), res in results.items():
        if not bool(torch.isfinite(res.scores[0])):
            fail(f"library {est}/{sc}: query {q} found no eligible candidate")
    for q, res in enumerate(boot):
        if 2 * q * COLS < SUB_C and not (bool(torch.isfinite(res.scores[0]))
                                         and int(res.indices[0]) // COLS == 2 * q):
            fail(f"library pearson/s3: query {q}'s best is not a column of its table")

    # the card against the CPU plain path on the sub-corpus
    t0 = time.perf_counter()
    sub_cpu = sub.map(lambda t: t.cpu())
    for q in range(LIB_CPU_QUERIES):
        for est, sc in combos:
            kw = dict(k=10, estimator=est, scorer=sc)
            top_agree(_as_rows(RK.topk_query(one(q), sub_cpu, device="cpu", **kw)),
                      _as_rows(RK.topk_query(one(q), sub, device=dev, **kw)),
                      f"library sub-corpus {est}/{sc} query {q}: card vs CPU")
    nq, cols = BOOT_CPU
    for q in range(nq):
        kw = dict(k=10, scorer="s3", bootstrap=True)
        top_agree(_as_rows(RK.topk_query(one(q), sub_cpu.map(lambda t: t[:cols]),
                                         generator=boot_gen(q), device="cpu", **kw)),
                  _as_rows(RK.topk_query(one(q), sub.map(lambda t: t[:cols]),
                                         generator=boot_gen(q), device=dev, **kw)),
                  f"library {cols} columns pearson/s3 query {q}: card vs CPU")
    t_cpu = time.perf_counter() - t0
    per_est = {e: float(np.mean([ms[f"{e}/{sc}"] for sc in PL.FAST_SCORERS]))
               for e in PL.ESTIMATORS}
    busy = {f"{e}/s4": device_busy(lambda e=e: RK.topk_query(
                one(0), cands, k=10, estimator=e, scorer="s4", device=dev))
            for e in ("pearson", "rin")}
    busy["pearson/s3 (sub-corpus)"] = device_busy(lambda: RK.topk_query(
        one(0), sub, k=10, scorer="s3", bootstrap=True, generator=boot_gen(0),
        device=dev))
    line = dict(columns=cands.key_hash.shape[0], n=N, queries=N_QUERIES,
                chunk=RK.CHUNK, ms_per_query=ms, ms_per_query_by_estimator=per_est,
                launches={k: launches[k] for k in LIBRARY_KERNELS},
                profiled_query_0=busy,
                planted_in_s1_top10=N_QUERIES - len(missed), cpu_check_s=t_cpu)
    say("library " + json.dumps(line))
    say(f"library: {len(combos)} combinations × {N_QUERIES} queries over "
        f"{line['columns']} columns and pearson/s3 over {SUB_C}; planted "
        f"columns found; card == CPU plain path ({LIB_CPU_QUERIES} queries × "
        f"{len(combos)} on {SUB_C} columns, s3 on {BOOT_CPU[1]})")
    return launches


def _same(got, want) -> bool:
    return all(np.array_equal(g, w) for g, w in zip(got, want))


def _race(groups, sk, dev):
    """Queries through a two-worker scheduler race appends, deletes and
    refreshes of a live index on the card; afterwards the scheduler's
    results equal direct calls."""
    first = MINI_GROUPS * 3 // 4
    live = LC.LiveIndex(n=N, delta_cap=MINI_CAP, device=dev)
    live.append(groups[:first])
    req = PL.Request(prune="safe", scorer="s1")
    srv = SV.Server(live, PL.ShapePolicy(candidates="auto"), request=req,
                    buckets=(1, 8, BUCKET))
    srv.warmup(modes=("off", "safe"), include_ladder=True)
    parts = [sk.map(lambda t, s=s: t[s:s + 4]) for s in range(0, 16, 4)]
    served, errors = [], []
    stop = threading.Event()

    def loop(sched, j):
        while not stop.is_set():
            try:
                sched.query(parts[j % len(parts)], request=req, timeout=600)
            except Exception as e:   # every failure is reported below
                errors.append(repr(e))
                return
            served.append(j)

    new = groups[first:MINI_GROUPS]
    step = len(new) // RACE_STEPS
    with AsyncScheduler(srv, workers=2) as sched:
        threads = [threading.Thread(target=loop, args=(sched, j)) for j in range(3)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        for i in range(RACE_STEPS):
            live.append(new[i * step:(i + 1) * step])
            srv.refresh()
            time.sleep(0.05)
            live.delete(f"g{2 * i}")
            srv.refresh()
            time.sleep(0.05)
        t_mut = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(timeout=600)
        if errors or any(t.is_alive() for t in threads):
            fail(f"scheduler race: tickets failed or hung: {errors}")
        for r in (req, PL.Request(prune="safe"), PL.Request(estimator="spearman")):
            for part in parts:
                if not _same(sched.query(part, request=r, timeout=600),
                             srv.query_batch(part, request=r)):
                    fail(f"scheduler after the race: {r} differs from a direct call")
        st = sched.stats()
    return dict(tables=MINI_GROUPS, mutations=2 * RACE_STEPS, mutation_s=t_mut,
                tickets_during_race=len(served), errors=st["errors"],
                segments=live.stats()["segments"])


def _open_loop(srv, singles, arrivals, req, workers: int) -> dict:
    """One-query tickets of ``req`` submitted at the ``arrivals`` (seconds
    from the start) to a scheduler of ``workers`` with the SLO: goodput,
    ticket latencies, misses, coalescing and the dispatches it made."""
    n0 = len(srv.dispatch_log)
    with AsyncScheduler(srv, workers=workers, slo_ms=SLO_MS) as sched:
        start = time.monotonic()
        sent = []
        for i, at in enumerate(arrivals):
            delay = start + at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            sent.append(sched.submit(singles[i % len(singles)], request=req))
        for t in sent:
            t.result(timeout=600)
        st = sched.stats()
        depth = srv.throughput()["queue_depth"]
    if st["errors"] or st["completed"] != len(sent) or depth:
        fail(f"scheduler load ({workers} workers): {st}, queue depth {depth}")
    end = max(t.t_done for t in sent)
    lat = np.array([t.latency_s for t in sent])
    on_time = sum(not t.missed_deadline for t in sent)
    by_bucket = {}
    for B, nq, dt in list(srv.dispatch_log)[n0:]:
        by_bucket.setdefault(B, []).append((nq, dt))
    return dict(
        workers=workers, tickets=len(sent), goodput_qps=on_time / (end - start),
        completed_qps=len(sent) / (end - start),
        latency_p50_ms=1e3 * float(np.percentile(lat, 50)),
        latency_p99_ms=1e3 * float(np.percentile(lat, 99)),
        deadline_misses=st["deadline_misses"], avg_coalesce=st["avg_coalesce"],
        batches=st["batches"], flush_deadline=st["flush_deadline"],
        flush_full=st["flush_full"], flush_drain=st["flush_drain"],
        dispatches={str(B): dict(count=len(v), queries=sum(q for q, _ in v),
                                 p50_ms=1e3 * float(np.median([d for _, d in v])),
                                 p99_ms=1e3 * float(np.percentile([d for _, d in v], 99)))
                    for B, v in sorted(by_bucket.items())})


def phase_scheduler(index, groups, keys, vals, dev):
    """AsyncScheduler: bit-identity with workers=1, open-loop load with
    two workers and with one, and queries racing mutations of a live
    index."""
    sk = SV.build_query_sketches(keys, vals, n=N, device=dev)
    # the default request prices the buckets the admission loop plans with
    srv = SV.Server(index, PL.ShapePolicy(candidates="auto"),
                    request=PL.Request(prune="safe"), buckets=(1, 8, BUCKET))
    t0 = time.perf_counter()
    srv.warmup(modes=("off", "safe"))
    line = dict(warmup_s=time.perf_counter() - t0)

    # 1. one worker: each ticket equals a direct call, bit for bit
    tickets, s = [], 0
    for i in range(SCHED_TICKETS):
        width = 1 + i % 4
        part = sk.map(lambda t, s=s, w=width: t[s:s + w])
        s = (s + width) % (N_QUERIES - 4)
        if i % 4 == 3:
            req = PL.Request(k=10)
        else:
            req = PL.Request(prune="safe", k=(3, 5, 10)[i % 3],
                             estimator=PL.ESTIMATORS[i % 4],
                             scorer=PL.FAST_SCORERS[i % 3])
        tickets.append((part, req))
    with AsyncScheduler(srv, workers=1) as sched:
        sent = [sched.submit(part, request=req) for part, req in tickets]
        for t, (part, req) in zip(sent, tickets):
            if not _same(t.result(timeout=600), srv.query_batch(part, request=req)):
                fail(f"scheduler (workers=1): a ticket of {req} differs from a direct call")
        line["workers1"] = sched.stats()

    # 2. open-loop arrivals at LOAD_FACTOR × the sequential rate: two
    # workers, then the same arrivals with one
    load = PL.Request(prune="safe")
    singles = [sk.map(lambda t, i=i: t[i:i + 1]) for i in range(N_QUERIES)]
    t0 = time.perf_counter()
    for i in range(SEQ_CALLS):
        srv.query_batch(singles[i % N_QUERIES], request=load)
    seq_qps = SEQ_CALLS / (time.perf_counter() - t0)
    rate = LOAD_FACTOR * seq_qps
    gaps = np.random.default_rng(SEED).exponential(1.0 / rate, size=int(2 * LOAD_S * rate) + 16)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < LOAD_S]
    line.update(sequential_qps=seq_qps, arrival_rate_qps=rate, load_s=LOAD_S,
                slo_ms=SLO_MS, offered_qps=len(arrivals) / LOAD_S,
                bucket_cost_ms={str(b): 1e3 * c for b, c in sorted(srv._bucket_cost.items())})
    line["load"] = _open_loop(srv, singles, arrivals, load, workers=2)
    line["load_workers1"] = _open_loop(srv, singles, arrivals, load, workers=1)

    # 3. queries racing mutations of a live index
    line["race"] = _race(groups, sk, dev)
    say("scheduler " + json.dumps(line))
    say(f"scheduler: {SCHED_TICKETS} mixed tickets == direct calls (workers=1); "
        f"{line['load']['tickets']} open-loop tickets at {rate:.1f}/s (3× sequential "
        f"{seq_qps:.1f}/s): goodput {line['load']['goodput_qps']:.1f}/s with 2 "
        f"workers, {line['load_workers1']['goodput_qps']:.1f}/s with 1; "
        f"{line['race']['tickets_during_race']} tickets raced "
        f"{line['race']['mutations']} mutations with no failure, then == direct calls")


# ----------------------------------------------------------------------------
# sharded serving and build: the index column-sharded over a device mesh
# ----------------------------------------------------------------------------

def _event_ms(fn, calls: int):
    """p50 and p99 of ``calls`` calls of ``fn``, each timed by CUDA events
    on the current stream (``fn`` waits for its results)."""
    ms = []
    for _ in range(calls):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        ms.append(t0.elapsed_time(t1))
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def _launched(fn):
    """Launch counts of one call of ``fn`` (the counters' difference)."""
    before = ops.launches()
    fn()
    return {k: v - before[k] for k, v in ops.launches().items() if v - before[k]}


def _per_shard_launches(srv, sk):
    """Every shard launches its block's kernels: one 32-query dispatch
    scans each of the SHARDS blocks in chunks, so the sketch join (and
    the rank or Qn kernel under those estimators) launches SHARDS times
    one block's chunk count, and `stage1_hits` probes each block once."""
    w = srv.C // SHARDS
    chunks = SHARDS * -(-w // srv.chunk_for(BUCKET))
    want = {"pearson": {"sketch_join_moments": chunks},
            "spearman": {"sketch_join_moments": chunks, "rank_moments": chunks},
            "qn": {"sketch_join_moments": chunks, "qn_correlation": chunks}}
    for est, counts in want.items():
        got = _launched(lambda: srv.query_batch(sk, request=PL.Request(estimator=est)))
        if got != counts:
            fail(f"sharded off/{est}: launches {got}, want {counts} "
                 f"({SHARDS} shards × {chunks // SHARDS} chunks)")
    got = _launched(lambda: srv.stage1_hits(sk))
    if got != {"containment_hits": SHARDS}:
        fail(f"sharded stage1_hits: launches {got}, want one per shard")
    return dict(off_chunks_per_shard=chunks // SHARDS, stage1_probes=SHARDS)


def _canon(kh, vals, mask):
    """Each column's valid keys ascending, with their values (masked slots
    last): a layout-free form of a sketch for comparing key sets."""
    k = torch.where(mask > 0, kh.to(torch.int64), 1 << 40)
    o = k.argsort(-1)
    return k.gather(-1, o), vals.gather(-1, o), (mask > 0).gather(-1, o)


def _sharded_build(groups, index, mesh):
    """`distributed_build_table` of the first tables, their rows in SHARDS
    blocks over the mesh, against the fused build's planes in the index:
    key sets exact, values within 1e-3, rows within 0.5 (the reference's
    tolerances for its row-sharded build)."""
    sh = index.shard
    worst = 0.0
    t0 = time.perf_counter()
    for i, g in enumerate(groups[:SHARD_BUILD_TABLES]):
        sk = TG.distributed_build_table(g.keys, g.values, mesh, n=N)
        cols = slice(i * COLS, (i + 1) * COLS)
        gk, gv, gm = _canon(sk.key_hash, sk.values(), sk.mask.float())
        wk, wv, wm = _canon(hashing.from_pattern(sh.key_hash[cols]),
                            sh.values[cols], sh.mask[cols])
        if not (torch.equal(gk, wk) and torch.equal(gm, wm)):
            fail(f"sharded build of {g.name}: key sets differ from the fused build")
        d = float((gv - wv).abs().max())
        worst = max(worst, d)
        if d >= 1e-3 or float((sk.rows - sh.rows[cols]).abs().max()) >= 0.5:
            fail(f"sharded build of {g.name}: values or rows differ (max |diff| {d})")
    torch.cuda.synchronize()
    return dict(tables=SHARD_BUILD_TABLES, rows_per_shard=ROWS // SHARDS,
                seconds=time.perf_counter() - t0, max_abs_err=worst)


def phase_sharded(index, groups, dev):
    """The index column-sharded over a SHARDS-shard mesh (four shards on
    one card, or one on each of four): planted queries over every
    scorer × estimator × prune mode through both candidate sources, each
    kernel launching on every shard, bit-identical to the one-device
    server on the same card; the off dispatch timed at both widths; the
    row-sharded build against the fused one; then the two serving drivers
    on the card. Returns the sharded path's launches."""
    mesh = make_host_mesh(SHARDS)
    # planted queries on groups spread over the whole index, so every
    # shard holds some of their targets
    spread = [groups[i * (GROUPS // SHARD_QUERIES)] for i in range(SHARD_QUERIES)]
    sk = SV.build_query_sketches([g.keys for g in spread],
                                 [g.meta["latent"] for g in spread], n=N, device=dev)
    combos = [(sc, est, pm) for sc in PL.FAST_SCORERS for est in PL.ESTIMATORS
              for pm in PL.PRUNE_MODES]
    line = dict(shards=SHARDS, mesh=[str(d) for d in mesh],
                columns=index.shard.num_columns, queries=SHARD_QUERIES)

    def sweep(servers):
        """Every combination through both sources; ``off`` is the same
        scan through either, so it runs on the scan server only."""
        out = {}
        for src, srv in servers.items():
            for sc, est, pm in combos:
                if pm != "off" or src == "scan":
                    out[src, sc, est, pm] = srv.query_batch(
                        sk, request=PL.Request(scorer=sc, estimator=est, prune=pm))
            out[src, "stage1"] = (srv.stage1_hits(sk),)
        return out

    ops.reset_launches()
    t0 = time.perf_counter()
    sharded = {src: SV.Server(index, PL.ShapePolicy(candidates=src),
                              buckets=(BUCKET,), mesh=mesh)
               for src in ("scan", "inverted")}
    for srv in sharded.values():
        srv.warmup()
    line["warmup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = sweep(sharded)
    line["sweep_s"] = time.perf_counter() - t0
    line["per_shard"] = _per_shard_launches(sharded["scan"], sk)
    build = _sharded_build(groups, index, mesh)
    launches = ops.launches()
    missing = [k for k in LIFECYCLE_KERNELS if not launches[k]]
    if missing:
        fail(f"sharded: {missing} never launched")
    line["launches"] = launches
    line["build"] = build
    line["combine"] = sharded["scan"].shape.combine
    line["fused_dispatches"] = _stages(sharded["inverted"]).get("fused", (0, 0))[0]
    if not line["fused_dispatches"]:
        fail("sharded: the fused inverted safe plan never ran")

    one = {src: SV.Server(index, PL.ShapePolicy(candidates=src), buckets=(BUCKET,),
                          device=dev) for src in ("scan", "inverted")}
    for srv in one.values():
        srv.warmup()
    want = sweep(one)
    for key, w in want.items():
        if not all(np.array_equal(a, b) for a, b in zip(got[key], w)):
            fail(f"sharded {key}: the {SHARDS}-shard result differs from one "
                 f"device's (bit for bit)")
    ids = np.concatenate([g[1].ravel() for k, g in got.items() if k[-1] != "stage1"])
    width = index.shard.num_columns // SHARDS
    line["ids_per_shard"] = np.bincount(ids[ids >= 0] // width, minlength=SHARDS).tolist()
    if min(line["ids_per_shard"]) == 0:
        fail(f"sharded: some shard never ranked a column: {line['ids_per_shard']}")

    off = PL.Request(prune="off")
    for name, srv in (("d4", sharded["scan"]), ("d1", one["scan"])):
        p50, p99 = _event_ms(lambda: srv.query_batch(sk, request=off), SHARD_TIMED)
        line[f"off_{name}_p50_ms"], line[f"off_{name}_p99_ms"] = p50, p99
    del sharded, one
    say("sharded " + json.dumps(line))
    say(f"sharded: {SHARDS} shards ({', '.join(line['mesh'])}) × {width} columns, "
        f"{line['combine']} combine: {SHARD_QUERIES} planted queries × "
        f"{len(combos)} scorer × estimator × prune requests through the scan and "
        f"inverted sources == one device, bit for bit (scores, ids, r, m; "
        f"stage1_hits too); each block launched {line['per_shard']['off_chunks_per_shard']} "
        f"sketch-join chunks a dispatch; 32-query off dispatch p50/p99 "
        f"{line['off_d4_p50_ms']:.1f}/{line['off_d4_p99_ms']:.1f} ms at {SHARDS} "
        f"shards, {line['off_d1_p50_ms']:.1f}/{line['off_d1_p99_ms']:.1f} ms on one "
        f"device (CUDA events); row-sharded build of {SHARD_BUILD_TABLES} tables == "
        f"the fused build (max |diff| {build['max_abs_err']})")

    t0 = time.perf_counter()
    launch_serve.main(SERVE_ARGS)
    t1 = time.perf_counter()
    serve_queries.main([])
    say(f"drivers: launch.serve {' '.join(SERVE_ARGS)} in {t1 - t0:.1f} s, "
        f"serve_queries in {time.perf_counter() - t1:.1f} s")
    return {k: v for k, v in launches.items() if k in LIFECYCLE_KERNELS}


# ----------------------------------------------------------------------------
# the legacy query API and the augmentation example
# ----------------------------------------------------------------------------

def _host_np(out):
    return tuple(x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                 for x in out)


def _bit_equal(what, got, want):
    """Fail unless every output of ``got`` equals ``want``'s bit for bit."""
    got, want = _host_np(got), _host_np(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.array_equal(g, w):
            fail(f"legacy {what}: output {i} differs (bit for bit)")


def _timed_single(fn):
    """One call of ``fn`` (it returns card tensors): (ms by CUDA events, ms
    by the host clock), the host's including the wait for the results."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1), 1e3 * (time.perf_counter() - h0)


def phase_legacy(index, groups, keys, vals, best, dev):
    """The legacy query API on the card: (a) `query()` for single planted
    queries against their rows of `Server.query_batch`, (b) the batched
    `make_*_query_fn` builders against `Server`, (c) `QueryServer` and
    `LiveQueryServer` against `Server`, (d) `query()` over a 4-shard mesh
    against one device, (e) the augmentation example, (f) its training
    half. Returns the phase's launches."""
    mesh1 = (dev,)
    qk, qv, qb = keys[:LEGACY_QUERIES], vals[:LEGACY_QUERIES], best[:LEGACY_QUERIES]
    sk = SV.build_query_sketches(qk, qv, n=N, device=dev)
    qa = TI.query_arrays(sk)
    C = index.shard.num_columns
    srv = SV.Server(index, buckets=(BUCKET,))
    line = dict(queries=LEGACY_QUERIES, single_queries=LEGACY_SINGLE, columns=C)
    ops.reset_launches()
    t_phase = time.perf_counter()

    # (a) single queries against their rows of a 32-query Server batch
    rows, ev, host, per_call, server_ms, builder_ms = {}, [], [], {}, {}, {}
    for est in PL.ESTIMATORS:
        t0 = time.perf_counter()
        rows[est] = srv.query_batch(sk, request=PL.Request(estimator=est))
        server_ms[est] = 1e3 * (time.perf_counter() - t0)
        qcfg = Q.QueryConfig(k=10, estimator=est, scorer="s4")
        for i in range(LEGACY_SINGLE):
            one = sk.map(lambda t, i=i: t[i])
            if i == 0:
                per_call[est] = _launched(lambda: Q.query(index.shard, one, mesh1, qcfg))
            out, e_ms, h_ms = _timed_single(lambda: Q.query(index.shard, one, mesh1, qcfg))
            ev.append(e_ms)
            host.append(h_ms)
            got = _host_np(out)
            _bit_equal(f"query() {est} query {i}", got,
                       tuple(x[i] for x in rows[est]))
            if not (np.isfinite(got[0][0]) and got[1][0] // COLS == qb[i] // COLS):
                fail(f"legacy query() {est} query {i}: top-1 id {got[1][0]} is "
                     f"not a column of its planted table {qb[i] // COLS}")
    chunks = -(-C // Q.QueryConfig().score_chunk)
    want = {"pearson": {"sketch_join_moments": chunks},
            "spearman": {"sketch_join_moments": chunks, "rank_moments": chunks},
            "rin": {"sketch_join_moments": chunks, "rank_moments": chunks},
            "qn": {"sketch_join_moments": chunks, "qn_correlation": chunks}}
    if per_call != want:
        fail(f"legacy query(): launches {per_call}, want {want}")
    line["single_calls"] = len(ev)
    line["single_launches"] = per_call
    line["single_ms_events_p50_p99"] = [_pct(np.array(ev) / 1e3, 50), _pct(np.array(ev) / 1e3, 99)]
    line["single_ms_host_p50_p99"] = [_pct(np.array(host) / 1e3, 50),
                                      _pct(np.array(host) / 1e3, 99)]

    # (b) the batched builders at B = 32 against the Server
    for est in PL.ESTIMATORS:
        qcfg = Q.QueryConfig(k=10, estimator=est, scorer="s4")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            fn = Q.make_query_fn(mesh1, C, N, qcfg, batch=BUCKET)
        t0 = time.perf_counter()
        out = _host_np(fn(*qa, index.shard))
        builder_ms[est] = 1e3 * (time.perf_counter() - t0)
        _bit_equal(f"make_query_fn {est}", out, rows[est])
    # one 32-query off call, host clock: Server (chunks of 128 candidates)
    # against make_query_fn (the config's 512)
    line["off_32_ms_server_vs_make_query_fn"] = {
        est: [server_ms[est], builder_ms[est]] for est in PL.ESTIMATORS}
    qcfg = Q.QueryConfig(k=10, scorer="s4", prune="safe")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        hits = Q.make_stage1_fn(mesh1, C, N, qcfg, batch=BUCKET)(*qa, index.shard)
        hits = hits.cpu().numpy()
        if not np.array_equal(hits, srv.stage1_hits(sk)):
            fail("legacy make_stage1_fn: hits differ from Server.stage1_hits")
        surv = Q.select_survivors(hits, qcfg)
        M = Q.prune_rung(max(len(surv), qcfg.k), qcfg.prune_base, C, 1)
        if M is None:
            fail(f"legacy: {len(surv)} survivors fit no rung below {C}")
        idx = np.zeros((M,), np.int32)
        idx[:len(surv)] = surv
        pruned = Q.make_pruned_query_fn(mesh1, C, N, qcfg, M, batch=BUCKET)(
            *qa, index.shard, torch.from_numpy(idx).to(dev),
            torch.from_numpy(np.arange(M) < len(surv)).to(dev))
        topm = Q.make_topm_query_fn(mesh1, C, N, dataclasses.replace(qcfg, prune="topm"),
                                    batch=BUCKET)(*qa, index.shard)
    _bit_equal("make_pruned_query_fn", pruned, srv.query_batch(sk, request=PL.Request(prune="safe")))
    _bit_equal("make_topm_query_fn", topm, srv.query_batch(sk, request=PL.Request(prune="topm")))
    line["safe_survivors"], line["safe_rung"] = len(surv), M

    # (c) the deprecated servers against the Server, off and safe
    live = LC.LiveIndex(n=N, delta_cap=LIVE_CAP, device=dev)
    live.append(groups[:LIVE_FIRST])
    live_srv = SV.Server(live, buckets=(BUCKET,))
    for prune in ("off", "safe"):
        qcfg = Q.QueryConfig(k=10, scorer="s4", prune=prune)
        req = PL.Request(prune=prune)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            qs = SV.QueryServer(mesh1, index.shard, qcfg, buckets=(BUCKET,), index=index)
            ls = LC.LiveQueryServer(mesh1, live, qcfg, buckets=(BUCKET,))
        qs.warmup()
        ls.warmup(include_ladder=False)
        got, want = _host_np(qs.query_batch(sk)), rows["pearson"] if prune == "off" \
            else srv.query_batch(sk, request=req)
        fin = np.isfinite(want[0])
        if not (np.array_equal(np.isfinite(got[0]), fin)
                and all(np.array_equal(g[fin], w[fin]) for g, w in zip(got, want))):
            fail(f"legacy QueryServer {prune}: differs from Server")
        _bit_equal(f"LiveQueryServer {prune}", ls.query_batch(sk, True),
                   live_srv.query_batch(sk, request=req))
    line["live_segments"] = live.stats()["segments"]
    del live, live_srv, qs, ls

    # (d) query() over a 4-shard mesh against one device
    mesh4 = make_host_mesh(SHARDS)
    sharded = TI.shard_for_mesh(index, mesh4)
    for est in PL.ESTIMATORS:
        qcfg = Q.QueryConfig(k=10, estimator=est, scorer="s4")
        for i in range(LEGACY_SINGLE):
            one = sk.map(lambda t, i=i: t[i])
            _bit_equal(f"query() 4 shards {est} query {i}",
                       Q.query(sharded, one, mesh4, qcfg),
                       tuple(x[i] for x in rows[est]))
    del sharded
    line["api_s"] = time.perf_counter() - t_phase

    # (e) the paper's augmentation example on the card
    t0 = time.perf_counter()
    try:
        picked, r_hat, r0, r1 = train_augmented.discover_and_augment(dev)
    except AssertionError as e:
        fail(f"legacy train_augmented: {e or 'an assert failed'}")
    line["augment"] = dict(picked=picked, r_hat=[float(x) for x in r_hat],
                           rmse=[r0, r1], seconds=time.perf_counter() - t0)
    # (f) its training half: the smoke tinyllama through the train loop
    t0 = time.perf_counter()
    before = ops.launches()
    losses = train_augmented.short_lm_training(dev)
    short = {k: ops.launches()[k] - before[k] for k in LM_TRAIN_KERNELS}
    L = len(TT.layer_windows(LMR.get_smoke_config("tinyllama-1.1b")))
    want = {"flash_attention": SHORT_STEPS * 2 * L, "flash_attention_bwd": SHORT_STEPS * L}
    if len(losses) != SHORT_STEPS or not np.isfinite(losses).all():
        fail(f"legacy short_lm_training: {len(losses)} losses, want {SHORT_STEPS} finite: "
             f"{losses}")
    if short != want:
        fail(f"legacy short_lm_training: launches {short}, want {want}")
    line["short_lm_training"] = dict(losses=losses, launches=short,
                                     seconds=time.perf_counter() - t0)
    launches = ops.launches()
    missing = [k for k in LEGACY_KERNELS if not launches[k]]
    if missing:
        fail(f"legacy: {missing} never launched")
    line["launches"] = {k: v for k, v in launches.items() if v}
    line["bit_identical"] = dict(single_vs_server_rows=len(ev), builders=4 + 3,
                                 query_server=2, live_query_server=2,
                                 four_shards=len(ev))
    say("legacy " + json.dumps(line))
    say(f"legacy: {len(ev)} single query() calls (8 planted queries × 4 estimators, "
        f"s4) == their rows of Server.query_batch and == a {SHARDS}-shard mesh, bit "
        f"for bit, each top-1 in its planted table; {chunks} sketch-join launches a "
        f"call; p50/p99 {line['single_ms_events_p50_p99'][0]:.1f}/"
        f"{line['single_ms_events_p50_p99'][1]:.1f} ms (CUDA events), "
        f"{line['single_ms_host_p50_p99'][0]:.1f}/{line['single_ms_host_p50_p99'][1]:.1f} "
        f"ms (host); make_query_fn × 4 estimators, make_stage1_fn → "
        f"{len(surv)} survivors → make_pruned_query_fn at rung {M}, "
        f"make_topm_query_fn == Server; QueryServer and LiveQueryServer "
        f"({line['live_segments']} segments) off/safe == Server; train_augmented "
        f"found {picked}, RMSE {r0:.3f} → {r1:.3f}; short_lm_training: {SHORT_STEPS} "
        f"finite losses, {losses[0]:.3f} → {losses[-1]:.3f}, {short['flash_attention']} "
        f"flash_attention and {short['flash_attention_bwd']} flash_attention_bwd launches")
    return {k: v for k, v in launches.items() if k in LEGACY_KERNELS + LM_TRAIN_KERNELS}


# ----------------------------------------------------------------------------
# the LM substrate: flash_attention, and tinyllama-1.1b served on the card
# ----------------------------------------------------------------------------

def merge(fn, cand, C):
    """``fn(cand, C)``: the postings merge (kernel or twin), or ``fn(cand)``
    on a tree whose merge takes no C (a ``--speed`` parent before the
    bitmap kernel)."""
    return fn(cand, C) if "C" in inspect.signature(fn).parameters else fn(cand)


def _flash_args(rng, dev, B, Hq, Hkv, Lq, Lk, D, qdt=torch.float32, kvdt=torch.float32):
    """q [B, Hq, Lq, D] and k, v [B, Hkv, Lk, D] of normal values, drawn on
    the card from ``rng`` (a torch.Generator)."""
    draw = lambda shape, dt: torch.randn(shape, generator=rng, device=dev).to(dt)
    return (draw((B, Hq, Lq, D), qdt), draw((B, Hkv, Lk, D), kvdt),
            draw((B, Hkv, Lk, D), kvdt))


def _flash_cases():
    """(what, shape, causal, window, q dtype, kv dtype) of every kernel
    check: the LM path's two launch shapes, the reference sweep, hymba's
    heads, ragged edges and more shapes of the split-key path."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, S = LM_BATCH, LM_PROMPT
    return [
        ("prefill", (B, 32, 4, S, S, 64), True, 0, f32, f32),
        ("decode", (B, 32, 4, 1, S + LM_NEW, 64), False, 0, f32, bf16),
        ("sweep 1", (2, 4, 2, 256, 256, 64), True, 0, f32, f32),
        ("sweep 2", (1, 8, 8, 128, 128, 32), True, 64, f32, f32),
        ("sweep 3", (1, 4, 1, 128, 512, 64), True, 0, f32, f32),
        ("sweep 4", (2, 2, 2, 256, 256, 128), False, 0, f32, f32),
        ("sweep 5", (1, 4, 2, 256, 256, 64), True, 0, bf16, bf16),
        ("hymba window", (2, 25, 5, 2048, 2048, 64), True, 1024, f32, f32),
        ("hymba global", (2, 25, 5, 2048, 2048, 64), True, 0, f32, f32),
        ("ragged 37", (2, 32, 4, 37, 37, 64), True, 0, f32, f32),
        ("one query", (3, 32, 4, 1, 77, 64), False, 0, f32, f32),
        ("Lq > Lk", (2, 32, 4, 40, 24, 64), True, 0, f32, f32),
        # the split-key path: a ragged cache, hymba's heads with a window,
        # a 4-position chunk of 4-head groups with a window
        ("decode ragged", (B, 32, 4, 1, S + 1, 64), False, 0, f32, bf16),
        ("decode window", (2, 25, 5, 1, 2048, 64), True, 1024, f32, f32),
        ("chunk of 4", (2, 16, 4, 4, 300, 64), True, 16, f32, bf16),
        # the launch shapes the hybrid and encoder-decoder paths add (each
        # also timed, PATH_CASES): whisper's encoder, its cross-attention
        # in prefill and decode (queries on the bf16 cross cache), and a
        # hymba ring decode over a full 1024-slot ring
        ("whisper encoder", (B, 12, 12, ENCDEC_FRAMES, ENCDEC_FRAMES, 64), False, 0, f32, f32),
        ("cross prefill", (B, 12, 12, ENCDEC_PROMPT, ENCDEC_FRAMES, 64), False, 0, f32, f32),
        ("cross decode", (B, 12, 12, 1, ENCDEC_FRAMES, 64), False, 0, f32, bf16),
        ("hymba ring decode", (B, 25, 5, 1, 1024, 64), False, 0, f32, bf16),
        # and three more of their launch shapes: hymba's prefill (its
        # global layers: causal, no window), whisper's decoder
        # self-attention over the prompt, and hymba's global-layer decode
        # over its bf16 cache
        ("hymba prefill", (B, 25, 5, HYBRID_PROMPT, HYBRID_PROMPT, 64), True, 0, f32, f32),
        ("whisper self prefill", (B, 12, 12, ENCDEC_PROMPT, ENCDEC_PROMPT, 64), True, 0,
         f32, f32),
        ("hymba global decode", (B, 25, 5, 1, HYBRID_PROMPT + LM_NEW, 64), False, 0, f32,
         bf16),
        # head dim 128 inside a model (the MoE paths): grok's prefill and
        # split-key decode (48 query heads on 8 bf16 KV heads, group 6), and
        # llama4's decode (group 5)
        ("grok prefill", (B, 48, 8, MOE_PROMPT, MOE_PROMPT, 128), True, 0, f32, f32),
        ("grok decode", (B, 48, 8, 1, MOE_PROMPT + LM_NEW, 128), False, 0, f32, bf16),
        ("llama4 decode", (B, 40, 8, 1, MOE_PROMPT + LM_NEW, 128), False, 0, f32, bf16),
        # grok's training launch on a mesh replica (train_mesh_moe): a row
        # of the microbatch, bf16 q and k/v
        ("grok train replica", _grok_replica_shape(), True, 0, bf16, bf16),
    ]


def _grok_replica_shape():
    """(B, Hq, Hkv, Lq, Lk, D) of grok's attention on one replica of the
    train_mesh_moe phase: a microbatch's rows over MESH_SHAPE's data axis."""
    c = MOE_TRAIN_CONFIG
    return (TRAIN_BATCH // TRAIN_MB // MESH_SHAPE[0], c.num_heads, c.num_kv_heads, TRAIN_SEQ,
            TRAIN_SEQ, c.head_dim)


def _flash_path_row(rng, dev, what, shape, causal, window, qdt, kvdt):
    """The attention kernel timed at one launch shape of an LM path: CUDA
    events, the profiler's device time, its twin, its bound (split-TF32 on
    the tensor cores for ``flash_fwd`` on float32 queries, the BF16
    tensor-core rate for bf16 q and k/v, float32 CUDA cores for the
    split-key kernel) and one SDPA call (on the cache cast to q's dtype
    outside the timed window where K/V are bf16 and q float32). The path
    shapes have no window: a causal one counts the (query, key) pairs its
    mask keeps (queries right-aligned), any other every pair."""
    B, Hq, Hkv, Lq, Lk, D = shape
    q, k, v = _flash_args(rng, dev, *shape, qdt=qdt, kvdt=kvdt)
    kern = lambda: FA.flash_attention(q, k, v, causal=causal, window=window)
    k32, v32 = k.to(qdt), v.to(qdt)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k32, v32, is_causal=causal, enable_gqa=True)
    if causal and Lq != Lk:
        fail(f"{what}: SDPA's is_causal is left-aligned; a path shape has Lq == Lk")
    check_close(f"SDPA at the {what} shape", [sdpa()], [kern()], FLASH_TOL[qdt])
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    pairs = Lq * (Lq + 1) / 2 if causal else Lq * Lk
    nops = 4.0 * B * Hq * D * pairs
    split_key = Lq * (Hq // Hkv) <= FA.SPLIT_ROWS
    bf16 = qdt == kvdt == torch.bfloat16
    b, by = (bound_ms(nbytes, nops) if split_key
             else bound_ms(nbytes, nops, BF16_OPS_S) if bf16
             else bound_ms(nbytes, SPLIT_TF32_PRODUCTS * nops, TF32_OPS_S))
    reps = 50 if split_key else 10
    out = dict(shape=[list(q.shape), list(k.shape), f"{str(qdt)[6:]} q, {str(kvdt)[6:]} k/v"],
               kernel="flash_fwd_split" if split_key else "flash_fwd",
               ms=cuda_ms(kern, reps), device_ms=profiled_ms(kern, reps, FLASH_KERNEL),
               plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v, causal=causal), 3, warm=1),
               library_ms=cuda_ms(sdpa, reps), bound_ms=b, bound_by=by)
    if not split_key and not bf16:
        out["fp32_bound_ms"] = bound_ms(nbytes, nops)[0]
    return out


def phase_flash(dev):
    """The attention kernel against its twin at every listed shape, then
    timed at the LM path's prefill and decode shapes beside the twin, its
    bound and one PyTorch SDPA call."""
    rng = torch.Generator(device=dev).manual_seed(SEED)
    worst = prefill_err = 0.0
    for what, shape, causal, window, qdt, kvdt in _flash_cases():
        q, k, v = _flash_args(rng, dev, *shape, qdt=qdt, kvdt=kvdt)
        got = FA.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if got.dtype != q.dtype or got.shape != q.shape:
            fail(f"flash_attention ({what}): {got.dtype} {tuple(got.shape)}")
        err = check_close(f"flash_attention kernel ({what})", [got.float()],
                          [want.float()], FLASH_TOL[qdt])
        worst = max(worst, err)
        if what == "prefill":
            prefill_err = err
            if not err <= PREFILL_TOL:
                fail(f"flash_attention kernel (prefill): max |diff| {err} > {PREFILL_TOL}")
        if what == "Lq > Lk" and not bool((got[:, :, :16] == 0).all()):
            fail("flash_attention: rows with no key left are not 0")
        del got, want
    B, Hq, Hkv, S, _, D = _flash_cases()[0][1]
    q, k, v = _flash_args(rng, dev, B, Hq, Hkv, S, S, D)
    kern = lambda: FA.flash_attention(q, k, v, causal=True)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    # q, k, v in and o out once; 2·D multiply-adds for each (query, key)
    # pair the causal mask keeps, each as SPLIT_TF32_PRODUCTS TF32 products
    # on the tensor cores; the float32 CUDA-core bound of the same work
    # beside it
    nbytes, nops = 4 * (2 * q.numel() + 2 * k.numel()), 4.0 * B * Hq * D * S * (S + 1) / 2
    row = dict(source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:89", max_abs_err=worst,
               prefill_max_abs_err=prefill_err,
               ms=cuda_ms(kern, 10),
               device_ms=profiled_ms(kern, 5, FLASH_KERNEL),
               plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v), 3, warm=1),
               library_ms=cuda_ms(sdpa, 10),
               bound_route=f"TF32 tensor cores, {SPLIT_TF32_PRODUCTS} products a float32 "
                           "product (split TF32)",
               fp32_bound_ms=bound_ms(nbytes, nops)[0],
               work=(nbytes, SPLIT_TF32_PRODUCTS * nops, TF32_OPS_S))
    check_close("SDPA (the library yardstick)", [sdpa()], [kern()], FLASH_TOL[q.dtype])
    del q, k, v
    _, _, _, _, W, _ = _flash_cases()[1][1]
    q, k, v = _flash_args(rng, dev, B, Hq, Hkv, 1, W, D, kvdt=torch.bfloat16)
    kern = lambda: FA.flash_attention(q, k, v, causal=False)
    b, by = bound_ms(2 * k.numel() * 2 + 2 * q.numel() * 4, 4.0 * B * Hq * D * W)
    # SDPA takes one dtype: the cache cast to float32 before the timed calls
    k32, v32 = k.float(), v.float()
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k32, v32, enable_gqa=True)
    check_close("SDPA at the decode shape", [sdpa()], [kern()], FLASH_TOL[q.dtype])
    row["decode"] = dict(shape=[list(q.shape), list(k.shape), "bfloat16 cache"],
                         ms=cuda_ms(kern, 50), device_ms=profiled_ms(kern, 20, FLASH_KERNEL),
                         plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v, causal=False), 10),
                         library_ms=cuda_ms(sdpa, 50),
                         library="scaled_dot_product_attention(q, k32, v32, enable_gqa=True) "
                                 "on the cache cast to float32 outside the timed window",
                         bound_ms=b, bound_by=by)
    row["shapes"] = {c[0]: _flash_path_row(rng, dev, *c) for c in _flash_cases()
                     if c[0] in PATH_CASES}
    # the head-dim-128 instantiations the MoE paths run: registers, spills
    d128 = {}
    for entry, ln in _ptxas("flash_attention"):
        if "ILi128E" in entry:
            d128.setdefault(entry, []).append(ln)
    row["d128_ptxas"] = {e: " / ".join(v) for e, v in d128.items()}
    say(f"flash_attention: {len(_flash_cases())} shapes (the LM path's prefill and "
        f"decode, the reference sweep, hymba's 25/5 heads with window 1024 and "
        f"without, Lq = Lk = 37, Lq = 1, Lq > Lk, decode over 2017 keys, hymba's "
        f"decode with window 1024, 4 positions × 4 heads, whisper's encoder, cross "
        f"prefill and cross decode, hymba's ring decode, hymba's prefill and global "
        f"decode, whisper's decoder self-attention, grok's head-dim-128 prefill and "
        f"decode, llama4's decode, grok's bf16 training launch on a mesh replica) — each "
        f"matches its twin (max "
        f"|diff| {worst}; prefill {prefill_err}); prefill {row['ms']:.4f} ms events, "
        f"{row['device_ms']} ms "
        f"device, twin {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms; "
        f"decode {row['decode']['ms']:.4f} ms events, {row['decode']['device_ms']} ms device, "
        f"SDPA on the f32-cast cache {row['decode']['library_ms']:.4f} ms; "
        + "; ".join(f"{w} {r['ms']:.4f} ms events, {r['device_ms']} ms device, bound "
                    f"{r['bound_ms']:.4f}, SDPA {r['library_ms']:.4f}"
                    for w, r in row["shapes"].items()))
    return {"flash_attention": row}


@contextlib.contextmanager
def twin_attention():
    """Route every attention of the model to the kernel's plain twin (on
    the card: the check's yardstick, never the served path)."""
    saved = ops.flash_attention
    ops.flash_attention = ref.flash_attention
    try:
        yield
    finally:
        ops.flash_attention = saved


def _greedy(params, cfg, prompt, steps, forced=None, frames=None, **kw):
    """prefill + ``steps`` decode steps; each step feeds the last step's
    argmax, or ``forced[:, t]`` when given; ``frames``: an encoder's input;
    ``kw``: prefill's options (``moe_dense``). Returns the prefill logits,
    each step's logits, the fed tokens [B, steps] and the cache."""
    if frames is not None:
        kw["frames"] = frames
    lg, cache = TT.prefill(params, cfg, prompt, max_new_tokens=steps, **kw)
    first, logits, fed = lg[:, -1], [], []
    cur = lg[:, -1]
    for t in range(steps):
        tok = (cur.argmax(-1) if forced is None else forced[:, t])[:, None]
        fed.append(tok)
        lg, cache = TT.decode_step(params, cfg, cache, tok)
        cur = lg[:, -1]
        logits.append(cur)
    return first, torch.stack(logits, 1), torch.cat(fed, 1), cache


def _cache_fields(cache):
    """(layer, field, tensor) of every tensor field of every layer of a
    decode cache, stacked or a tuple of layers (also the parent's package's
    `LayerCache`, for ``--speed``)."""
    layers = cache.layers
    names = [f.name for f in dataclasses.fields(layers[0] if isinstance(layers, tuple)
                                                else layers)]
    if isinstance(layers, tuple):
        return [(li, f, getattr(c, f)) for li, c in enumerate(layers) for f in names
                if getattr(c, f) is not None]
    set_ = [f for f in names if getattr(layers, f) is not None]
    return [(li, f, getattr(layers, f)[li])
            for li in range(getattr(layers, set_[0]).shape[0]) for f in set_]


def _compare_caches(what, got, want):
    """Every float field within the bf16 kernel tolerance, positions equal."""
    g, w = _cache_fields(got), _cache_fields(want)
    if [(li, f, tuple(t.shape)) for li, f, t in g] != [(li, f, tuple(t.shape)) for li, f, t in w]:
        fail(f"{what}: the caches' layouts differ")
    worst = 0.0
    for (li, f, a), (_, _, b) in zip(g, w):
        a, b = a.cpu(), b.cpu()
        if f.startswith("kpos"):
            if not torch.equal(a, b):
                fail(f"{what}: layer {li}'s cache positions ({f}) differ")
            continue
        worst = max(worst, check_close(f"{what} (layer {li} {f})", [a.float()], [b.float()],
                                       FLASH_TOL[torch.bfloat16]))
    return worst


def _rel(got, want) -> float:
    """max |got − want| over the largest |want|: the LM checks' unit."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _kernel_split(fn):
    """One call of ``fn`` under the profiler: card ms in the attention
    kernel, in matrix products (cuBLAS / CUTLASS kernels) and in the rest,
    and the wall ms."""
    by_name, wall_us, _ = kernel_us(fn)
    split = dict(flash_attention=0.0, matmul=0.0, other=0.0)
    for name, us in by_name.items():
        key = ("flash_attention" if FLASH_KERNEL in name else
               "matmul" if any(s in name.lower() for s in ("gemm", "xmma", "cutlass"))
               else "other")
        split[key] += us / 1e3
    split["wall"] = wall_us / 1e3
    return split


@dataclasses.dataclass(frozen=True)
class LMPath:
    """One LM serving path of the script: its JSON line's name, the config
    served at full width, prompts × prompt tokens (an encoder–decoder: ×
    ``frames`` encoder frames too, the prompt the first target tokens),
    greedy steps, and the card-vs-CPU check's (layers, prompt tokens,
    steps, frames) and other changes to the config (``cpu_changes``);
    ``check_b_batch``: the sequences check (b) runs (0: all)."""
    line: str
    cfg: object
    batch: int
    prompt: int
    new: int
    cpu: tuple
    frames: int = 0
    check_b_batch: int = 0
    cpu_changes: tuple = ()


def _lm_inputs(cfg, batch, prompt, frames, seed, step, dev):
    """(prompt tokens [B, prompt], frames [B, frames, d] or None) from
    ``lm_batch``: a decoder-only config's tokens, or an encoder–decoder's
    frames and the first target tokens."""
    if not frames:
        b = lm_batch(cfg, batch, prompt, seed=seed, step=step)
        return torch.from_numpy(b["tokens"][0]).to(dev), None
    b = lm_batch(cfg, batch, frames, seed=seed, step=step)
    return (torch.from_numpy(b["target_tokens"][0][:, :prompt]).to(dev),
            torch.from_numpy(b["frames"][0]).to(dev))


def _spans_ms(fn, names):
    """One call of ``fn`` with each of the functions ``names`` of
    `repro_torch.models.ssm` bracketed by CUDA events: the ms in each,
    summed over its calls."""
    from repro_torch.models import ssm as SM
    spans = {name: [] for name in names}
    saved = {name: getattr(SM, name) for name in names}

    def bracket(name):
        def call(*args, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = saved[name](*args, **kw)
            e1.record()
            spans[name].append((e0, e1))
            return out
        return call

    for name in names:
        setattr(SM, name, bracket(name))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for name, f in saved.items():
            setattr(SM, name, f)
    return [sum(e0.elapsed_time(e1) for e0, e1 in spans[n]) for n in names]


def _moe_slots(fn):
    """One call of ``fn`` counting MoE capacity dispatch (`layers.slots`):
    (slots dispatched, slots dropped, C) of each call, in call order."""
    from repro_torch.models import layers as LY
    saved, seen = LY.slots, []

    def counted(experts, E, C, *rest):
        out = saved(experts, E, C, *rest)
        seen.append((out[2].numel(), (~out[2]).sum(), C))
        return out

    LY.slots = counted
    try:
        fn()
    finally:
        LY.slots = saved
    return [(n, int(d), c) for n, d, c in seen]


def _moe_drops(fn):
    """`_moe_slots` summed over the MoE layers: (slots dispatched, slots
    dropped, the capacities)."""
    seen = _moe_slots(fn)
    return (sum(n for n, _, _ in seen), sum(d for _, d, _ in seen),
            sorted({c for _, _, c in seen}))


def _mem_available() -> int:
    """The host's MemAvailable, bytes."""
    with open("/proc/meminfo") as fh:
        for ln in fh:
            if ln.startswith("MemAvailable:"):
                return int(ln.split()[1]) * 1024
    fail("no MemAvailable in /proc/meminfo")


def _is_pair(cfg) -> bool:
    """llama4: each layer of the stack is a (dense, MoE) pair with two
    attentions."""
    return cfg.num_experts > 0 and cfg.moe_every == 2


def _serve_lm(dev, path: LMPath):
    """``path.cfg`` at full width served on the card: ``path.batch``
    prompts, prefill and ``path.new`` greedy decode steps through the
    attention kernel, with every launch count at 0 just before and read
    just after; then checks (a) twin path, (b) prefill/decode against
    forward_logits in float32 (MoE: both with ``moe_dense=True``, since
    capacity depends on the tokens of a call) and, after the profile and
    with the served weights released, (c) card against the CPU plain path
    at ``path.cpu[0]`` layers. Prints the path's JSON line; returns the
    launches."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matrix products are on: the reference computes in float32")
    cfg, B, P, N = path.cfg, path.batch, path.prompt, path.new
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = LMP.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    toks, frames = _lm_inputs(cfg, B, P, path.frames, SEED, 0, dev)
    # cuBLAS and kernel warm-up
    _greedy(params, cfg, toks[:1, :64], 2, frames=None if frames is None else frames[:1, :64])
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    kw = {} if frames is None else dict(frames=frames)
    t0 = time.perf_counter()
    lg, cache = TT.prefill(params, cfg, toks, max_new_tokens=N, **kw)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    first, steps, fed, step_s = lg[:, -1], [], [], []
    cur = first
    for _ in range(N):
        tok = cur.argmax(-1)[:, None]
        t0 = time.perf_counter()
        lg, cache = TT.decode_step(params, cfg, cache, tok)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        fed.append(tok)
        cur = lg[:, -1]
        steps.append(cur)
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    steps, fed = torch.stack(steps, 1), torch.cat(fed, 1)
    windows = TT.layer_windows(cfg)
    # attention launches of a layer of the stack: none for RWKV6, two for a
    # llama4 pair or a decoder layer with cross-attention, else one
    L, pair = len(windows), _is_pair(cfg)
    X = 0 if cfg.attention_free else 1 + int(bool(cfg.cross_attention)) + int(pair)
    want = cfg.encoder_layers + L * X * (1 + N)
    if launches["flash_attention"] != want:
        fail(f"the {path.line} path launched flash_attention {launches['flash_attention']} "
             f"times, expected {cfg.encoder_layers} + {L * X} × (1 + {N}) = {want}")
    if not (bool(torch.isfinite(first).all()) and bool(torch.isfinite(steps).all())):
        fail(f"the {path.line} path's logits are not finite")
    fields = _cache_fields(cache)
    if cfg.rwkv:
        hd = cfg.rwkv_head_dim
        got = [tuple(t.shape) for _, f, t in fields if f == "rwkv_s"]
        shapes = [(B, cfg.d_model // hd, hd, hd)] * L
    else:
        got = [tuple(t.shape) for _, f, t in fields if f in ("k", "k2")]
        shapes = [(B, int(w) if w > 0 else P + N, cfg.num_kv_heads, cfg.head_dim)
                  for w in windows for _ in range(1 + int(pair))]
    if cache.pos != P + N or got != shapes:
        fail(f"the {path.line} cache is at {cache.pos} with state shapes {got}")

    # (a) the same calls with every attention on the twin
    ops.reset_launches()
    with twin_attention():
        t_first, t_steps, _, t_cache = _greedy(params, cfg, toks, N, forced=fed, frames=frames)
    if ops.launches()["flash_attention"]:
        fail("the twin path launched the kernel")
    err_a = max(_rel(first, t_first), _rel(steps, t_steps))
    if not err_a <= LM_TOL:
        fail(f"(a) {path.line}: kernel path vs twin path: logits differ by {err_a} of the largest")
    cache_err = _compare_caches(f"(a) {path.line}: the kernel path's cache vs the twin path's",
                                cache, t_cache)
    del t_cache, t_first, t_steps

    # (b) the reference's consistency check at full width, in float32, on
    # the first check_b_batch sequences; MoE dense on both sides; RWKV6's
    # full sequence padded to whole WKV chunks (causal: the padding reaches
    # no compared position)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    Bb = path.check_b_batch or B
    moe = dict(moe_dense=True) if cfg.num_experts else {}
    seq = torch.cat([toks[:Bb], fed[:Bb]], 1)
    if cfg.rwkv and seq.shape[1] % WKV_CHUNK:
        seq = torch.cat([seq, seq[:, -1:].expand(-1, WKV_CHUNK - seq.shape[1] % WKV_CHUNK)], 1)
    fr = None if frames is None else frames[:Bb]
    full = TT.forward_logits(params, cfg32, {"tokens": seq} if fr is None
                             else {"frames": fr, "target_tokens": seq}, **moe)
    full = (full[:, P - 1], full[:, P:P + N])
    f_first, f_steps, _, f_cache = _greedy(params, cfg32, toks[:Bb], N, forced=fed[:Bb],
                                           frames=fr, **moe)
    err_b = (_rel(f_first, full[0]), _rel(f_steps, full[1]))
    if any(t.dtype != torch.float32 for _, f, t in _cache_fields(f_cache)
           if not f.startswith("kpos")):
        fail("(b) the float32 config's cache is not float32")
    if not (err_b[0] <= 2e-3 and err_b[1] <= 5e-3):
        fail(f"(b) {path.line}: prefill / decode vs forward_logits differ by {err_b} of the "
             f"largest logit (limits 2e-3, 5e-3)")
    del full, f_cache, f_first, f_steps

    # where the time goes: one prefill and one decode step under the profiler
    split_prefill = _kernel_split(lambda: TT.prefill(params, cfg, toks, max_new_tokens=N, **kw))
    _, cache = TT.prefill(params, cfg, toks, max_new_tokens=N, **kw)
    tok = fed[:, :1]
    split_decode = _kernel_split(lambda: TT.decode_step(params, cfg, cache, tok))
    checks_launched = ops.launches()["flash_attention"]
    line = dict(
        arch=cfg.name, layers=L, d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads],
        params=LMP.param_count(cfg), param_bytes=param_bytes, init_s=t_init,
        batch=B, prompt=P, new_tokens=N, cache_dtype=cfg.dtype,
        prefill_s=t_prefill, prefill_tokens_s=B * P / t_prefill,
        decode_ms_p50=_pct(step_s, 50), decode_ms_p99=_pct(step_s, 99),
        decode_tokens_s=B / float(np.mean(step_s)),
        peak_alloc_bytes=peak, resident_before_bytes=resident,
        flash_launches=launches["flash_attention"],
        flash_launches_checks=checks_launched)
    if cfg.encoder_layers:
        line.update(encoder_layers=cfg.encoder_layers, frames=path.frames,
                    prefill_frames_s=B * path.frames / t_prefill)
    if cfg.hybrid_ssm:
        # the SSM's and its scan's card time in one prefill and one decode
        # step ("other" in the profiles), by CUDA events around each call
        names = ("mamba", "_doubling_scan")
        ssm, scan = _spans_ms(lambda: TT.prefill(params, cfg, toks, max_new_tokens=N, **kw), names)
        d_ssm, d_scan = _spans_ms(lambda: TT.decode_step(params, cfg, cache, tok), names)
        line.update(windows=sorted({int(w) for w in windows}),
                    ssm_chunks=P // SSM_CHUNK if P % SSM_CHUNK == 0 else 1,
                    prefill_ssm_ms=ssm, prefill_ssm_scan_ms=scan,
                    decode_ssm_ms=d_ssm, decode_ssm_scan_ms=d_scan)
    if cfg.rwkv:
        # the time mix's and its WKV's card time, likewise
        names = ("rwkv_time_mix", "_rwkv_wkv_chunk")
        tm, wkv = _spans_ms(lambda: TT.prefill(params, cfg, toks, max_new_tokens=N), names)
        d_tm, d_wkv = _spans_ms(lambda: TT.decode_step(params, cfg, cache, tok), names)
        line.update(wkv_chunks=P // WKV_CHUNK, prefill_time_mix_ms=tm, prefill_wkv_ms=wkv,
                    decode_time_mix_ms=d_tm, decode_wkv_ms=d_wkv)
    if cfg.num_experts:
        slots, dropped, caps = _moe_drops(
            lambda: TT.prefill(params, cfg, toks, max_new_tokens=N))
        line.update(experts=[cfg.num_experts, cfg.experts_per_token],
                    shared_expert=cfg.shared_expert, prefill_capacity=caps,
                    prefill_slots=slots, prefill_dropped_slots=dropped,
                    check_b_sequences=Bb)
    del params, cache, lg, cur
    torch.cuda.empty_cache()

    # (c) the card against the CPU plain path, full width at a cut depth
    n_layers, cpu_prompt, cpu_steps, cpu_frames = path.cpu
    cfg2 = dataclasses.replace(cfg, num_layers=n_layers, **dict(path.cpu_changes), **(
        dict(encoder_layers=n_layers, decoder_layers=n_layers) if cfg.encoder_layers else {}))
    need, avail = LMP.param_count(cfg2) * 4, _mem_available()
    if avail < 1.25 * need:
        fail(f"(c) {path.line}: the host has {avail} bytes available, the CPU copy of "
             f"{n_layers} layers needs {need} and its activations")
    p2 = LMP.init_params(cfg2, SEED, device=dev)
    p2_cpu = _tree(p2, lambda t: t.cpu())
    t2, fr2 = _lm_inputs(cfg2, 1, cpu_prompt, cpu_frames, SEED, 1, "cpu")
    c_first, c_steps, c_fed, c_cache = _greedy(
        p2, cfg2, t2.to(dev), cpu_steps, frames=None if fr2 is None else fr2.to(dev))
    del p2
    h_first, h_steps, _, h_cache = _greedy(p2_cpu, cfg2, t2, cpu_steps, forced=c_fed.cpu(),
                                           frames=fr2)
    err_c = max(_rel(c_first.cpu(), h_first), _rel(c_steps.cpu(), h_steps))
    if not err_c <= LM_TOL:
        fail(f"(c) {path.line}: card vs CPU plain path: logits differ by {err_c} of the largest")
    _compare_caches(f"(c) {path.line}: the card's cache vs the CPU's", c_cache, h_cache)
    del p2_cpu, c_cache, h_cache
    torch.cuda.empty_cache()

    line.update(check_a_rel=err_a, check_a_cache_abs=cache_err, check_b_rel=list(err_b),
                check_c_rel=err_c, check_c_layers=n_layers, prefill_profile_ms=split_prefill,
                decode_profile_ms=split_decode)
    if path.cpu_changes:
        line["check_c_changes"] = dict(path.cpu_changes)
    say(f"{path.line} " + json.dumps(line))
    say(f"{path.line}: {cfg.name} ({L} {'pairs' if pair else 'layers'}, d {cfg.d_model}"
        + (f"; {cfg.encoder_layers} encoder layers over {path.frames} frames"
           if cfg.encoder_layers else "")
        + (f"; {cfg.num_experts} experts top-{cfg.experts_per_token}, "
           f"{line['prefill_dropped_slots']} of {line['prefill_slots']} prefill slots dropped"
           if cfg.num_experts else "")
        + f") served {B} × {P} tokens + {N} greedy steps with "
        f"{line['flash_launches']} flash_attention launches; (a) == twin path ({err_a:.3g} of "
        f"the largest logit), (b) == forward_logits in float32 on {Bb} of {B} sequences "
        f"({err_b[0]:.3g}, {err_b[1]:.3g}), (c) card == CPU plain path at {n_layers} layers "
        f"({err_c:.3g})")
    return launches


def phase_lm(dev):
    """tinyllama-1.1b at full width: 4 prompts of 2016 tokens, prefill and
    32 greedy decode steps (the published 2048-token context)."""
    return _serve_lm(dev, LMPath("lm", LM_CONFIG, LM_BATCH, LM_PROMPT, LM_NEW, LM_CPU + (0,)))


def phase_lm_hybrid(dev):
    """hymba-1.5b at full width: 4 prompts of 2048 tokens (8 SSM chunks of
    256; the 1024-wide rings wrap), prefill and 32 greedy steps."""
    return _serve_lm(dev, LMPath("lm_hybrid", HYBRID_CONFIG, LM_BATCH, HYBRID_PROMPT, LM_NEW,
                                 HYBRID_CPU + (0,)))


def phase_lm_encdec(dev):
    """whisper-small at full width: 4 × 1500 encoder frames, the first 416
    target tokens as the prompt, 32 greedy steps (its 448-token text
    context)."""
    return _serve_lm(dev, LMPath("lm_encdec", ENCDEC_CONFIG, LM_BATCH, ENCDEC_PROMPT, LM_NEW,
                                 ENCDEC_CPU, frames=ENCDEC_FRAMES))


def phase_lm_moe(dev):
    """grok-1 at full width, 2 of its 64 layers (45.8 GB of f32 weights):
    4 prompts of 2048 tokens (capacity 2560 an expert; the line counts the
    dropped slots), prefill and 32 greedy (dense-MoE) steps; check (b) on
    one sequence, (c) at 1 layer."""
    return _serve_lm(dev, LMPath("lm_moe", MOE_CONFIG, LM_BATCH, MOE_PROMPT, LM_NEW, MOE_CPU,
                                 check_b_batch=1))


def phase_lm_moe_pair(dev):
    """llama4-maverick at full matrix widths: one (dense, MoE) pair with 64
    of its 128 experts (42.1 GB of f32 weights), 4 prompts of 2048 tokens
    (capacity 160), prefill and 32 greedy steps: two attentions a pair;
    check (b) on one sequence, (c) with 8 experts."""
    return _serve_lm(dev, LMPath("lm_moe_pair", PAIR_CONFIG, LM_BATCH, MOE_PROMPT, LM_NEW,
                                 PAIR_CPU, check_b_batch=1,
                                 cpu_changes=(("num_experts", PAIR_CPU_EXPERTS),)))


def phase_lm_rwkv(dev):
    """rwkv6-3b at full width and depth: 4 prompts of 2048 tokens (32 WKV
    chunks of 64; every length here a multiple of 64, as the reference's
    chunk rule runs any other as one [B, T, T, H, 64] chunk), prefill and
    32 greedy steps; no attention, so no flash_attention launch."""
    return _serve_lm(dev, LMPath("lm_rwkv", RWKV_CONFIG, LM_BATCH, RWKV_PROMPT, LM_NEW,
                                 RWKV_CPU))


def _bwd_cases():
    """(what, (B, Hq, Hkv, Lq, Lk, D), causal, window, dtype) of every
    check of the backward kernel: the training path's launch, then the
    sweep."""
    f32, bf16 = torch.float32, torch.bfloat16
    c = TRAIN_CONFIG
    train = ("train", (TRAIN_BATCH // TRAIN_MB, c.num_heads, c.num_kv_heads, TRAIN_SEQ,
                       TRAIN_SEQ, c.head_dim), True, 0, bf16)
    # the mesh phases' launches: a microbatch's rows over MESH_SHAPE's data
    # axis, tinyllama's and grok's
    replica = ("train mesh replica", (TRAIN_BATCH // TRAIN_MB // MESH_SHAPE[0], c.num_heads,
                                      c.num_kv_heads, TRAIN_SEQ, TRAIN_SEQ, c.head_dim),
               True, 0, bf16)
    grok = ("train mesh replica grok", _grok_replica_shape(), True, 0, bf16)
    sweep = [(f"D {D} {str(dt)[6:]}", (2, 8, 2, 384, 384, D), True, 0, dt)
             for D in FA.HEAD_DIMS for dt in (f32, bf16)]
    # the window, cross and no-key shapes in both dtypes: bf16 takes the
    # tensor-core kernels, float32 the CUDA-core ones
    window, cross = (1, 25, 5, 2048, 2048, 64), (2, 12, 12, ENCDEC_PROMPT, ENCDEC_FRAMES, 64)
    return [train, replica, grok] + sweep + [
        ("window 1024", window, True, 1024, f32),
        ("window 1024 bf16", window, True, 1024, bf16),
        ("whisper cross", cross, False, 0, f32),
        ("whisper cross bf16", cross, False, 0, bf16),
        ("ragged Lq < Lk", (2, 32, 4, 300, 777, 64), True, 0, bf16),
        ("rows with no key", (2, 8, 4, 100, 40, 64), True, 0, f32),
        ("rows with no key bf16", (2, 8, 4, 100, 40, 64), True, 0, bf16),
    ]


def _rel_each(got, want) -> float:
    """The largest over the outputs of max |got − want| over max |want|."""
    return max(_rel(g.float(), w.float()) for g, w in zip(got, want))


def phase_attention_bwd(dev):
    """The backward kernel against its twin at the training launches and
    the sweep, bit-equal across two launches, then timed at tinyllama's
    training launch and grok's mesh replica's, each beside its twin, its
    bound and SDPA's backward."""
    rng = torch.Generator(device=dev).manual_seed(SEED + 26)
    errs, abs_err = {}, 0.0
    for what, shape, causal, window, dt in _bwd_cases():
        q, k, v = _flash_args(rng, dev, *shape, qdt=dt, kvdt=dt)
        do = torch.randn(q.shape, generator=rng, device=dev).to(dt)
        o = FA.flash_attention(q, k, v, causal=causal, window=window)
        got = FA.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
        again = FA.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
        want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
        torch.cuda.synchronize()
        for g, a, x in zip(got, again, (q, k, v)):
            if g.dtype != x.dtype or g.shape != x.shape:
                fail(f"flash_attention_bwd ({what}): {g.dtype} {tuple(g.shape)}")
            if not torch.equal(g, a):
                fail(f"flash_attention_bwd ({what}): two launches differ")
        errs[what] = _rel_each(got, want)
        abs_err = max(abs_err, max(float((g.double() - w.double()).abs().max())
                                   for g, w in zip(got, want)))
        if not errs[what] <= BWD_TOL[dt]:
            fail(f"flash_attention_bwd ({what}) differs from its twin by {errs[what]} of "
                 f"the largest (limit {BWD_TOL[dt]})")
        B, Hq, Hkv, Lq, Lk, D = shape
        if what.startswith("rows with no key") and bool(got[0][:, :, :Lq - Lk].any()):
            fail("flash_attention_bwd: rows with no key got a gradient")
        del q, k, v, do, o, got, again, want
    torch.cuda.empty_cache()

    _, shape, _, _, dt = _bwd_cases()[0]
    row = dict(source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="none: src/repro/models/layers.py:91 (attend), differentiated by XLA; "
                        "the Pallas kernel src/repro/kernels/flash_attention.py:73 has no "
                        "backward",
               max_abs_err=abs_err, max_rel_err_by_case=errs,
               library="the backward alone of scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) on the same bf16 inputs",
               **_bwd_timing(rng, dev, shape, dt, by_kernel=True))
    grok = _bwd_timing(rng, dev, _grok_replica_shape(), torch.bfloat16)
    grok["bound_ms"], grok["bound_by"] = bound_ms(*grok.pop("work"))
    row["grok_mesh_replica"] = grok
    row["ptxas"] = {}
    for e, ln in _ptxas("flash_attention_bwd"):
        row["ptxas"][e] = f"{row['ptxas'][e]}; {ln}" if e in row["ptxas"] else ln
    row["sass"] = _sass_counts("flash_attention_bwd", BWD_TC_KERNELS, BWD_SASS_OPS)
    say(f"attention_bwd: {len(errs)} shapes (tinyllama's training launch and its mesh "
        f"replica's, grok's mesh replica's, D 32/64/96/128 "
        f"in f32 and bf16; window 1024, whisper's cross shape and rows with no key in f32 "
        f"and bf16; ragged Lq < Lk) — each matches its twin (largest error "
        f"{max(errs.values()):.3g} of the largest output) and is bit-equal across two "
        f"launches; training launch {row['ms']:.4f} ms events, {row['device_ms']} ms device "
        f"({', '.join(f'{p} {v}' for p, v in row['device_ms_by_kernel'].items())}), twin "
        f"{row['plain_ms']:.4f} ms, SDPA backward {row['library_ms']:.4f} ms, bound "
        f"{bound_ms(*row['work'])[0]:.4f} ms ({row['bound_route']}; "
        f"{row['fp32_bound_ms']:.4f} ms on the float32 CUDA cores); grok's mesh replica "
        f"launch {grok['ms']:.4f} ms events, {grok['device_ms']} ms device, twin "
        f"{grok['plain_ms']:.4f} ms, SDPA backward {grok['library_ms']:.4f} ms, bound "
        f"{grok['bound_ms']:.4f} ms; SASS {json.dumps(row['sass'])}")
    torch.cuda.empty_cache()
    return {"flash_attention_bwd": row}


def _bwd_timing(rng, dev, shape, dt, by_kernel: bool = False):
    """The backward kernel timed at one causal launch ``shape`` in ``dt``:
    CUDA events, the profiler's device time (``by_kernel``: also each of
    BWD_PARTS alone), its twin, SDPA's backward alone (its forward outside
    the timed window), and the work of its bound."""
    B, Hq, Hkv, S, _, D = shape
    q, k, v = _flash_args(rng, dev, *shape, qdt=dt, kvdt=dt)
    do = torch.randn(q.shape, generator=rng, device=dev).to(dt)
    o = FA.flash_attention(q, k, v, causal=True)
    kern = lambda: FA.flash_attention_bwd(q, k, v, o, do, causal=True)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True,
                                                           enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
    check_close(f"SDPA's backward at {list(q.shape)} (the library yardstick)",
                [g.float() for g in sdpa_bwd()], [g.float() for g in kern()], 5e-2)
    # q, k, v, o, dO in and dq, dk, dv out once; five products of 2·D
    # multiply-adds over each (query, key) pair the causal mask keeps, at
    # the card's tensor-core rate for the inputs' type: BF16, or for
    # float32 split TF32 (as flash_fwd's bound); the float32 CUDA-core
    # figure is kept beside it, labelled
    el = q.element_size()
    nbytes = el * (4 * q.numel() + 4 * k.numel())
    nops = 5 * 2.0 * D * B * Hq * S * (S + 1) / 2
    work, route = ((nbytes, nops, BF16_OPS_S), "BF16 tensor cores, five products a pair")
    if dt == torch.float32:
        work = (nbytes, SPLIT_TF32_PRODUCTS * nops, TF32_OPS_S)
        route = (f"TF32 tensor cores, five products a pair, {SPLIT_TF32_PRODUCTS} TF32 "
                 f"products a float32 product (split TF32)")
    out = dict(shape=[list(q.shape), list(k.shape), f"{str(dt)[6:]}, causal"],
               ms=cuda_ms(kern, 10), device_ms=profiled_ms(kern, 5, BWD_KERNEL),
               plain_ms=cuda_ms(lambda: ref.flash_attention_bwd(q, k, v, o, do), 3, warm=1),
               library_ms=cuda_ms(sdpa_bwd, 10), bound_route=route, work=work,
               fp32_bound_ms=bound_ms(nbytes, nops, FP32_OPS_S)[0])
    if by_kernel:
        out["device_ms_by_kernel"] = {p: profiled_ms(kern, 5, p) for p in BWD_PARTS}
    return out


def _memorisable_batch(B, S, n_mb, dev):
    """The reference test's batch (tests/test_train.py:13): tokens =
    position mod 17, labels the next token (the last ignored),
    microbatch-major."""
    toks = (np.arange(S)[None, :].repeat(B, 0) % 17).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    return {k: torch.from_numpy(v).to(dev) for k, v in
            TS.reshape_batch({"tokens": toks, "labels": labels}, n_mb).items()}


def _train_split(step, spans=None):
    """One call of ``step`` under the profiler: card ms in matrix products,
    the attention forward, its backward, each of ``spans`` ({name: (module,
    function)}: the other kernels that run inside a call of that function;
    by default the optimizer, `optimizer.apply`) and the rest, and the wall
    ms (`_split_kernels`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    spans = spans or {"optimizer": (OPT, "apply")}
    saved = {name: getattr(mod, fn) for name, (mod, fn) in spans.items()}

    def wrap(name):
        def call(*args, **kw):
            with record_function(f"span_{name}"):
                return saved[name](*args, **kw)
        return call

    for name, (mod, fn) in spans.items():
        setattr(mod, fn, wrap(name))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for name, (mod, fn) in spans.items():
            setattr(mod, fn, saved[name])
    split = _split_kernels([(e.name, e.time_range.start, e.time_range.end, e.device_time_total)
                            for e in prof.events() if e.device_type == DeviceType.CUDA], spans)
    split["wall"] = 1e3 * wall
    return split


def _split_kernels(events, spans):
    """Card ms by part from the card's events of a profile, each (name,
    start µs, end µs, device µs): kernels of matrix products and of the
    attention forward and backward by name; any other kernel in the span
    whose range on the card's timeline (its ``span_<name>`` annotation,
    from the span's first kernel to its last: one stream runs them in the
    order they were issued) holds its start, the innermost of nested
    spans; else the rest. Also the 8 kernels with the most time. (The
    spans' host events are not read: the profiler has credited them with
    library product kernels launched elsewhere.)"""
    split = dict(products=0.0, attention_fwd=0.0, attention_bwd=0.0, rest=0.0,
                 **dict.fromkeys(spans, 0.0))
    windows = sorted((t1 - t0, t0, t1, name[5:]) for name, t0, t1, _ in events
                     if name.startswith("span_"))
    by_name = {}
    for name, t0, _, us in events:
        if name.startswith("span_"):
            continue
        key = ("attention_fwd" if FLASH_KERNEL in name else
               "attention_bwd" if BWD_KERNEL in name else
               "products" if any(t in name.lower() for t in PRODUCT_KERNELS) else
               next((w for _, w0, w1, w in windows if w0 <= t0 < w1), "rest"))
        split[key] += us / 1e3
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    split["top_kernels"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return split


def _cut_grads(params, cfg, batch, n_mb):
    """(loss, gradient leaves in sorted-key order) of `accumulate_grads`
    over ``batch`` [B, S] cut into ``n_mb`` microbatches."""
    loss, grads = TS.accumulate_grads(cfg, params, TS.reshape_batch(batch, n_mb))
    return loss, OPT.tree_leaves(grads)


def _leaf_rel(got, want) -> float:
    """The largest over the leaves of max |got − want| over the leaf's
    largest |want| (a leaf of zeros on both sides counts 0)."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.double().cpu(), w.double().cpu()
        top = float(w.abs().max())
        d = float((g - w).abs().max())
        worst = max(worst, d / top if top > 0 else d)
    return worst


def _nondeterministic_ops(dev, B, S, cfg):
    """The library backward ops of the step, each run twice on the same
    inputs at the step's shapes: the names of those whose gradients
    differ (the embedding gather's and the cross-entropy gather's)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    draw = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    emb = draw(cfg.vocab_size, cfg.d_model).bfloat16().requires_grad_()
    up = draw(B, S, cfg.d_model).bfloat16()
    c = min(S, TT._CE_CHUNK)     # one chunk of the head's loss
    logits = draw(B, c, cfg.vocab_size).requires_grad_()
    up2 = draw(B, c, 1)
    cases = {
        "embedding gather backward (index, embed[tokens])":
            lambda: torch.autograd.grad(emb[toks], emb, up)[0],
        "cross-entropy gather backward (gather)":
            lambda: torch.autograd.grad(logits.gather(-1, toks[:, :c, None]), logits, up2)[0],
    }
    return [name for name, fn in cases.items() if not torch.equal(fn(), fn())]


def phase_train(dev):
    """tinyllama-1.1b trained at full width and depth on the card through
    `train_step.make_train_step` (the attention kernel forward and
    backward), with checks (i)–(vi); prints the ``train`` line and returns
    the launches."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matrix products are on: the reference computes in float32")
    cfg, B, S, n_mb = TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB
    L = len(TT.layer_windows(cfg))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state = TS.init_state(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in OPT.tree_leaves(state.params))
    tcfg = TS.TrainConfig(microbatches=n_mb, opt=OPT.AdamWConfig(**TRAIN_OPT))
    step = TS.make_train_step(cfg, tcfg)
    batch = _memorisable_batch(B, S, n_mb, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    marks, metrics = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, batch)
        e1.record()
        marks.append((e0, e1))
        metrics.append((m["loss"], m["grad_norm"], float(m["lr"])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in marks]
    losses = [float(x) for x, _, _ in metrics]
    norms = [float(x) for _, x, _ in metrics]

    # (i) the memorisable loss halves, everything finite
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"train: a non-finite loss or gradient norm: {losses} {norms}")
    if not losses[-1] < 0.5 * losses[0]:
        fail(f"train: the loss went from {losses[0]} to {losses[-1]} in {TRAIN_STEPS} "
             f"steps, not below half")
    # (iii) the kernels, not the twins: launches per step
    want = {"flash_attention": 2 * L * n_mb, "flash_attention_bwd": L * n_mb}
    for name, per in want.items():
        if launches[name] != per * TRAIN_STEPS:
            fail(f"train: {name} launched {launches[name]} times in {TRAIN_STEPS} steps, "
                 f"expected {per} a step ({L} layers × {n_mb} microbatches"
                 + (" × 2: the forward and its recomputation)" if per == 2 * L * n_mb else ")"))
    # (ii) every leaf gets a finite, nonzero gradient (one microbatch)
    _, g1 = TS.accumulate_grads(cfg, state.params, {k: v[:1] for k, v in batch.items()})
    bad = [".".join(p) for p, g in OPT.tree_items(g1)
           if not (bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0))]
    if bad:
        fail(f"train: parameter leaves with no gradient: {bad}")
    n_leaves = len(OPT.tree_leaves(g1))
    del g1
    split = _train_split(lambda: step(state, batch))
    del state, step
    torch.cuda.empty_cache()

    # (iv) + (v) at a cut depth in float32: kernels vs twin path vs CPU;
    # 1 vs 2 microbatches
    n_layers, cb, cs = TRAIN_CUT
    cfg2 = dataclasses.replace(cfg, num_layers=n_layers, dtype="float32")
    p2 = LMP.init_params(cfg2, SEED, device=dev)
    b = lm_batch(cfg2, cb, cs, seed=SEED, step=1)
    b = {k: torch.from_numpy(v[0]) for k, v in b.items()}
    bd = {k: v.to(dev) for k, v in b.items()}
    ops.reset_launches()
    loss_k, g_k = _cut_grads(p2, cfg2, bd, 1)
    if ops.launches()["flash_attention_bwd"] != n_layers:
        fail("train (iv): the cut model's gradient did not run the backward kernel")
    with twin_attention():
        loss_t, g_t = _cut_grads(p2, cfg2, bd, 1)
    loss_m, g_m = _cut_grads(p2, cfg2, bd, 2)
    p2_cpu = _tree(p2, lambda t: t.cpu())
    del p2
    loss_c, g_c = _cut_grads(p2_cpu, cfg2, b, 1)
    err = dict(twin=_leaf_rel(g_k, g_t), cpu=_leaf_rel(g_k, g_c), microbatches=_leaf_rel(g_m, g_k),
               loss_twin=abs(float(loss_k) - float(loss_t)) / abs(float(loss_t)),
               loss_cpu=abs(float(loss_k) - float(loss_c)) / abs(float(loss_c)),
               loss_microbatches=abs(float(loss_m) - float(loss_k)) / abs(float(loss_k)))
    if not max(err.values()) <= TRAIN_TOL:
        fail(f"train (iv)/(v): at {n_layers} layers in float32 the gradients differ: {err} "
             f"(limit {TRAIN_TOL} of each leaf's largest entry)")
    del g_k, g_t, g_m, g_c, p2_cpu
    torch.cuda.empty_cache()

    # (vi) two runs of a few steps from SEED: bit-equal, unless a library
    # backward op of the step is not deterministic on this card
    finals = []
    for _ in range(2):
        st = TS.init_state(cfg, SEED, device=dev)
        run = TS.make_train_step(cfg, tcfg)
        for _ in range(TRAIN_RESTART_STEPS):
            st, _ = run(st, batch)
        finals.append(st.params)
        del st, run
        torch.cuda.empty_cache()
    pairs = list(zip(OPT.tree_leaves(finals[0]), OPT.tree_leaves(finals[1])))
    restart_diff = max(float((a - b).abs().max()) for a, b in pairs)
    restart_equal = all(torch.equal(a, b) for a, b in pairs)
    del finals, pairs
    torch.cuda.empty_cache()
    nondet = _nondeterministic_ops(dev, B // n_mb, S, cfg)
    say("train (vi): library backward ops not deterministic on this card: "
        + (", ".join(nondet) if nondet else "none of the embedding and cross-entropy gathers"))
    # no such op: bit-equality is required. Else the runs may differ, but by
    # well below one step's update (a weight moves by up to lr a step):
    # RESTART_SHARE of the smallest step's lr
    restart_limit = 0.0
    if nondet:
        restart_limit = RESTART_SHARE * min(float(OPT.schedule(tcfg.opt, s))
                                            for s in range(1, TRAIN_RESTART_STEPS + 1))
        say(f"train (vi): two runs need not be bit-equal because of the ops above; limit "
            f"{restart_limit} ({RESTART_SHARE} of the smallest step's lr)")
    if not (restart_equal if not nondet else restart_diff <= restart_limit):
        fail(f"train (vi): two {TRAIN_RESTART_STEPS}-step runs differ by {restart_diff} "
             + (f"(limit {restart_limit})" if nondet else "and no op of the step is known "
                "not to be deterministic: bit-equality is required"))

    timed = step_ms[TRAIN_TIMED_FROM - 1:]
    line = dict(
        arch=cfg.name, layers=L, d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads],
        params=LMP.param_count(cfg), param_bytes=param_bytes, init_s=t_init,
        batch=B, seq=S, microbatches=n_mb, steps=TRAIN_STEPS, dtype=cfg.dtype,
        remat_policy=tcfg.remat_policy, opt=TRAIN_OPT,
        loss_first=losses[0], loss_last=losses[-1], losses=losses, grad_norms=norms,
        step_ms_p50=float(np.percentile(timed, 50)), step_ms_p99=float(np.percentile(timed, 99)),
        step_ms_timed_from=TRAIN_TIMED_FROM, wall_s=wall,
        tokens_s=B * S / (float(np.mean(timed)) / 1e3),
        peak_alloc_bytes=peak, launches={k: launches[k] for k in want},
        launches_per_step=want, leaves_with_gradient=n_leaves,
        check_iv_v=err, check_iv_layers=n_layers, check_iv_tokens=[cb, cs],
        restart_max_abs_diff=restart_diff, restart_bit_equal=restart_equal,
        restart_limit=restart_limit,
        nondeterministic_ops=nondet, step_profile_ms=split)
    say("train " + json.dumps(line))
    say(f"train: {cfg.name} ({L} layers, d {cfg.d_model}) trained {TRAIN_STEPS} steps of "
        f"{B} × {S} tokens in {n_mb} microbatches: loss {losses[0]:.4f} → {losses[-1]:.4f}; "
        f"step {line['step_ms_p50']:.1f} ms p50 ({line['tokens_s']:.0f} tokens/s), peak "
        f"{peak / 1e9:.1f} GB; {want['flash_attention']} flash_attention and "
        f"{want['flash_attention_bwd']} flash_attention_bwd launches a step; (ii) {n_leaves} "
        f"leaves with a gradient; (iv) kernels == twin path ({err['twin']:.3g}) == CPU "
        f"({err['cpu']:.3g}) at {n_layers} layers in float32, (v) 1 == 2 microbatches "
        f"({err['microbatches']:.3g}); (vi) two {TRAIN_RESTART_STEPS}-step runs: max |diff| "
        f"{restart_diff}, bit-equal {restart_equal}")
    return launches


@contextlib.contextmanager
def _timing(module, names, into):
    """Time every call of ``module.<name>`` for each of ``names`` (host
    seconds, appended to ``into[name]``) inside the block."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            into[name].append(time.perf_counter() - t0)
            return out
        return timed

    for n in names:
        setattr(module, n, wrap(n, saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _state_trees(st):
    return [st.params, st.opt.mu, st.opt.nu]


def phase_train_loop(dev):
    """tinyllama-1.1b at full width and depth through the training driver
    (`launch.train.train_loop`): (a) an uninterrupted run of LOOP_STEPS
    steps; (b) `fault.run_with_restart` over the same run checkpointing
    every LOOP_EVERY steps into a temporary directory, a failure injected
    after step LOOP_FAIL_AT on the first call only. Checks: one restart,
    resumed at LOOP_EVERY, checkpoints committed at LOOP_EVERY and
    LOOP_STEPS, the resumed losses equal to (a)'s, the final state equal to
    (a)'s by check (vi)'s rule, every loss finite, the failed run's state
    released before the resumed run restores, and the attention kernels
    launched on every step. Prints the ``train_loop`` line; returns the
    launches."""
    # imported here: ``--speed`` runs this script's other phases against a
    # parent checkout that may not have the driver
    from repro_torch.launch import train as LT
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import fault as FT

    cfg, B, S, n_mb = TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB
    L = len(TT.layer_windows(cfg))
    kw = dict(smoke=False, batch=B, seq=S, microbatches=n_mb, seed=SEED, log_every=1,
              device=dev)
    monitors, io = [], {"save": [], "restore": []}

    class Monitor(FT.StragglerMonitor):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            monitors.append(self)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    saved_monitor, FT.StragglerMonitor = FT.StragglerMonitor, Monitor
    try:
        with _timing(CK, ("save", "restore"), io):
            t0 = time.perf_counter()
            want, want_losses = LT.train_loop(cfg.name, steps=LOOP_STEPS, ckpt_dir=None, **kw)
            torch.cuda.synchronize()
            t_a = time.perf_counter() - t0
            state_bytes = sum(t.numel() * t.element_size()
                              for tree in _state_trees(want) for t in OPT.tree_leaves(tree))
            tmp = tempfile.mkdtemp(prefix="train_loop-")
            try:
                free = shutil.disk_usage(tmp).free
                say(f"train_loop: checkpoints in {tmp}: {free} bytes free, a state "
                    f"{state_bytes} bytes")
                if free < LOOP_DISK_SHARE * state_bytes:
                    fail(f"train_loop: {free} bytes free in {tmp}, under {LOOP_DISK_SHARE} × "
                         f"the state's {state_bytes} (two committed checkpoints and one "
                         f"being written)")
                finals, losses, resumes, alloc = [], [], [], []

                def make_loop(resume_step):
                    resumes.append(resume_step)
                    alloc.append(torch.cuda.memory_allocated())
                    st, ls = LT.train_loop(
                        cfg.name, steps=LOOP_STEPS, ckpt_dir=tmp, ckpt_every=LOOP_EVERY,
                        fail_at_step=LOOP_FAIL_AT if (resume_step or 0) == 0 else None, **kw)
                    finals.append(st)
                    losses.append(ls)
                    return LOOP_STEPS

                t0 = time.perf_counter()
                FT.run_with_restart(make_loop, lambda: CK.latest_step(tmp), max_restarts=1,
                                    backoff_s=0.1)
                torch.cuda.synchronize()
                t_b = time.perf_counter() - t0
                committed = sorted(os.listdir(tmp))
                last = os.path.join(tmp, f"step_{LOOP_STEPS:08d}")
                ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                                 for d, _, fs in os.walk(last) for f in fs)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    finally:
        FT.StragglerMonitor = saved_monitor
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()

    got = finals[-1]
    if resumes != [None, LOOP_EVERY]:
        fail(f"train_loop: the supervisor called the loop with resume steps {resumes}, "
             f"want [None, {LOOP_EVERY}] (one restart, from step {LOOP_EVERY})")
    want_dirs = [f"step_{s:08d}" for s in (LOOP_EVERY, LOOP_STEPS)]
    if committed != want_dirs:
        fail(f"train_loop: the checkpoint directory holds {committed}, want {want_dirs}")
    everything = want_losses + [x for ls in losses for x in ls]
    if not np.isfinite(everything).all():
        fail(f"train_loop: a non-finite loss: {want_losses} {losses}")
    # the failed run's state is gone before the resumed run restores one:
    # then only (a)'s final state is allocated at both calls' start
    if alloc[1] > alloc[0] + state_bytes // 2:
        fail(f"train_loop: {alloc[1]} bytes allocated when the resumed run started, "
             f"{alloc[0]} when the first did: the failed run's state was not released")
    if got.step != LOOP_STEPS or got.opt.step != LOOP_STEPS:
        fail(f"train_loop: the resumed run ended at step {got.step} / {got.opt.step}")
    # (vi)'s rule: bit-equality unless a library op of the step is not
    # deterministic on this card, then RESTART_SHARE of the smallest lr
    nondet = _nondeterministic_ops(dev, B // n_mb, S, cfg)
    pairs = [(a, b) for ta, tb in zip(_state_trees(got), _state_trees(want))
             for a, b in zip(OPT.tree_leaves(ta), OPT.tree_leaves(tb))]
    max_diff = max(float((a - b).abs().max()) for a, b in pairs)
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    del pairs
    limit = 0.0
    if nondet:
        limit = RESTART_SHARE * min(float(OPT.schedule(OPT.AdamWConfig(), s))
                                    for s in range(1, LOOP_STEPS + 1))
    if not (bit_equal if not nondet else max_diff <= limit):
        fail(f"train_loop: the resumed run's final state differs from the uninterrupted "
             f"run's by {max_diff} (" + (f"limit {limit}: ops {nondet} are not deterministic)"
                                        if nondet else "bit-equality required)"))
    resumed = want_losses[LOOP_EVERY:]
    loss_diff = max(abs(x - y) for x, y in zip(losses[-1], resumed))
    if len(losses[-1]) != len(resumed) or (loss_diff != 0.0 if not nondet
                                           else loss_diff > TRAIN_TOL * max(resumed)):
        fail(f"train_loop: the resumed losses {losses[-1]} differ from the uninterrupted "
             f"run's {resumed}")
    steps_run = LOOP_STEPS + (LOOP_FAIL_AT + 1) + (LOOP_STEPS - LOOP_EVERY)
    want_launches = {"flash_attention": steps_run * 2 * L * n_mb,
                     "flash_attention_bwd": steps_run * L * n_mb}
    for name, n in want_launches.items():
        if launches[name] != n:
            fail(f"train_loop: {name} launched {launches[name]} times in {steps_run} steps, "
                 f"want {n}")
    del finals, got, want
    torch.cuda.empty_cache()
    host_ms = [1e3 * t for m in monitors for t in m.times]
    line = dict(
        arch=cfg.name, layers=L, d_model=cfg.d_model, batch=B, seq=S, microbatches=n_mb,
        steps=LOOP_STEPS, ckpt_every=LOOP_EVERY, fail_at_step=LOOP_FAIL_AT,
        steps_run=steps_run, uninterrupted_s=t_a, supervised_s=t_b,
        save_s=io["save"], restore_s=io["restore"], state_bytes=state_bytes,
        ckpt_bytes=ckpt_bytes, free_bytes=free, step_ms_p50_host=float(np.percentile(host_ms, 50)),
        step_ms_host=host_ms, restarts=len(resumes) - 1, resumed_from=resumes[-1],
        committed=committed, losses_uninterrupted=want_losses, losses_calls=losses,
        bit_equal=bit_equal, max_abs_diff=max_diff, loss_max_abs_diff=loss_diff,
        restart_limit=limit, nondeterministic_ops=nondet,
        straggler_flagged=[m.flagged for m in monitors],
        straggler_samples=[len(m.times) for m in monitors],
        alloc_at_loop_start=alloc, peak_alloc_bytes=peak,
        launches={k: launches[k] for k in want_launches})
    say("train_loop " + json.dumps(line))
    say(f"train_loop: {cfg.name} ({L} layers, d {cfg.d_model}), {B} × {S} tokens in "
        f"{n_mb} microbatches: {LOOP_STEPS} steps uninterrupted == {LOOP_STEPS} steps "
        f"under run_with_restart (failure after step {LOOP_FAIL_AT}, 1 restart, resumed "
        f"from step {resumes[-1]}, {committed} committed): bit-equal {bit_equal}, max |diff| "
        f"{max_diff}; saves {', '.join(f'{x:.1f}' for x in io['save'])} s, restore "
        f"{io['restore'][0]:.1f} s of {ckpt_bytes} bytes; step {line['step_ms_p50_host']:.1f} "
        f"ms p50 (host clock); peak {peak / 1e9:.1f} GB; {want_launches['flash_attention']} "
        f"flash_attention and {want_launches['flash_attention_bwd']} flash_attention_bwd "
        f"launches")
    return launches


def phase_train_mesh(dev):
    """tinyllama-1.1b's training sharded over a MESH_SHAPE mesh of the card
    through `make_train_step(mesh=...)`, with checks (i)–(iii); prints the
    ``train_mesh`` line and returns the launches of (ii)'s mesh steps."""
    # imported here: ``--speed`` runs this script's other phases against a
    # parent checkout that may not have the sharding helpers
    from repro_torch.launch import mesh as MM
    from repro_torch.sharding import array as SA
    from repro_torch.train import checkpoint as CK

    cfg, B, S, n_mb = TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB
    L = len(TT.layer_windows(cfg))
    tcfg = TS.TrainConfig(microbatches=n_mb, opt=OPT.AdamWConfig(**TRAIN_OPT))
    batch = _memorisable_batch(B, S, n_mb, dev)
    mesh = MM.make_mesh(MESH_SHAPE, MESH_AXES)
    n_rep = len(TS.replicas(cfg, mesh, batch))
    torch.cuda.empty_cache()

    # (i) at MESH_CUT layers in float32: one step and the accumulated
    # gradients against one device; the mesh step twice, bit-equal
    cfg2 = dataclasses.replace(cfg, num_layers=MESH_CUT, dtype="float32")
    sh2 = TS.state_shardings(cfg2, mesh)
    p2 = LMP.init_params(cfg2, SEED, device=dev)
    loss_1, g_1 = TS.accumulate_grads(cfg2, p2, batch)
    loss_m, g_m = TS.accumulate_grads_mesh(cfg2, SA.device_put(p2, sh2.params), batch, mesh)
    grad_err = _leaf_rel(OPT.tree_leaves(SA.gather_tree(g_m, dev)), OPT.tree_leaves(g_1))
    del p2, g_1, g_m
    _, m1 = TS.make_train_step(cfg2, tcfg)(TS.init_state(cfg2, SEED, device=dev), batch)
    runs = []
    for _ in range(2):
        st, mm = TS.make_train_step(cfg2, tcfg, mesh=mesh)(
            SA.device_put(TS.init_state(cfg2, SEED, device=dev), sh2), batch)
        runs.append((st, mm))
    (a, ma), (b, mb) = runs
    twice_equal = all(torch.equal(ma[k], mb[k]) for k in ("loss", "grad_norm")) and all(
        torch.equal(x, y) for ta, tb in zip(SA.leaves(a), SA.leaves(b))
        for x, y in zip(ta.blocks, tb.blocks))
    check_i = dict(loss_rel=abs(float(ma["loss"]) - float(m1["loss"])) / float(m1["loss"]),
                   grad_norm_rel=abs(float(ma["grad_norm"]) - float(m1["grad_norm"]))
                   / float(m1["grad_norm"]),
                   accumulated_loss_rel=abs(float(loss_m) - float(loss_1)) / float(loss_1),
                   grad_rel=grad_err, twice_bit_equal=twice_equal)
    del runs, a, b, st
    torch.cuda.empty_cache()
    if not (check_i["loss_rel"] <= MESH_LOSS_TOL and check_i["accumulated_loss_rel"]
            <= MESH_LOSS_TOL and check_i["grad_norm_rel"] <= MESH_NORM_TOL
            and grad_err <= TRAIN_TOL and twice_equal):
        fail(f"train_mesh (i): at {MESH_CUT} layers in float32 the mesh step differs from one "
             f"device's: {check_i} (limits: loss {MESH_LOSS_TOL}, norm {MESH_NORM_TOL}, "
             f"gradients {TRAIN_TOL}, two runs bit-equal)")

    # (ii) full depth in bf16: one device, freed, then the mesh
    alloc = [torch.cuda.memory_allocated()]
    state = TS.init_state(cfg, SEED, device=dev)
    state_bytes = 3 * sum(t.numel() * t.element_size() for t in OPT.tree_leaves(state.params))
    step = TS.make_train_step(cfg, tcfg)
    want = []
    for _ in range(MESH_STEPS):
        state, m = step(state, batch)
        want.append(float(m["loss"]))
    del state, step, m
    torch.cuda.empty_cache()
    alloc.append(torch.cuda.memory_allocated())
    if alloc[1] > alloc[0] + state_bytes // 2:
        fail(f"train_mesh (ii): {alloc[1]} bytes allocated after the one-device run, {alloc[0]} "
             f"before it: its state was not released")
    init = TS.init_state(cfg, SEED, device=dev)
    state = SA.device_put(init, TS.state_shardings(cfg, mesh))
    del init
    torch.cuda.empty_cache()
    step = TS.make_train_step(cfg, tcfg, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    marks, losses, norms, copies = [], [], [], []
    for _ in range(MESH_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, batch)
        e1.record()
        marks.append((e0, e1))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        copies.append(all(SA.copies_equal(t) for t in SA.leaves(state)))
    torch.cuda.synchronize()
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [x.elapsed_time(y) for x, y in marks]
    rel = [abs(x - w) / abs(w) for x, w in zip(losses, want)]
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"train_mesh (ii): a non-finite loss or gradient norm: {losses} {norms}")
    if not max(rel) <= MESH_BF16_TOL:
        fail(f"train_mesh (ii): mesh losses {losses} against one device's {want} (limit "
             f"{MESH_BF16_TOL} relative)")
    if not all(copies):
        fail(f"train_mesh (ii): replicated copies differ after steps {copies}")
    per_step = {"flash_attention": 2 * L * n_mb * n_rep, "flash_attention_bwd": L * n_mb * n_rep}
    for name, per in per_step.items():
        if launches[name] != per * MESH_STEPS:
            fail(f"train_mesh: {name} launched {launches[name]} times in {MESH_STEPS} steps, "
                 f"expected {per} a step ({L} layers × {n_mb} microbatches × {n_rep} replicas)")
    out = []
    split = _train_split(lambda: out.append(step(state, batch)), {
        "gathers": (TS, "_gather_params"), "reduction": (TS, "_reduce_grad"),
        "optimizer": (OPT, "apply_sharded")})
    state = out.pop()[0]

    # (iii) the elastic restore: onto MESH_ELASTIC and onto one device
    tmp = tempfile.mkdtemp(prefix="train_mesh-")
    try:
        free = shutil.disk_usage(tmp).free
        if free < 1.1 * state_bytes:
            fail(f"train_mesh: {free} bytes free in {tmp}, under 1.1 × the state's {state_bytes}")
        t0 = time.perf_counter()
        CK.save(tmp, state.step, state)
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp)
                         for f in fs)
        abstract, restore_s, elastic_equal = TS.abstract_state(cfg), {}, {}
        other = MM.make_mesh(*MESH_ELASTIC)
        for what, kw in (("mesh " + "x".join(map(str, MESH_ELASTIC[0])),
                          dict(shardings=TS.state_shardings(cfg, other))),
                         ("one device", dict(device=dev))):
            t0 = time.perf_counter()
            got = CK.restore(tmp, state.step, abstract, **kw)
            torch.cuda.synchronize()
            restore_s[what] = time.perf_counter() - t0
            elastic_equal[what] = all(
                x == y if isinstance(x, int) else torch.equal(
                    SA.gather(x, dev) if isinstance(x, SA.ShardedTensor) else x,
                    SA.gather(y, dev))
                for (_, x), (_, y) in zip(CK.leaf_items(got), CK.leaf_items(state)))
            del got
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not all(elastic_equal.values()):
        fail(f"train_mesh (iii): a restored state differs from the saved one: {elastic_equal}")
    del state, step
    torch.cuda.empty_cache()

    line = dict(
        arch=cfg.name, layers=L, mesh=dict(zip(MESH_AXES, MESH_SHAPE)),
        mesh_devices=[str(d) for d in mesh.devices], replicas=n_rep, batch=B, seq=S,
        microbatches=n_mb, steps=MESH_STEPS, dtype=cfg.dtype, opt=TRAIN_OPT,
        check_i=check_i, check_i_layers=MESH_CUT, losses_one_device=want, losses_mesh=losses,
        grad_norms_mesh=norms, check_ii_loss_rel=rel, copies_bit_identical=copies,
        alloc_before_after_one_device=alloc, state_bytes=state_bytes,
        step_ms=step_ms, step_ms_p50=float(np.percentile(step_ms, 50)),
        tokens_s=B * S / (float(np.percentile(step_ms, 50)) / 1e3), peak_alloc_bytes=peak,
        launches={k: launches[k] for k in per_step}, launches_per_step=per_step,
        step_profile_ms=split, save_s=save_s, restore_s=restore_s, ckpt_bytes=ckpt_bytes,
        free_bytes=free, elastic_bit_equal=elastic_equal)
    say("train_mesh " + json.dumps(line))
    say(f"train_mesh: {cfg.name} ({L} layers, d {cfg.d_model}) on a "
        f"{' × '.join(map(str, MESH_SHAPE))} {MESH_AXES} mesh of one card ({n_rep} replicas): "
        f"(i) at {MESH_CUT} layers in float32 == one device (loss {check_i['loss_rel']:.3g}, "
        f"norm {check_i['grad_norm_rel']:.3g}, gradients {grad_err:.3g}), two runs bit-equal; "
        f"(ii) {MESH_STEPS} bf16 steps within {max(rel):.3g} of one device's losses, copies "
        f"bit-identical; step {line['step_ms_p50']:.1f} ms p50 ({line['tokens_s']:.0f} "
        f"tokens/s), peak {peak / 1e9:.1f} GB; {per_step['flash_attention']} flash_attention and "
        f"{per_step['flash_attention_bwd']} flash_attention_bwd launches a step; (iii) saved in "
        f"{save_s:.1f} s ({ckpt_bytes} bytes), restored bit-equal: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in restore_s.items()))
    return launches


def _sharded_state(cfg, mesh, dev):
    """``TS.init_state(cfg, SEED, dev)`` sharded by `state_shardings`, a
    part at a time: the parameters drawn on ``dev``, sharded, then freed,
    and the moments as sharded zeros, so the card never holds the whole
    state twice, as `device_put` of a whole state would."""
    from repro_torch.sharding import array as SA
    params = LMP.init_params(cfg, SEED, device=dev)
    sp = SA.device_put(params, TS.state_shardings(cfg, mesh).params)
    del params
    zeros = lambda: _tree(sp, lambda st: SA.zeros(st.shape, torch.float32, st.sharding))
    return TS.TrainState(params=sp, opt=OPT.AdamWState(mu=zeros(), nu=zeros(), step=0), step=0)


def _replica_losses(cfg, params, batch, reps, routed: bool = True):
    """Without gradients, each microbatch's `replicas` through
    `transformer.loss_sums` on ``params`` (whole, on one device) → (the
    mean over microbatches of the replicas' NLL sum over the label count;
    the slots each MoE layer dropped, per microbatch, from its routing
    record). ``routed=False``: each replica on its own, its own capacity
    and no offsets (a naive data-parallel split), and no drops."""
    n_mb = batch["tokens"].shape[0]
    loss, drops = 0.0, []
    with torch.no_grad():
        for i in range(n_mb):
            routing = TT.Routing(batch["tokens"][i].numel()) if routed else None
            nll = sum(float(TT.loss_sums(params, cfg, {k: v[i, rows] for k, v in batch.items()},
                                         routing=routing)[0]) for _, rows in reps)
            loss += nll / float((batch["labels"][i] >= 0).sum()) / n_mb
            if routed:
                drops.append([int(d) for d in routing.dropped(cfg.experts_per_token,
                                                              cfg.num_experts)])
    return loss, drops


def phase_train_mesh_moe(dev):
    """grok-1's MoE layers trained on a MESH_SHAPE mesh of the card through
    `make_train_step(mesh=...)`, with checks (i)–(ii); prints the
    ``train_mesh_moe`` line and returns the launches of (ii)'s mesh
    steps."""
    from repro_torch.launch import mesh as MM
    from repro_torch.models import layers as LY
    from repro_torch.sharding import array as SA

    cfg, B, S, n_mb = MOE_TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB
    L, E, K = cfg.num_layers, cfg.num_experts, cfg.experts_per_token
    tcfg = TS.TrainConfig(microbatches=n_mb, opt=OPT.AdamWConfig(**TRAIN_OPT))
    batch = _memorisable_batch(B, S, n_mb, dev)
    mesh = MM.make_mesh(MESH_SHAPE, MESH_AXES)
    reps = TS.replicas(cfg, mesh, batch)
    n_rep = len(reps)
    C, C_naive = LY.capacity(B // n_mb * S, E, K), LY.capacity(B // n_mb // n_rep * S, E, K)
    torch.cuda.empty_cache()

    # (i) at d_ff MOE_CHECK_DFF in float32: the accumulated gradients and
    # one step against one device's; the mesh step twice, bit-equal; slots
    # dropped; the naive split misses
    cfg2 = dataclasses.replace(cfg, d_ff=MOE_CHECK_DFF, dtype="float32")
    p2 = LMP.init_params(cfg2, SEED, device=dev)
    loss_1, g_1 = TS.accumulate_grads(cfg2, p2, batch)
    naive_loss, _ = _replica_losses(cfg2, p2, batch, reps, routed=False)
    routed_loss, drops_i = _replica_losses(cfg2, p2, batch, reps)
    sp2 = SA.device_put(p2, TS.state_shardings(cfg2, mesh).params)
    del p2
    loss_m, g_m = TS.accumulate_grads_mesh(cfg2, sp2, batch, mesh)
    del sp2
    grad_err = _leaf_rel(OPT.tree_leaves(SA.gather_tree(g_m, dev)), OPT.tree_leaves(g_1))
    del g_1, g_m
    torch.cuda.empty_cache()
    m1 = TS.make_train_step(cfg2, tcfg)(TS.init_state(cfg2, SEED, device=dev), batch)[1]
    torch.cuda.empty_cache()
    runs = []
    for _ in range(2):
        st, mm = TS.make_train_step(cfg2, tcfg, mesh=mesh)(_sharded_state(cfg2, mesh, dev), batch)
        runs.append(([b for t in SA.leaves(st.params) for b in t.blocks], mm))
        del st
        torch.cuda.empty_cache()
    (pa, ma), (pb, mb) = runs
    twice_equal = all(torch.equal(ma[k], mb[k]) for k in ("loss", "grad_norm")) and all(
        torch.equal(x, y) for x, y in zip(pa, pb))
    one = float(loss_1)
    check_i = dict(loss_rel=abs(float(ma["loss"]) - float(m1["loss"])) / float(m1["loss"]),
                   grad_norm_rel=abs(float(ma["grad_norm"]) - float(m1["grad_norm"]))
                   / float(m1["grad_norm"]),
                   accumulated_loss_rel=abs(float(loss_m) - one) / one, grad_rel=grad_err,
                   twice_bit_equal=twice_equal, dropped=drops_i,
                   routed_loss_rel=abs(routed_loss - one) / one,
                   naive_split_loss_rel=abs(naive_loss - one) / one)
    del runs, pa, pb
    torch.cuda.empty_cache()
    if not (check_i["loss_rel"] <= MESH_LOSS_TOL and check_i["accumulated_loss_rel"]
            <= MESH_LOSS_TOL and check_i["grad_norm_rel"] <= MESH_NORM_TOL
            and grad_err <= TRAIN_TOL and twice_equal):
        fail(f"train_mesh_moe (i): at d_ff {MOE_CHECK_DFF} in float32 the mesh step differs "
             f"from one device's: {check_i} (limits: loss {MESH_LOSS_TOL}, norm "
             f"{MESH_NORM_TOL}, gradients {TRAIN_TOL}, two runs bit-equal)")
    if not sum(map(sum, drops_i)) > 0:
        fail(f"train_mesh_moe (i): no slot dropped ({drops_i} by microbatch and layer, C {C})")
    if not check_i["naive_split_loss_rel"] > 10 * MESH_LOSS_TOL:
        fail(f"train_mesh_moe (i): a naive split (each replica its own C = {C_naive}) is "
             f"within {check_i['naive_split_loss_rel']} of one device's loss, not past "
             f"{10 * MESH_LOSS_TOL}: the check has no teeth")

    # (ii) the phase's cut in bf16: one device, freed, then the mesh
    alloc = [torch.cuda.memory_allocated()]
    state = TS.init_state(cfg, SEED, device=dev)
    n_params = sum(t.numel() for t in OPT.tree_leaves(state.params))
    state_bytes = 3 * 4 * n_params
    cp = _tree(state.params, lambda t: t.to(torch.bfloat16))
    with torch.no_grad():
        one_slots = [_moe_slots(lambda i=i: TT.loss_sums(cp, cfg, {k: v[i] for k, v in
                                                                   batch.items()}))
                     for i in range(n_mb)]
    del cp
    step = TS.make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, want = [], []
    for _ in range(MESH_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, batch)
        e1.record()
        marks.append((e0, e1))
        want.append(float(m["loss"]))
    torch.cuda.synchronize()
    one_ms = [x.elapsed_time(y) for x, y in marks]
    one_peak = torch.cuda.max_memory_allocated()
    del state, step, m
    torch.cuda.empty_cache()
    alloc.append(torch.cuda.memory_allocated())
    if alloc[1] > alloc[0] + state_bytes // 2:
        fail(f"train_mesh_moe (ii): {alloc[1]} bytes allocated after the one-device run, "
             f"{alloc[0]} before it: its state was not released")
    state = _sharded_state(cfg, mesh, dev)
    # the mesh's drops at step 1's parameters, each microbatch's replicas
    # through one routing record
    cp = TS._gather_params(list(OPT.tree_items(state.params)), dev, torch.bfloat16)
    _, mesh_drops = _replica_losses(cfg, cp, batch, reps)
    del cp
    torch.cuda.empty_cache()
    step = TS.make_train_step(cfg, tcfg, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    marks, losses, norms, copies = [], [], [], []
    for _ in range(MESH_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, batch)
        e1.record()
        marks.append((e0, e1))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        copies.append(all(SA.copies_equal(t) for t in SA.leaves(state)))
    torch.cuda.synchronize()
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [x.elapsed_time(y) for x, y in marks]
    rel = [abs(x - w) / abs(w) for x, w in zip(losses, want)]
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"train_mesh_moe (ii): a non-finite loss or gradient norm: {losses} {norms}")
    if not max(rel) <= MESH_BF16_TOL:
        fail(f"train_mesh_moe (ii): mesh losses {losses} against one device's {want} (limit "
             f"{MESH_BF16_TOL} relative)")
    if not all(copies):
        fail(f"train_mesh_moe (ii): replicated copies differ after steps {copies}")
    per_step = {"flash_attention": 2 * L * n_mb * n_rep, "flash_attention_bwd": L * n_mb * n_rep}
    for name, per in per_step.items():
        if launches[name] != per * MESH_STEPS:
            fail(f"train_mesh_moe: {name} launched {launches[name]} times in {MESH_STEPS} "
                 f"steps, expected {per} a step ({L} layers × {n_mb} microbatches × {n_rep} "
                 f"replicas)")
    out = []
    split = _train_split(lambda: out.append(step(state, batch)), {
        "gathers": (TS, "_gather_params"), "reduction": (TS, "_reduce_grad"),
        "optimizer": (OPT, "apply_sharded"), "moe": (LY, "moe"), "experts": (LY, "_experts")})
    del out, state, step
    torch.cuda.empty_cache()
    # MoE dispatch and combine, forward and recomputation: the router's
    # softmax and sort, the slot table, the gathers, gate scale and sum
    # (their backward stays in the rest); _experts' elementwise kernels
    # belong to the rest (its products, and the router's, are products)
    split["moe_dispatch_combine"] = split.pop("moe")
    split["rest"] += split.pop("experts")

    one_drops = [[d for _, d, _ in calls] for calls in one_slots]
    p50, one_p50 = float(np.percentile(step_ms, 50)), float(np.percentile(one_ms, 50))
    line = dict(
        arch=cfg.name, layers=L, d_model=cfg.d_model, d_ff=cfg.d_ff,
        heads=[cfg.num_heads, cfg.num_kv_heads], experts=E, top_k=K, vocab=cfg.vocab_size,
        params=n_params, state_bytes=state_bytes, mesh=dict(zip(MESH_AXES, MESH_SHAPE)),
        replicas=n_rep, batch=B, seq=S, microbatches=n_mb, steps=MESH_STEPS, dtype=cfg.dtype,
        opt=TRAIN_OPT, capacity=C, naive_capacity=C_naive, check_i=check_i,
        check_i_d_ff=MOE_CHECK_DFF, losses_one_device=want, losses_mesh=losses,
        grad_norms_mesh=norms, check_ii_loss_rel=rel, copies_bit_identical=copies,
        alloc_before_after_one_device=alloc,
        step_ms_one_device=one_ms, step_ms_p50_one_device=one_p50,
        tokens_s_one_device=B * S / (one_p50 / 1e3), peak_alloc_bytes_one_device=one_peak,
        step_ms=step_ms, step_ms_p50=p50, tokens_s=B * S / (p50 / 1e3), peak_alloc_bytes=peak,
        slots_per_layer=[n for n, _, _ in one_slots[0]],
        capacities_one_device=sorted({c for calls in one_slots for _, _, c in calls}),
        dropped_one_device=one_drops, dropped_mesh=mesh_drops,
        dropped_equal=one_drops == mesh_drops,
        launches={k: launches[k] for k in per_step}, launches_per_step=per_step,
        step_profile_ms=split)
    say("train_mesh_moe " + json.dumps(line))
    say(f"train_mesh_moe: {cfg.name} ({L} layers, d {cfg.d_model}, {E} experts top-{K}, d_ff "
        f"{cfg.d_ff}, {n_params} parameters) on a {' × '.join(map(str, MESH_SHAPE))} "
        f"{MESH_AXES} mesh of one card ({n_rep} replicas, C {C} against a naive split's "
        f"{C_naive}): (i) at d_ff {MOE_CHECK_DFF} in float32 == one device (loss "
        f"{check_i['loss_rel']:.3g}, norm {check_i['grad_norm_rel']:.3g}, gradients "
        f"{grad_err:.3g}), two runs bit-equal, {sum(map(sum, drops_i))} slots dropped, the "
        f"naive split {check_i['naive_split_loss_rel']:.3g} off; (ii) {MESH_STEPS} bf16 steps "
        f"within {max(rel):.3g} of one device's losses, copies bit-identical; step "
        f"{p50:.1f} ms p50 ({line['tokens_s']:.0f} tokens/s) against one device's "
        f"{one_p50:.1f}, peak {peak / 1e9:.1f} GB (one device {one_peak / 1e9:.1f}); dropped "
        f"by microbatch and layer {mesh_drops} (one device {one_drops}); "
        f"{per_step['flash_attention']} flash_attention and "
        f"{per_step['flash_attention_bwd']} flash_attention_bwd launches a step")
    return launches


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def speed(parent: str) -> None:
    """``--speed DIR``: the kernel-speed comparison of this tree against
    another checkout ``DIR`` (e.g. ``git archive <commit> | tar -x -C
    _checkout/parent``) in one call on one card. This script is copied
    beside ``DIR/src`` and run there and here with ``--speed-side``, in the
    order parent, change, change, parent; each side's output goes to
    ``speed<i>_<side>.log`` beside ``DIR`` and its numbers to a ``speed``
    JSON line here: the sketch join, attention, rank_moments, rank_transform,
    Qn, containment and postings rows, and the `off` dispatch (also by
    estimator), the scan-source `safe`/`topm` dispatch, live-index call,
    library, scheduler and LM decode times."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    if not os.path.isdir(os.path.join(parent, "src", "repro_torch")):
        fail(f"--speed: {parent} holds no src/repro_torch")
    shutil.copy(os.path.abspath(__file__), os.path.join(parent, "chip_smoke.py"))
    logs = os.path.dirname(parent)
    say(_card())
    for i, (side, root) in enumerate((("parent", parent), ("change", here),
                                      ("change", here), ("parent", parent)), 1):
        log = os.path.join(logs, f"speed{i}_{side}.log")
        t0 = time.perf_counter()
        with open(log, "w") as fh:
            rc = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py"),
                                 "--speed-side"], cwd=root, stdout=fh,
                                stderr=subprocess.STDOUT, timeout=900).returncode
        lines = {}
        with open(log) as fh:
            for ln in fh:
                head, _, body = ln.partition(" ")
                if head in ("SPEED", "two_stage", "lifecycle", "library", "scheduler", "lm"):
                    lines[head] = json.loads(body)
        if rc or len(lines) < 6:
            fail(f"--speed side {i} ({side}) exited {rc}; see {log}")
        ts, lc, sc, lm = (lines[k] for k in ("two_stage", "lifecycle", "scheduler", "lm"))
        say(f"speed {i} {side} " + json.dumps(dict(
            seconds=time.perf_counter() - t0, kernels=lines["SPEED"],
            off_dispatch_ms=[ts["dispatch_p50_ms"]["off"], ts["dispatch_p99_ms"]["off"]],
            off_dispatch_ms_by_estimator={e: [v["p50"], v["p99"]] for e, v in
                                          ts["off_dispatch_ms_by_estimator"].items()},
            scan_source_dispatch_ms={m: [ts["dispatch_p50_ms"][m], ts["dispatch_p99_ms"][m]]
                                     for m in ("safe(scan)", "topm(scan)")},
            live_call_ms={k: [lc[f"call_p50_ms_{k}"], lc[f"call_p99_ms_{k}"]]
                          for k in ("8_segments", "1_segment")},
            library_ms_per_query=lines["library"]["ms_per_query_by_estimator"],
            scheduler={k: [sc[k]["goodput_qps"], sc[k]["latency_p50_ms"], sc[k]["latency_p99_ms"]]
                       for k in ("load", "load_workers1")},
            decode_ms=[lm["decode_ms_p50"], lm["decode_ms_p99"]],
            decode_profile_ms=lm["decode_profile_ms"], prefill_s=lm["prefill_s"])))
    say(_card())


def _ptxas(name: str):
    """(entry function, line) of each registers / spill line of the
    compiler's report on source ``name``."""
    entry, out = "?", []
    for ln in build.build_log(name).splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "registers" in ln or "spill" in ln:
            out.append((entry, ln.strip()))
    return out


def _sass_counts(name: str, kernels, ops):
    """{function: {op: count}} over the functions of library ``name`` whose
    mangled name holds one of ``kernels``: how many SASS lines of each
    holds each of ``ops`` (``cuobjdump -sass`` of the built library)."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300)
    if dump.returncode:
        fail(f"cuobjdump -sass {name}: {dump.stderr.strip()}")
    out, cur = {}, None
    for ln in dump.stdout.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            hit = [k for k in kernels if k in fn]
            dim = fn.split("ILi", 1)[1].split("E", 1)[0] if "ILi" in fn else "?"
            cur = out.setdefault(f"{hit[0]}<{dim}>", dict.fromkeys(ops, 0)) if hit else None
        elif cur is not None:
            for op in ops:
                cur[op] += op in ln
    return out


def _card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main(argv) -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if argv[:1] == ["--speed"] and len(argv) == 2:
        return speed(argv[1])
    side = argv == ["--speed-side"]
    if argv and not side:
        fail(f"usage: chip_smoke.py [--speed DIR], not {argv}")
    dev = torch.device("cuda")
    card = _card()
    say(f"device: {torch.cuda.get_device_name(0)} ({card}); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    ops.load_kernels(dev)
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for name in build.SOURCES:
        for entry, ln in _ptxas(name):
            say(f"  {name} {entry}: {ln}")

    t0 = time.perf_counter()
    groups = corpus()
    keys, vals, best = planted(groups)
    say(f"corpus: {GROUPS} tables × {COLS} columns × {ROWS} rows in "
        f"{time.perf_counter() - t0:.1f} s")
    phases = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        return out

    index = timed("index", phase_index, groups, dev)
    srv = SV.Server(index, buckets=(BUCKET,))
    buckets = {bw: kernel_inputs(groups, srv.chunk_for(bw), bw)
               for bw in (BUCKET,) + JOIN_BUCKETS}
    if side:
        # one side of --speed: the redesigned kernels, the paths they serve
        # and the host-bound phases whose numbers vary most between calls
        rows = phase_kernels(index, buckets, keys, vals, dev)
        rows.update(phase_rank_transform(index, keys, vals, dev))
        rows.update(phase_stage1_kernels(index, keys, vals, dev))
        rows.update(phase_flash(dev))
        rows.update(phase_attention_bwd(dev))
        phase_two_stage(index, keys, vals, dev)
        phase_lifecycle(groups, index, keys, vals, dev)
        phase_library(index, keys, vals, best, dev)
        phase_scheduler(index, groups, keys, vals, dev)
        phase_lm(dev)
        say("SPEED " + json.dumps({
            k: dict({f: v for f, v in r.items() if f != "work"},
                    bound_ms=bound_ms(*r["work"])[0])
            for k, r in rows.items()
            if k.startswith(("sketch_join", "flash", "rank_", "containment", "qn",
                             "postings"))}))
        return
    rows = timed("hash_build", phase_hash_build, groups, dev)
    rows.update(timed("kernels", phase_kernels, index, buckets, keys, vals, dev))
    rows.update(timed("rank_transform", phase_rank_transform, index, keys, vals, dev))
    # before the slice phase: after its long profiles, the postings rows'
    # sessions (the most records, memsets included) have come back incomplete
    rows.update(timed("stage1_kernels", phase_stage1_kernels, index, keys, vals, dev))
    launches = timed("slice", phase_slice, index, keys, vals, best, dev)
    launches.update({k: v for k, v in timed("two_stage", phase_two_stage, index,
                                            keys, vals, dev).items()
                     if k in STAGE1_KERNELS})
    launches["hash_build"] = timed("lifecycle", phase_lifecycle, groups, index,
                                   keys, vals, dev)["hash_build"]
    launches["rank_transform"] = timed("library", phase_library, index, keys, vals,
                                       best, dev)["rank_transform"]
    timed("scheduler", phase_scheduler, index, groups, keys, vals, dev)
    # the sharded path's launches join each query kernel's and hash_build's
    for k, v in timed("sharded", phase_sharded, index, groups, dev).items():
        launches[k] = launches.get(k, 0) + v
    # so do the legacy API's and the augmentation example's (its training
    # half's attention launches start the two attention kernels' counts)
    for k, v in timed("legacy", phase_legacy, index, groups, keys, vals, best,
                      dev).items():
        launches[k] = launches.get(k, 0) + v
    rows.update(timed("flash_attention", phase_flash, dev))
    # flash_attention's launches: the six LM paths' join the example's
    launches["flash_attention"] += sum(
        timed(name, fn, dev)["flash_attention"]
        for name, fn in (("lm", phase_lm), ("lm_hybrid", phase_lm_hybrid),
                         ("lm_encdec", phase_lm_encdec), ("lm_moe", phase_lm_moe),
                         ("lm_moe_pair", phase_lm_moe_pair), ("lm_rwkv", phase_lm_rwkv)))
    rows.update(timed("attention_bwd", phase_attention_bwd, dev))
    # every head dim's bf16 kernels on the tensor cores, fed by cp.async
    sass = rows["flash_attention_bwd"]["sass"]
    if len(sass) != len(BWD_TC_KERNELS) * len(FA.HEAD_DIMS) or not all(
            all(c.values()) for c in sass.values()):
        fail(f"flash_attention_bwd: the bf16 kernels' SASS lacks {BWD_SASS_OPS}: {sass}")
    # the training paths' launches: their forward's join the LM paths'
    for name, fn in (("train", phase_train), ("train_loop", phase_train_loop),
                     ("train_mesh", phase_train_mesh), ("train_mesh_moe", phase_train_mesh_moe)):
        for k, v in timed(name, fn, dev).items():
            if k in LM_TRAIN_KERNELS:
                launches[k] += v
    say("phases " + json.dumps(phases))

    kernels = []
    for name, row in rows.items():
        b, by = bound_ms(*row.pop("work"))
        row.setdefault("library_ms", None)
        kernels.append(dict(name=name, route="cuda", launches=launches[row.pop("kernel", name)],
                            bound_ms=b, bound_by=by, **row))
    say(card)
    say(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
