#!/usr/bin/env python3
"""Where a launch of the port's sketch-join, split-key attention and
rank_moments kernels spends its time, phase by phase, on one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 tools/kernel_phases.py``. It copies ``csrc/sketch_join.cu``,
``csrc/flash_attention.cu`` and ``csrc/rank_transform.cu``, puts a
``%globaltimer`` stamp (thread 0 of each block, or of each row's team in
rank_moments; 32 ns ticks) at fixed anchor lines of each kernel, builds the
copies with the port's nvcc flags into ``src/repro_torch/_build/phases/``
and launches them through ctypes at the main path's shapes:

  sketch_join_moments  B = 32 queries × C = 128 candidates (the scan's
                       bucket), again with every warp reading query row 0
                       (the query rows' L2 traffic gone), and B = 8 and 1
                       × 512 candidates; n = nq = 256, aligned/hit written
  flash_fwd_split      q [4, 32, 1, 64] f32 over a [4, 4, 2048, 64] bf16
                       cache (the LM path's decode)
  rank_moments         4096 rows of n = 256 (the scan's bucket), a quarter
                       of them joined in runs of 32 with m in [64, 256],
                       spearman; the phases after the mask are the joined
                       rows' only

For each it prints one ``phases <kernel> {json}`` line: per phase the median
and largest time over the blocks and the blocks that reached it (µs), the
launch's span from the first block's start to the last stamp, and the
uninstrumented library's time per launch by CUDA events. An anchor that is
missing from a source fails the script, so it tracks the kernels as they
change. The stamps cost a few instructions a block; compare the span
with the events time, which is taken without them.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

OUT = build.BUILD_DIR / "phases"
STAMP = r'''
__device__ unsigned long long* g_ts;
__device__ __forceinline__ void stamp(int k) {
  if (g_ts != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const size_t blk = blockIdx.x + (size_t)gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
    g_ts[blk * 8 + k] = t;
  }
}
__device__ __forceinline__ void stamp_at(size_t slot, int k) {
  if (g_ts != nullptr) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_ts[slot * 8 + k] = t;
  }
}
'''
SET_TS = '\nextern "C" int set_ts(void* p) { return (int)cudaMemcpyToSymbol(g_ts, &p, sizeof(p)); }\n'

#: (anchor, what replaces it, name of the phase that ends at its stamp);
#: stamp 0 is the block's start
JOIN = [
    ("  const size_t qbase = static_cast<size_t>(b) * nq;\n",
     "#ifdef Q0\n  const size_t qbase = 0;\n#else\n  const size_t qbase = static_cast<size_t>(b) * nq;\n"
     "#endif\n  stamp(0);\n", None),
    ("      __syncthreads();\n    }\n", "      __syncthreads();\n      stamp(1);\n    }\n", "table init"),
    ("  __syncthreads();\n\n  if (b >= B) return;\n", "  __syncthreads();\n\n  if (b >= B) return;\n  stamp(2);\n",
     "candidate loads + build"),
    ("      lookup4(tab, svals, bmask, cur.k, cur.m, al, h);\n",
     "      lookup4(tab, svals, bmask, cur.k, cur.m, al, h);\n      stamp(i < 128 ? 3 : 5);\n",
     "first 128 slots' lookups"),
    ("      cur = next;\n", "      stamp(i < 128 ? 4 : 6);\n      cur = next;\n", "their stores"),
    (None, None, "next 128 slots' lookups"),
    (None, None, "their stores"),
    ("    for (int k = 0; k < 6; ++k) out[k] = s[k];\n  }\n",
     "    for (int k = 0; k < 6; ++k) out[k] = s[k];\n  }\n  stamp(7);\n", "moment sums + store"),
]
SPLIT = [
    ("  const int kend = min(Lk, kbeg + split_keys);\n",
     "  const int kend = min(Lk, kbeg + split_keys);\n  stamp(0);\n", None),
    ("    tile.store(Ks, Vs, kb, vb, sk.l, sv.l, k0, kend, vec);\n    __syncthreads();\n",
     "    tile.store(Ks, Vs, kb, vb, sk.l, sv.l, k0, kend, vec);\n    __syncthreads();\n"
     "    if (k0 == kbeg) stamp(1);\n", "Q, K and V loads"),
    ("    const int kp = k0 + c;\n", "    if (k0 == kbeg) stamp(2);\n    const int kp = k0 + c;\n", "logits"),
    ("    // P of this thread's logits rows, against the new running maxima\n",
     "    if (k0 == kbeg) stamp(3);\n", "row maxima + barrier"),
    ("    __syncthreads();  // P is written; the old running maxima are read\n",
     "    __syncthreads();\n    if (k0 == kbeg) stamp(4);\n", "P + barrier"),
    ("  __syncthreads();  // the running maxima are final\n",
     "  __syncthreads();\n  stamp(5);\n", "P·V + barrier"),
    ("  if (!last_block) return;\n", "  stamp(6);\n  if (!last_block) return;\n",
     "partial store, fence, done-counter"),
    ("  if (tid == 0) done[bh] = 0;  // ready for the next launch on the stream\n",
     "  if (tid == 0) done[bh] = 0;\n  stamp(7);\n", "combine (last blocks)"),
]

#: rank_moments: stamps by thread 0 of each row's team (slot: 4 a block)
_TEAM = "  if (threadIdx.x % (64 * K) == 0) stamp_at(blockIdx.x * 4 + threadIdx.x / (64 * K), {});\n"
RANK = [
    ("  uint32_t* bits = reinterpret_cast<uint32_t*>(rm_smem) + team * rm_row_words(n, K);\n",
     _TEAM.format(0) + "  uint32_t* bits = reinterpret_cast<uint32_t*>(rm_smem) + team * rm_row_words(n, K);\n",
     None),
    ("  m = __reduce_add_sync(kFull, m);\n", "  m = __reduce_add_sync(kFull, m);\n" + _TEAM.format(1),
     "mask + barrier"),
    ("  int t2[E];\n  group_ranks<K>(", _TEAM.format(2) + "  int t2[E];\n  group_ranks<K>(",
     "a/b loads + keys"),
    ("  group_sort<K>(x, xs, i0, lane, bar);  // ends past the group's last read of xs\n",
     "  group_sort<K>(x, xs, i0, lane, bar);\n" + _TEAM.format(3), "sort"),
    ("#pragma unroll\n  for (int s = 0; s < E; ++s) {\n    xs[i0 + s] = x[s];\n",
     _TEAM.format(4) + "#pragma unroll\n  for (int s = 0; s < E; ++s) {\n    xs[i0 + s] = x[s];\n",
     "runs (flags + scans)"),
    ("  for (int s = 0; s < E; ++s) t2[s] = key[s] == kNoValue ? 1 : rr[pos[s]];\n",
     "  for (int s = 0; s < E; ++s) t2[s] = key[s] == kNoValue ? 1 : rr[pos[s]];\n" + _TEAM.format(5),
     "sorted keys out + lower_bound"),
    ("  named_sync(row_bar, 2 * T);\n  if (half == 1) return;\n",
     "  named_sync(row_bar, 2 * T);\n" + _TEAM.format(6) + "  if (half == 1) return;\n",
     "2r handoff + row barrier"),
    ("  if (wi == 0 && lane == 0) o[0] = static_cast<float>(m);\n}\n",
     "  if (wi == 0 && lane == 0) o[0] = static_cast<float>(m);\n" + _TEAM.format(7) + "}\n",
     "moment sums + store"),
]


def instrument(name: str, table, tag: str = "", defines=()):
    """Start nvcc on a stamped copy of csrc/<name>.cu; (process, library path)."""
    s = (build.CSRC / f"{name}.cu").read_text()
    s = s.replace("namespace {", STAMP + "\nnamespace {", 1)
    for anchor, text, _ in table:
        if anchor is None:
            continue
        if s.count(anchor) != 1:
            raise SystemExit(f"kernel_phases: anchor not found once in {name}.cu: {anchor!r}")
        s = s.replace(anchor, text)
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}{tag}.cu", OUT / f"lib{name}{tag}.so"
    src.write_text(s + SET_TS)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmd = [build._nvcc(), *flags, "-I", str(build.CSRC), *defines, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd), lib


def phases(lib, launch, blocks: int, table) -> dict:
    """One stamped launch (after a warm one): per phase [median, max, blocks] µs."""
    ts = torch.zeros(blocks * 8, dtype=torch.int64, device="cuda")
    if lib.set_ts(ctypes.c_void_p(ts.data_ptr())):
        raise SystemExit("kernel_phases: set_ts failed")
    launch()
    ts.zero_()
    launch()
    torch.cuda.synchronize()
    lib.set_ts(ctypes.c_void_p(0))
    t = ts.view(blocks, 8).cpu().numpy()
    t0 = t[:, 0].min()
    out = {"span_us": float(t.max() - t0) / 1e3}
    prev = t[:, 0].copy()
    for k in range(1, 8):
        ok = t[:, k] > 0
        if ok.any():
            d = (t[ok, k] - prev[ok]) / 1e3
            out[table[k][2]] = [float(np.median(d)), float(d.max()), int(ok.sum())]
            prev[ok] = t[ok, k]
    return out


def event_ms(launch, reps: int = 100) -> float:
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        launch()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    builds = {"": instrument("sketch_join", JOIN), "q0": instrument("sketch_join", JOIN, "_q0", ("-DQ0",)),
              "split": instrument("flash_attention", SPLIT),
              "rank": instrument("rank_transform", RANK)}
    if any(p.wait() for p, _ in builds.values()):
        raise SystemExit("kernel_phases: nvcc failed")
    libs = {k: ctypes.CDLL(str(lib)) for k, (_, lib) in builds.items()}
    P, I = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    for tag, B, C in (("", 32, 128), ("q0", 32, 128), ("", 8, 512), ("", 1, 512)):
        f = libs[tag].sketch_join_moments_launch
        f.argtypes, f.restype = [P] * 6 + [I] * 4 + [P] * 4, I
        n = nq = 256
        qk = torch.randint(0, 1 << 30, (B, nq), device=dev, dtype=torch.int32, generator=g)
        ck = torch.randint(0, 1 << 30, (C, n), device=dev, dtype=torch.int32, generator=g)
        ck[:, : n // 4] = qk[0, : n // 4]   # a quarter of each candidate joins query 0
        qv, cv = torch.randn(B, nq, device=dev), torch.randn(C, n, device=dev)
        qm = torch.ones(B, nq, device=dev)
        cm = (torch.rand(C, n, device=dev, generator=g) < 0.9).float()
        mom = torch.empty(B, C, 6, device=dev)
        al, hit = torch.empty(B, C, nq, device=dev), torch.empty(B, C, nq, device=dev)
        launch = lambda: f(qk.data_ptr(), qv.data_ptr(), qm.data_ptr(), ck.data_ptr(),
                           cv.data_ptr(), cm.data_ptr(), B, nq, C, n, mom.data_ptr(),
                           al.data_ptr(), hit.data_ptr(), stream())
        row = phases(libs[tag], launch, C * -(-B // 8), JOIN)
        row.update(B=B, C=C, n=n, query_rows="row 0 for every warp" if tag else "own",
                   events_ms=event_ms(launch))
        print("phases sketch_join_moments " + json.dumps(row), flush=True)

    f = libs["split"].flash_attention_launch
    f.argtypes, f.restype = [P] * 5 + [I] * 13 + [P] * 3, I
    B, Hq, Hkv, D, L = 4, 32, 4, 64, 2048
    q = torch.randn(B, Hq, 1, D, device=dev, generator=g)
    k = torch.randn(B, Hkv, L, D, device=dev, generator=g).bfloat16()
    v = torch.randn(B, Hkv, L, D, device=dev, generator=g).bfloat16()
    o = torch.empty(B, 1, Hq, D, device=dev).transpose(1, 2)
    splits, per, key0 = FA.split_plan(B, Hkv, 1, L, 0,
                                      torch.cuda.get_device_properties(dev).multi_processor_count)
    rows = Hq // Hkv
    ws = torch.zeros(64 + B * Hkv * splits * rows * (D + 2), device=dev)
    st = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    launch = lambda: f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ctypes.addressof(st),
                       B, Hq, Hkv, 1, L, D, 0, 0, 0, 1, splits, per, key0, ws.data_ptr(),
                       ws.data_ptr() + 256, stream())
    row = phases(libs["split"], launch, B * Hkv * splits, SPLIT)
    row.update(q=list(q.shape), cache=list(k.shape), splits=splits, split_keys=per,
               events_ms=event_ms(launch))
    print("phases flash_fwd_split " + json.dumps(row), flush=True)

    f = libs["rank"].rank_moments_launch
    f.argtypes, f.restype = [P, P, P, I, I, I, P, P, P], I
    R, n = 4096, 256
    a = torch.randn(R, n, device=dev, generator=g)
    b = 0.6 * a + torch.randn(R, n, device=dev, generator=g)
    m = torch.randint(64, n + 1, (R, 1), device=dev, generator=g)
    w = (torch.rand(R, n, device=dev, generator=g).argsort(-1) < m).float()
    w[(torch.arange(R, device=dev) // 32) % 4 != 0] = 0.0
    out = torch.empty(R, 6, device=dev)
    launch = lambda: f(a.data_ptr(), b.data_ptr(), w.data_ptr(), R, n, 0, None, out.data_ptr(),
                       stream())
    row = phases(libs["rank"], launch, R, RANK)
    row.update(rows=R, n=n, joined_rows=int((w.sum(-1) > 0).sum()), events_ms=event_ms(launch))
    print("phases rank_moments " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
