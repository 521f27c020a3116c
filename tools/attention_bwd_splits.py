#!/usr/bin/env python3
"""The attention backward's group split at tinyllama's training launch on
one CUDA card: q [2, 32, 2048, 64] bf16, k/v [2, 4, 2048, 64], causal.
Under the causal mask ``flash_bwd_dkdv_tc``'s first key tile walks all 32
query tiles of each of the group's 8 query heads and its last key tile one,
so the wrapper cuts the group among ``dkdv_splits`` blocks; this script
times the launch with the group cut among 1, 2, 4 and 8 blocks (by setting
``flash_attention.DKDV_WALK``), in the order 1, 2, 4, 8, 8, 4, 2, 1.

Run from the repository root: ``python3 tools/attention_bwd_splits.py``.
For each run it prints one ``splits <n> {json}`` line: the device ms of
each kernel (torch.profiler; ``flash_bwd_dkdv`` includes the partials'
sum), the launch's ms by CUDA events, the largest error against the plain
twin over each output's largest magnitude, and whether two launches are
bit-equal; then the card's name and power limit.
"""
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

#: the walk limit that makes `dkdv_splits` cut the training launch's group
#: of 8 among n blocks (its heaviest key tile sees 32 query tiles)
WALK = {1: 256, 2: 128, 4: 64, 8: 32}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    B, Hq, Hkv, S, D = 2, 32, 4, 2048, 64
    gen = torch.Generator(device=dev).manual_seed(C.SEED + 27)
    q, k, v = C._flash_args(gen, dev, B, Hq, Hkv, S, S, D, qdt=torch.bfloat16,
                            kvdt=torch.bfloat16)
    do = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    o = FA.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_bwd(q, k, v, o, do)
    kern = lambda: FA.flash_attention_bwd(q, k, v, o, do, causal=True)
    for n in (1, 2, 4, 8, 8, 4, 2, 1):
        FA.DKDV_WALK = WALK[n]
        if FA.dkdv_splits(Hq, Hkv, S, S, True, 0, FA.DKDV_WALK) != n:
            sys.exit(f"DKDV_WALK {WALK[n]} does not give {n} splits")
        got, again = kern(), kern()
        torch.cuda.synchronize()
        print(f"splits {n} " + json.dumps(dict(
            device_ms={p: C.profiled_ms(kern, 5, p) for p in C.BWD_PARTS},
            ms=C.cuda_ms(kern, 20), max_rel_err=C._rel_each(got, want),
            bit_equal=all(torch.equal(x, y) for x, y in zip(got, again)))), flush=True)
    print(C._card())


if __name__ == "__main__":
    main()
