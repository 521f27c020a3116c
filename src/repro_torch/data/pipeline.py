"""Synthetic relational tables for the paper's workloads (§5.1), in numpy.

The table generators the engine and its tests need: `Table` (one ⟨K, X⟩
column pair), `TableGroup` (a join-key column shared by C numeric columns),
`multi_column_group` (a wide table with known cross-column correlation),
`group_corpus` / `grow_corpus` (a corpus of wide tables, and one arriving
in batches, the live index's workload), `sbn_pair` (the SBN
bivariate-normal pair), `skewed_pair` (an open-data-like pair) and
`corpus` (a collection of either), and `joined_truth` (the exact join
the estimates are scored against). Same seeds give the same tables as the
JAX package's generators. For the LM substrate, `lm_batch`:
seeded synthetic token batches, equal to the JAX package's for a seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


def lm_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int, step: int,
             microbatches: int = 1) -> Dict[str, np.ndarray]:
    """One deterministic LM batch, microbatch-major ([n_mb, mb, S])."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    out = {"tokens": toks, "labels": labels}
    if cfg.frontend == "patches" and cfg.num_prefix_embeds > 0:
        out["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers > 0:
        out = {
            "frames": rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32),
            "target_tokens": toks[:, :448] if seq >= 448 else toks,
            "target_labels": labels[:, :448] if seq >= 448 else labels,
        }
    # always microbatch-major: [n_mb, B/n_mb, ...] (n_mb=1 ⇒ [1, B, ...])
    out = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
           for k, v in out.items()}
    return out


@dataclasses.dataclass
class Table:
    """⟨K, X⟩ column pair: integer join keys + numeric column."""
    keys: np.ndarray     # uint32 (hash-ready ids; strings hashed at ingest)
    values: np.ndarray   # float32
    name: str = ""
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TableGroup:
    """One relational table: a join-key column shared by C numeric columns,
    sketched together by the index build."""
    keys: np.ndarray             # [m] uint32 (hash-ready ids)
    values: np.ndarray           # [C, m] float32
    name: str = ""
    column_names: List[str] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def num_columns(self) -> int:
        return self.values.shape[0]

    def column_name(self, c: int) -> str:
        if c < len(self.column_names):
            return self.column_names[c]
        return f"{self.name or 'table'}.c{c}"

    def columns(self) -> List[Table]:
        return [Table(keys=self.keys, values=self.values[c],
                      name=self.column_name(c), meta=self.meta)
                for c in range(self.num_columns)]


def multi_column_group(rng, n_cols: int = 16, n_max: int = 100_000,
                       key_space: int = 1 << 30, name: str = "",
                       nan_frac: float = 0.01,
                       n_rows: Optional[int] = None,
                       keep_latent: bool = False) -> TableGroup:
    """A wide table whose every column is a noisy mix of one shared latent
    factor, so column i correlates with the latent with a known r_i
    (``meta['r']``). Missing values are sprinkled per column.

    ``n_rows`` fixes the row count (default: drawn from [512, n_max));
    ``keep_latent`` stashes the latent column in ``meta['latent']`` so a
    caller can plant a query with a known best-correlated column.
    """
    m = int(n_rows) if n_rows else int(rng.integers(512, n_max))
    keys = rng.choice(key_space, size=m, replace=False).astype(np.uint32)
    latent = rng.standard_normal(m).astype(np.float32)
    rs = rng.uniform(-1, 1, size=n_cols)
    vals = np.empty((n_cols, m), np.float32)
    for c in range(n_cols):
        noise = rng.standard_normal(m)
        vals[c] = (rs[c] * latent
                   + np.sqrt(max(1 - rs[c] ** 2, 0.0)) * noise).astype(np.float32)
        if nan_frac > 0:
            vals[c, rng.random(m) < nan_frac] = np.nan
    meta = {"r": rs.tolist()}
    if keep_latent:
        meta["latent"] = latent
    return TableGroup(keys=keys, values=vals, name=name,
                      column_names=[f"{name}.c{c}" for c in range(n_cols)],
                      meta=meta)


def group_corpus(rng, n_groups: int, n_cols: int = 16, n_max: int = 100_000
                 ) -> List[TableGroup]:
    """A corpus of wide tables — the §5.5-style ingest workload."""
    return [multi_column_group(rng, n_cols=n_cols, n_max=n_max, name=f"g{i}")
            for i in range(n_groups)]


def grow_corpus(rng, n_batches: int, tables_per_batch: int = 4,
                n_cols: int = 8, n_max: int = 8000,
                key_space: int = 1 << 14, start: int = 0
                ) -> Iterator[List[TableGroup]]:
    """A growing corpus: successive arrival batches of wide tables, the
    live index's workload. All batches share one key universe, so queries
    join across the whole history; names continue ``g{start}, g{start+1},
    …`` so later arrivals extend earlier ones."""
    i = start
    for _ in range(n_batches):
        batch = [multi_column_group(rng, n_cols=n_cols, n_max=n_max,
                                    key_space=key_space, name=f"g{i + j}")
                 for j in range(tables_per_batch)]
        i += tables_per_batch
        yield batch


def sbn_pair(rng, n_max: int = 500_000, r: Optional[float] = None,
             key_space: int = 1 << 30) -> Tuple[Table, Table, float, float]:
    """One Synthetic-Bivariate-Normal table pair (§5.1 SBN): n ~ U(256,
    n_max) rows with unique keys, (x, y) ~ N(0, Σ(r)), and table Y a
    uniform subsample of size n·c, c ~ U(0.05, 1). Returns (T_X, T_Y, r, c).
    """
    n = int(rng.integers(256, n_max))
    r = float(rng.uniform(-1, 1)) if r is None else r
    keys = rng.choice(key_space, size=n, replace=False).astype(np.uint32)
    cov = np.array([[1.0, r], [r, 1.0]])
    xy = rng.multivariate_normal([0.0, 0.0], cov, size=n).astype(np.float32)
    c = float(rng.uniform(0.05, 1.0))
    m = max(int(n * c), 8)
    sel = rng.choice(n, size=m, replace=False)
    tx = Table(keys=keys, values=xy[:, 0], name="X", meta={"r": r})
    ty = Table(keys=keys[sel], values=xy[sel, 1], name="Y", meta={"r": r, "c": c})
    return tx, ty, r, c


def skewed_pair(rng, n_max: int = 200_000, key_space: int = 1 << 30
                ) -> Tuple[Table, Table, float, float]:
    """Open-data-like pair (NYC/WBF §5.1): repeated keys (zipf
    multiplicities), heavy-tailed values (an expm1 transform of either
    side, each with probability ½) and 2% missing x values. Returns (T_X,
    T_Y, r, c) like `sbn_pair`."""
    n = int(rng.integers(256, n_max))
    n_distinct = max(int(n * rng.uniform(0.3, 1.0)), 64)
    base = rng.choice(key_space, size=n_distinct, replace=False).astype(np.uint32)
    keys = base[rng.zipf(2.0, size=n) % n_distinct]
    r = float(rng.uniform(-1, 1))
    latent = rng.standard_normal(n)
    noise = rng.standard_normal(n)
    x = latent
    y = r * latent + np.sqrt(max(1 - r * r, 0.0)) * noise
    if rng.random() < 0.5:
        x = np.sign(x) * np.expm1(np.abs(x))
    if rng.random() < 0.5:
        y = np.sign(y) * np.expm1(np.abs(y))
    x[rng.random(n) < 0.02] = np.nan
    c = float(rng.uniform(0.05, 1.0))
    m = max(int(n * c), 8)
    sel = rng.choice(n, size=m, replace=False)
    return (Table(keys=keys, values=x.astype(np.float32), name="X"),
            Table(keys=keys[sel], values=y[sel].astype(np.float32), name="Y"),
            r, c)


def corpus(rng, n_tables: int, kind: str = "sbn", n_max: int = 100_000):
    """``n_tables`` pairs of `sbn_pair` (``kind="sbn"``) or `skewed_pair`
    (any other kind), for estimation-accuracy experiments."""
    gen = sbn_pair if kind == "sbn" else skewed_pair
    return [gen(rng, n_max=n_max) for _ in range(n_tables)]


def joined_truth(tx: Table, ty: Table, agg: str = "mean"):
    """Ground truth: the full join of two tables on their keys, each side's
    values of a key aggregated by ``agg`` (mean, sum, min, max, count,
    first, last; NaN values dropped first) → (x_joined, y_joined), float64
    arrays aligned on the ascending common keys."""
    import collections
    ax: dict = collections.defaultdict(list)
    ay: dict = collections.defaultdict(list)
    for k, v in zip(tx.keys.tolist(), tx.values.tolist()):
        if np.isfinite(v):
            ax[k].append(v)
    for k, v in zip(ty.keys.tolist(), ty.values.tolist()):
        if np.isfinite(v):
            ay[k].append(v)
    f = {"mean": np.mean, "sum": np.sum, "min": np.min, "max": np.max,
         "count": len, "first": lambda s: s[0], "last": lambda s: s[-1]}[agg]
    common = sorted(set(ax) & set(ay))
    x = np.array([f(ax[k]) for k in common], np.float64)
    y = np.array([f(ay[k]) for k in common], np.float64)
    return x, y
