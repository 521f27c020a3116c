"""Correlation estimators over masked sketch-join samples (paper §5.3).

Every estimator takes ``a, b: f32[..., n]`` and a validity ``mask`` (bool
``[..., n]``, the sketch-join output) and works for any valid count
``m ≤ n``. Leading axes are batch axes: a stack of candidates' join
samples is one call.

  1. Pearson's sample correlation (Eq. 3)
  2. Spearman's rank correlation (average ranks for ties)
  3. Rank-based Inverse Normal (RIN) via the rankit transform
  4. Qn robust correlation (Shevlyakov & Oja)
  5. PM1 bootstrap (Wilcox's modified percentile bootstrap)

The ranks come from the ``rank_transform`` kernel and Qn from the
``qn_correlation`` kernel (`repro_torch.kernels.ops`); on CPU tensors both
run their plain twins.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import hashing


def _ops():
    # the kernels' twins import `repro_torch.core.hashing`, so this package
    # reaches the kernels only when it is first called
    from repro_torch.kernels import ops
    return ops


def _masked_moments(a, b, mask):
    m = mask.sum(-1).to(torch.float32)
    msafe = torch.clamp(m, min=1.0)
    w = mask.to(torch.float32)
    mu_a = (a * w).sum(-1) / msafe
    mu_b = (b * w).sum(-1) / msafe
    va = ((a * a) * w).sum(-1) / msafe
    vb = ((b * b) * w).sum(-1) / msafe
    vab = ((a * b) * w).sum(-1) / msafe
    return m, mu_a, mu_b, va, vb, vab


def pearson(a, b, mask) -> torch.Tensor:
    """Masked Pearson r (Eq. 3); 0 where undefined (m < 2 or zero
    variance)."""
    m, mu_a, mu_b, va, vb, vab = _masked_moments(a, b, mask)
    cov = vab - mu_a * mu_b
    var_a = torch.clamp(va - mu_a * mu_a, min=0.0)
    var_b = torch.clamp(vb - mu_b * mu_b, min=0.0)
    den = torch.sqrt(var_a) * torch.sqrt(var_b)
    ok = (m >= 2) & (den > 1e-12)
    return torch.where(ok, cov / torch.where(ok, den, 1.0), 0.0)


def average_ranks(x, mask) -> torch.Tensor:
    """1-based average ranks among the valid entries, ties sharing their
    mean rank, 0 in masked slots: ``#less_i + (#equal_i + 1)/2``, exact
    half-integers (the ``rank_transform`` kernel)."""
    return _ops().rank_transform(x, mask)


def spearman(a, b, mask) -> torch.Tensor:
    """Spearman's rho (§5.3 item 2): Pearson over average ranks."""
    return pearson(average_ranks(a, mask), average_ranks(b, mask), mask)


def rin(a, b, mask) -> torch.Tensor:
    """Rank-based Inverse Normal correlation through the rankit transform
    h(x) = Φ⁻¹((r(x) − ½) / m) (§5.3), Φ⁻¹ in float32."""
    m = torch.clamp(mask.sum(-1, keepdim=True).to(torch.float32), min=1.0)
    qa = torch.clamp((average_ranks(a, mask) - 0.5) / m, 1e-6, 1.0 - 1e-6)
    qb = torch.clamp((average_ranks(b, mask) - 0.5) / m, 1e-6, 1.0 - 1e-6)
    ta = torch.where(mask, torch.special.ndtri(qa), 0.0)
    tb = torch.where(mask, torch.special.ndtri(qb), 0.0)
    return pearson(ta, tb, mask)


def qn_correlation(a, b, mask) -> torch.Tensor:
    """ρ_Qn = (Qn(u)² − Qn(v)²)/(Qn(u)² + Qn(v)²) for the standardised
    sum and difference u, v (Shevlyakov & Oja, §5.3 item 4), clipped to
    [−1, 1]; 0 for degenerate scales (the ``qn_correlation`` kernel)."""
    return _ops().qn_correlation(a, b, mask.to(torch.float32))


# ----------------------------------------------------------------------------
# PM1 bootstrap (Wilcox modified percentile bootstrap)
# ----------------------------------------------------------------------------

_B = 599  # canonical resample count of the modified percentile bootstrap


def _wilcox_cutpoints(m):
    """1-based order-statistic cut points (a, b) for B = 599 given the
    sample size m (Wilcox 1996, PM1)."""
    w = torch.where
    a = w(m < 40, 7, w(m < 80, 8, w(m < 180, 11, w(m < 250, 14, 15))))
    b = w(m < 40, 593, w(m < 80, 592, w(m < 180, 588, w(m < 250, 585, 584))))
    return a, b


def bootstrap_keys(shape, generator: torch.Generator) -> torch.Tensor:
    """One 31-bit stream key per sample (int64, on the generator's
    device): the randomness `pm1_bootstrap` draws."""
    return torch.randint(0, 1 << 31, tuple(shape), generator=generator,
                         device=generator.device, dtype=torch.int64)


def _uniforms(keys, rows: int, n: int) -> torch.Tensor:
    """``[..., rows, n]`` uniforms in [0, 1) with 24 random bits each: the
    murmur3 hash of (stream key, counter). A counter-based draw, so a
    sample's resamples do not depend on which samples share the call, nor
    on the device."""
    ctr = torch.arange(rows * n, dtype=torch.int64, device=keys.device)
    h = hashing.murmur3_32((keys[..., None] << 32) | ctr)
    u = (h >> 8).to(torch.float32) * np.float32(2.0 ** -24)
    return u.reshape(*keys.shape, rows, n)


def pm1_bootstrap(a, b, mask, generator: torch.Generator,
                  num_resamples: int = _B
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PM1 bootstrap estimate of r and its modified-percentile CI, per
    sample: ``(r_b, lo, hi)``, r_b the mean of ``num_resamples`` resampled
    Pearson r's (§5.3 item 5) and [lo, hi] the Wilcox cut points the ci_b
    scorer uses. Samples with m < 3 give (0, −1, 1)."""
    keys = bootstrap_keys(a.shape[:-1], generator).to(a.device)
    return pm1_from_keys(a, b, mask, keys, num_resamples)


def pm1_from_keys(a, b, mask, keys, num_resamples: int = _B):
    """`pm1_bootstrap` with each sample's stream key given (`bootstrap_
    keys`), so a caller may draw the keys once and resample in chunks."""
    n = a.shape[-1]
    m = mask.sum(-1)
    # compact the valid entries to the front so the index draw is dense
    perm = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    ac = torch.take_along_dim(a, perm, dim=-1)
    bc = torch.take_along_dim(b, perm, dim=-1)
    u = _uniforms(keys, num_resamples, n)
    scale = torch.clamp(m, min=1).to(torch.float32)[..., None, None]
    idx = torch.clamp(torch.floor(u * scale).to(torch.int64), 0, n - 1)
    keep = torch.arange(n, device=a.device) < m[..., None, None]
    full = idx.shape
    ra = torch.gather(ac[..., None, :].expand(full), -1, idx)
    rb = torch.gather(bc[..., None, :].expand(full), -1, idx)
    rs = pearson(ra, rb, keep.expand(full))          # [..., B]
    r_b = rs.mean(-1)
    rs_sorted = torch.sort(rs, dim=-1).values
    lo_i, hi_i = _wilcox_cutpoints(m)
    pick = lambda i: torch.take_along_dim(
        rs_sorted, torch.clamp(i - 1, 0, num_resamples - 1)[..., None],
        dim=-1)[..., 0]
    ok = m >= 3
    return (torch.where(ok, r_b, 0.0), torch.where(ok, pick(lo_i), -1.0),
            torch.where(ok, pick(hi_i), 1.0))


ESTIMATORS = {
    "pearson": pearson,
    "spearman": spearman,
    "rin": rin,
    "qn": qn_correlation,
}
