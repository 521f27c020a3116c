"""Risk-averse scoring of candidate columns (paper §4.1/§4.4).

Eq. 5: score = |r̂| · (1 − risk). Four scorers:

  s1 = |r_p|                (no penalisation)
  s2 = |r_p| · (1 − se_z)   (Fisher-Z standard error, §4.2)
  s3 = |r_b| · ci_b         (PM1 bootstrap CI)
  s4 = |r_p| · ci_h         (Hoeffding CI, list-normalised over the
                             eligible candidates of one query)

The serving engine (`repro_torch.engine.plans.score_stats`) applies the
same formulas for s1, s2 and s4.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bounds as B

_BIG = float(np.float32(3.4e38))


@dataclasses.dataclass(frozen=True)
class CandidateStats:
    """Per-candidate statistics a scorer may consume (all ``[C]``): the
    inputs of the Eq. 5 framework (§4.1/§4.4)."""
    r_p: torch.Tensor                     # Pearson (or chosen) estimate
    m: torch.Tensor                       # sketch-join sample size
    ci_lo: torch.Tensor                   # Hoeffding/HFD CI (§4.3)
    ci_hi: torch.Tensor
    r_b: Optional[torch.Tensor] = None    # PM1 bootstrap estimate
    ci_b_lo: Optional[torch.Tensor] = None
    ci_b_hi: Optional[torch.Tensor] = None


def se_z_factor(m: torch.Tensor) -> torch.Tensor:
    """Fisher-Z risk factor 1 − se_z (the s2 scorer's penalty, §4.2)."""
    return 1.0 - B.fisher_z_se(m)


def ci_h_bounds(ci_len, eligible, dim: int = -1, keepdim: bool = False):
    """(min, max) CI length over the eligible candidates along ``dim`` —
    the normalisation bounds of the s4 scorer (§4.4)."""
    lmin = torch.where(eligible, ci_len, _BIG).amin(dim, keepdim=keepdim)
    lmax = torch.where(eligible, ci_len, -_BIG).amax(dim, keepdim=keepdim)
    return lmin, lmax


def ci_h_factor_from_bounds(ci_len, lmin, lmax) -> torch.Tensor:
    """The §4.4 ci_h penalty 1 − (len − min)/(max − min), clipped to [0, 1],
    for normalisation bounds that broadcast against ``ci_len``."""
    rng = torch.clamp(lmax - lmin, min=1e-12)
    return torch.clamp(1.0 - (torch.minimum(ci_len, lmax) - lmin) / rng,
                       0.0, 1.0)


def ci_h_factor(ci_len, eligible=None) -> torch.Tensor:
    """List-normalised Hoeffding penalty 1 − (len − min)/(max − min) over
    the ``eligible`` candidates of the last axis (all when None); the
    others get the full penalty, 0."""
    if eligible is None:
        eligible = torch.ones_like(ci_len, dtype=torch.bool)
    lmin, lmax = ci_h_bounds(ci_len, eligible, keepdim=True)
    return torch.where(eligible, ci_h_factor_from_bounds(ci_len, lmin, lmax),
                       0.0)


def ci_b_factor(lo, hi) -> torch.Tensor:
    """Bootstrap-CI risk factor 1 − len/2 (s3's penalty, §4.4; bootstrap
    CIs lie in [−1, 1])."""
    return 1.0 - (hi - lo) * 0.5


def score(stats: CandidateStats, scorer: str = "s4",
          eligible=None) -> torch.Tensor:
    """Eq. 5 for a batch of candidates under scorer s1, s2, s3 or s4."""
    if scorer == "s1":
        return torch.abs(stats.r_p)
    if scorer == "s2":
        return torch.abs(stats.r_p) * se_z_factor(stats.m)
    if scorer == "s3":
        if stats.r_b is None:
            raise ValueError("s3 needs bootstrap stats (run scoring with "
                             "bootstrap=True)")
        return torch.abs(stats.r_b) * ci_b_factor(stats.ci_b_lo, stats.ci_b_hi)
    if scorer == "s4":
        return torch.abs(stats.r_p) * ci_h_factor(stats.ci_hi - stats.ci_lo,
                                                  eligible)
    raise ValueError(f"unknown scorer {scorer!r}")


SCORERS = ("s1", "s2", "s3", "s4")
