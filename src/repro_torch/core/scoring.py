"""Risk-averse scoring of candidate columns (paper §4.1/§4.4).

Eq. 5: score = |r̂| · (1 − risk). The engine serves s1 = |r|, s2 = |r| ·
(1 − se_z) and s4 = |r| · ci_h, where ci_h is list-normalised over the
eligible candidates of one query. These are the formulas
`repro_torch.engine.plans.score_stats` applies.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bounds as B

_BIG = float(np.float32(3.4e38))


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
