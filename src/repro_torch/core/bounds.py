"""Confidence-bound helpers the scoring tail needs (paper §4.2/§4.3).

The §4.3 Hoeffding interval itself is computed from raw moments by
`repro_torch.kernels.ref.hoeffding_from_moments`; `containment_ci` is the
joinability estimators' interval (`repro_torch.core.containment`).
"""
from __future__ import annotations

import numpy as np
import torch


def fisher_z_se(m: torch.Tensor) -> torch.Tensor:
    """Standard error of Fisher's Z transform: 1/sqrt(max(4, m) − 3) (§4.2)."""
    mm = torch.clamp(m.to(torch.float32), min=4.0)
    return 1.0 / torch.sqrt(mm - 3.0)


def hoeffding_eligibility_floor(min_sample: int = 3) -> int:
    """The sample-size floor of the scoring paths: candidates with m < floor
    score −∞. The §4.3 CI, like Pearson r itself, is vacuous below m = 2;
    the paper's default is 3."""
    return int(min_sample)


def containment_ci(c_hat, probes, alpha: float = 0.05):
    """Hoeffding CI for a KMV containment estimate (§2.1): ``c_hat =
    hits / probes`` is a mean of ``probes`` Bernoulli membership trials, so
    ``t = sqrt(ln(2/α) / 2·probes)`` bounds ``P(|ĉ − c| ≥ t) ≤ α``.

    Returns ``(lo, hi)`` clipped to [0, 1]; (0, 1) where there were no
    probes. Host numpy arrays in and out (the joinability estimators call
    it per query on ``[C]`` scalars); shapes broadcast."""
    probes = np.asarray(probes, dtype=np.float32)
    t = np.sqrt(np.log(2.0 / alpha) / (2.0 * np.maximum(probes, 1.0)))
    lo = np.clip(c_hat - t, 0.0, 1.0)
    hi = np.clip(c_hat + t, 0.0, 1.0)
    ok = probes > 0
    return np.where(ok, lo, 0.0), np.where(ok, hi, 1.0)
