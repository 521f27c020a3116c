"""Confidence-bound helpers the scoring tail needs (paper §4.2/§4.3).

The §4.3 Hoeffding interval itself is computed from raw moments by
`repro_torch.kernels.ref.hoeffding_from_moments`.
"""
from __future__ import annotations

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
