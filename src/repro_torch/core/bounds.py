"""Distribution-free confidence bounds for join-correlation estimates (§4.3).

Given a sketch-join sample of size ``m`` and the full-column range
``[C_low, C_high]`` recorded at sketch-build time, five Hoeffding intervals
(for µ_A, µ_B, ν_A, ν_B, ν_AB, each at level α/5) combine through a union
bound into a CI for ρ: ``t = sqrt(ln(10/α)·C²/2m)`` for the means and
``t' = sqrt(ln(10/α)·C⁴/2m)`` for the second moments (`hoeffding_ci`; the
serving engine computes the same interval from raw moments,
`repro_torch.kernels.ref.hoeffding_from_moments`). Also the Fisher-Z
standard error (§4.2) and the joinability estimators' containment interval.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_BIG = float(np.float32(3.4e38))


@dataclasses.dataclass(frozen=True)
class CorrelationCI:
    """Per-candidate confidence interval for ρ (§4.3); ``length()`` is the
    risk signal the ci_h scorer normalises over (§4.4)."""
    lo: torch.Tensor
    hi: torch.Tensor

    def length(self) -> torch.Tensor:
        return self.hi - self.lo


def _moments(a, b, mask):
    m = torch.clamp(mask.sum(-1).to(torch.float32), min=1.0)
    w = mask.to(torch.float32)
    mu_a = (a * w).sum(-1) / m
    mu_b = (b * w).sum(-1) / m
    va = (a * a * w).sum(-1) / m
    vb = (b * b * w).sum(-1) / m
    vab = (a * b * w).sum(-1) / m
    return m, mu_a, mu_b, va, vb, vab


def hoeffding_ci(a, b, mask, c_low, c_high, alpha: float = 0.05,
                 hfd: bool = True) -> CorrelationCI:
    """§4.3 confidence interval for ρ from sketch-join samples ``a, b,
    mask [..., n]`` and the full columns' range ``c_low, c_high [...]``.

    With ``hfd=True`` (the default) the denominator falls back to the
    sample standard deviations wherever the variance lower bounds are not
    positive — the paper's ρ_HFD variant used for scoring. The bounds are
    not clipped to [−1, 1]: their raw length is the ci_h risk signal.
    Samples with m < 2 carry no information: (−3.4e38, 3.4e38)."""
    a0 = torch.where(mask, a - c_low[..., None], 0.0)
    b0 = torch.where(mask, b - c_low[..., None], 0.0)
    C = torch.clamp(c_high - c_low, min=1e-30)
    m, mu_a, mu_b, va, vb, vab = _moments(a0, b0, mask)

    log_term = torch.log(torch.tensor(10.0 / alpha, dtype=torch.float32,
                                      device=a.device))
    t = torch.sqrt(log_term * C * C / (2.0 * m))
    tp = torch.sqrt(log_term * C * C * C * C / (2.0 * m))

    num_lo = (vab - tp) - (mu_a + t) * (mu_b + t)
    num_hi = (vab + tp) - (mu_a - t) * (mu_b - t)
    den_lo = torch.sqrt(torch.clamp((va - tp) - (mu_a + t) ** 2, min=0.0)
                        * torch.clamp((vb - tp) - (mu_b + t) ** 2, min=0.0))
    den_hi = torch.sqrt(torch.clamp((va + tp) - (mu_a - t) ** 2, min=0.0)
                        * torch.clamp((vb + tp) - (mu_b - t) ** 2, min=0.0))
    if hfd:
        sden = torch.sqrt(torch.clamp(va - mu_a ** 2, min=0.0)
                          * torch.clamp(vb - mu_b ** 2, min=0.0))
        degenerate = (den_lo <= 1e-30) | (den_hi <= 1e-30)
        den_lo = torch.where(degenerate, sden, den_lo)
        den_hi = torch.where(degenerate, sden, den_hi)

    def _div(num, den):
        return num / torch.clamp(den, min=1e-30)

    lo = torch.where(num_lo >= 0, _div(num_lo, den_hi), _div(num_lo, den_lo))
    hi = torch.where(num_hi >= 0, _div(num_hi, den_lo), _div(num_hi, den_hi))
    ok = mask.sum(-1) >= 2
    return CorrelationCI(lo=torch.where(ok, lo, -_BIG),
                         hi=torch.where(ok, hi, _BIG))


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


def sample_size_for_accuracy(C: float, c_var: float, eps: float,
                             alpha: float = 0.05) -> float:
    """§4.3: n = O(C⁴ ln(1/α) / (ε² c²)) samples for ±ε accuracy, given a
    variance lower bound c."""
    return (C ** 4) * math.log(1.0 / alpha) / (eps ** 2 * c_var ** 2)
