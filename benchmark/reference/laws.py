"""Laws that a family's definition gives its draws, and the
Kolmogorov-Smirnov test of a sample against one.

A check of the draws' support and shapes cannot see a sampler whose
distribution is wrong inside the support; this can. A law is a CDF over
float64 values.
"""

import math

import torch

# the chance that a sound sample fails one test; a run makes about a dozen
ALPHA = 1e-7


def normal(sigma: float):
    return lambda x: 0.5 * torch.erfc(-x / (sigma * math.sqrt(2.0)))


def uniform(lo: float, hi: float):
    return lambda x: ((x - lo) / (hi - lo)).clamp(0.0, 1.0)


def ks_pvalue(values, cdf) -> float:
    """The chance that a sample of the law is at least as far from it, by
    the Kolmogorov-Smirnov distance (asymptotic, with Stephens' correction
    for small samples)."""
    x = torch.sort(values.double().reshape(-1)).values
    n = x.numel()
    f = cdf(x)
    i = torch.arange(1, n + 1, dtype=torch.float64)
    d = float(torch.maximum(i / n - f, f - (i - 1) / n).max())
    lam = (math.sqrt(n) + 0.12 + 0.11 / math.sqrt(n)) * d
    if lam < 0.2:
        return 1.0
    p = 2.0 * sum((-1) ** (k - 1) * math.exp(-2.0 * k * k * lam * lam) for k in range(1, 101))
    return min(max(p, 0.0), 1.0)


def violations(samples: dict) -> dict:
    """{name: [(values, cdf), ...]} pooled by name -> {name: 1} for each
    pooled sample that its law rejects at ALPHA."""
    out = {}
    for name, parts in samples.items():
        values = torch.cat([v.double().reshape(-1) for v, _ in parts])
        if ks_pvalue(values, parts[0][1]) < ALPHA:
            out[f"law:{name}"] = 1
    return out
