"""Poisson-binomial distribution machinery.

The statistical core of the CDDF error bars (calc_cddf.py:1021-1056,
986-1019, 780-798): the number of DLAs in a bin is a sum of independent
Bernoulli trials with heterogeneous probabilities — a Poisson-binomial
distribution.  High-probability trials (p >= p_switch = 0.25, Le Cam
1960) are treated exactly via the DFT characteristic-function method
(Fernandez & Williams 2010); the many low-probability trials are
absorbed into a Poisson term with matched mean, and the two PDFs are
convolved.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.stats import poisson

__all__ = [
    "poisson_binomial_pdf",
    "combine_with_poisson",
    "interval",
    "pdf_confidence",
]


def _stable_complex_product(values: np.ndarray) -> complex:
    """prod(z_k) = exp(fsum(log|z_k|) + i fsum(arg z_k)) — stable for
    thousands of factors inside the unit circle (calc_cddf.py:1046-1056)."""
    r = np.abs(values)
    theta = np.angle(values)
    log_r = math.fsum(np.log(r)) if r.size else 0.0
    ang = math.fsum(theta) if theta.size else 0.0
    return math.exp(log_r) * complex(math.cos(ang), math.sin(ang))


def poisson_binomial_pdf(probabilities) -> np.ndarray:
    """Exact PDF of sum of Bernoulli(p_k) via DFT (calc_cddf.py:1021-1044).

    ``probabilities``: flat array-like (or list of arrays) of p values.
    Returns pdf over counts 0..N.
    """
    if isinstance(probabilities, (list, tuple)):
        probabilities = (
            np.concatenate([np.atleast_1d(p) for p in probabilities])
            if len(probabilities)
            else np.empty(0)
        )
    p = np.asarray(probabilities, np.float64).ravel()
    n = p.size
    if n == 0:
        return np.ones(1)
    # Probabilities can carry storage-precision noise: the f32 sample
    # matrices round-trip normalization at ~1e-6, so a spectrum whose
    # posterior sits entirely on one sample yields p = 1 + O(1e-6)
    # (seen at survey scale).  The
    # reference has no guard and lets the DFT emit a small NEGATIVE
    # pdf mass for such p (calc_cddf.py:1040); our pdf clip below
    # would turn that into a normalization error, so clamp the INPUT
    # into [0, 1] instead — after bounding the excursion to noise
    # level (a p of 1.5 is an upstream bug, not noise).  The bound must
    # cover linear f32 accumulation over the 10k-sample axis: measured
    # excursions reach 1.09e-4 at 16k sightlines;
    # worst-case linear drift is ~1e-3.
    eps = 5e-3
    assert -eps < float(p.min()) and float(p.max()) < 1.0 + eps, (
        p.min(), p.max())
    p = np.clip(p, 0.0, 1.0)

    # characteristic function at the (N+1) DFT frequencies; Hermitian
    # symmetry lets us compute only the first half and irfft back
    coeffs = np.empty(n // 2 + 2, dtype=complex)
    for k in range((n + 1) // 2 + 1):
        w = np.exp(-2j * np.pi * k / (n + 1)) - 1.0
        coeffs[k] = _stable_complex_product(1.0 + p * w)
    pdf = np.fft.irfft(coeffs[: (n + 1) // 2 + 1], n=n + 1)
    pdf = np.maximum(pdf, 0.0)
    assert abs(math.fsum(pdf) - 1.0) < 1e-7
    return pdf


def interval(cdf: np.ndarray, level: float, offset: int = 0) -> tuple[int, int]:
    """Central confidence interval indices at `level` for a discrete CDF
    (calc_cddf.py:986-1008 semantics)."""
    if np.size(cdf) == 1:
        return (offset, offset)
    low = offset
    high = 1 + offset
    idown = np.flatnonzero(cdf < 0.5 - level / 2.0)
    if idown.size:
        low += idown[-1] + 1
    iup = np.flatnonzero(cdf > 0.5 + level / 2.0)
    if iup.size:
        high += iup[0]
    else:
        high = np.size(cdf)
    return (low, high)


def pdf_confidence(pdf: np.ndarray, offset: int = 0):
    """(MAP index, 68% interval, 95% interval), all offset-shifted
    (calc_cddf.py:1010-1019)."""
    cdf = np.cumsum(pdf)
    maxlike = interval(cdf, 0.0, offset=offset)[0]
    ll68 = interval(cdf, 0.68, offset=offset)
    ll95 = interval(cdf, 0.95, offset=offset)
    assert ll95[0] <= ll68[0] <= maxlike <= ll68[1] <= ll95[1]
    return maxlike, ll68, ll95


def combine_with_poisson(pdf_pb: np.ndarray, pmean: float):
    """Convolve a Poisson-binomial PDF with Poisson(pmean), trimming
    1e-4 tails (calc_cddf.py:780-798).

    Returns (combined_pdf, offset): combined_pdf[i] is the probability
    of count (offset + i).
    """
    if pmean == 0.0:
        return pdf_pb, 0
    weak = poisson(pmean)
    plow, phigh = (int(v) for v in weak.interval(1 - 1e-4))
    cdf = np.cumsum(pdf_pb)
    dlow, dhigh = interval(cdf, 1 - 1e-4)
    dhigh = min(dhigh + 1, np.size(pdf_pb))

    counts = np.arange(plow + dlow, phigh + dhigh)
    i = np.arange(dlow, dhigh)
    # pdf_comb[N] = sum_i Poisson(N - i) * pdf_pb[i]
    pmf = weak.pmf(counts[:, None] - i[None, :])
    pdf_comb = pmf @ pdf_pb[dlow:dhigh]
    total = math.fsum(pdf_comb)
    assert 0.99 < total <= 1.0 + 1e-9
    return pdf_comb, plow + dlow
