"""Success-rate statistics.

Port of graphik_tpu/utils/stats.py (numpy and the standard library only,
the same values): Bernoulli confidence intervals for batched experiment
sweeps - normal approximation, Wilson and Jeffreys - with the normal
quantile from Acklam's inverse-CDF approximation (no scipy), and the
perturbation between two point sets.
"""

from __future__ import annotations

import math

import numpy as np


def _ndtri(p: float) -> float:
    """Inverse standard normal CDF (Acklam's rational approximation)."""
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0, 1)")
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
        den = (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        return num / den
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
        den = (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        return -num / den
    q = p - 0.5
    r = q * q
    num = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
    return num / den


def bernoulli_confidence_normal_approximation(n, n_success, confidence=0.95):
    """(p_hat, radius) by the normal approximation."""
    alpha = 1.0 - confidence
    z = _ndtri(1.0 - alpha / 2.0)
    p_hat = n_success / n
    rad = z * math.sqrt((p_hat * (1 - p_hat)) / n)
    return p_hat, rad


def wilson(n, n_success, alpha=0.95):
    """(lower, upper) Wilson score interval.

    NOTE: `alpha` is the SIGNIFICANCE level (pass 0.05 for a 95% interval).
    The default 0.95 mirrors the reference signature verbatim, whose
    callers override it - with the default you get a ~5% interval.
    """
    p = n_success / n
    z = _ndtri(1.0 - alpha / 2.0)
    denominator = 1 + z**2 / n
    centre = p + z * z / (2 * n)
    sd = math.sqrt((p * (1 - p) + z * z / (4 * n)) / n)
    return (centre - z * sd) / denominator, (centre + z * sd) / denominator


def bernoulli_confidence_jeffreys(n, n_success, confidence=0.95):
    """(p_hat, radius) via the Jeffreys Beta(0.5, 0.5) interval. Uses a
    bisection on the regularized incomplete beta function."""
    alpha_low = (1.0 - confidence) / 2.0
    alpha_high = confidence + alpha_low
    a = n_success + 0.5
    b = n - n_success + 0.5

    def betainc(a, b, x, terms=200):
        # continued-fraction-free series via numerical integration
        ts = np.linspace(0.0, x, terms + 1)[1:]
        dt = x / terms
        lg = math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
        vals = np.exp(lg + (a - 1) * np.log(ts) + (b - 1) * np.log1p(-ts))
        return float(np.sum(vals) * dt)

    def btdtri(a, b, p):
        lo, hi = 1e-12, 1 - 1e-12
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            if betainc(a, b, mid) < p:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    low_end = 0.0 if n_success == 0 else btdtri(a, b, alpha_low)
    high_end = 1.0 if n_success == n else btdtri(a, b, alpha_high)
    p_hat = (low_end + high_end) / 2.0
    rad = (high_end - low_end) / 2.0
    return p_hat, rad


def measure_perturbation(points, points_perturbed):
    """Aggregate perturbation between two point sets.

    points / points_perturbed: (..., N, dim) arrays or tensors, rows in
    node order. Returns
    (total_l2, max_abs): sqrt of the summed squared per-point displacement
    norms, and the largest absolute coordinate change.
    """
    p = np.asarray(points)
    q = np.asarray(points_perturbed)
    diff = p - q
    total = np.sqrt(np.sum(np.sum(diff**2, axis=-1), axis=-1))
    max_abs = np.max(np.abs(diff), axis=(-2, -1))
    return total, max_abs
