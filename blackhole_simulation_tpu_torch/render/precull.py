"""Shadow-interior precull: the critical curve as a Chebyshev series.

Counterpart of ``blackhole_simulation_tpu/render/precull.py:49-116``. A ray
whose conserved (lambda, eta) lies inside the Bardeen critical curve is
provably captured; the render kernel tests that per pixel against a
``_CHEB_K``-term Chebyshev fit of eta_c(lambda), built here once per frame
on the host in float64.
"""

from __future__ import annotations

import numpy as np

# Chebyshev fit of the critical curve eta_c(lam): terms, and the bound on
# |fit - exact| over a in [0.1, 0.999] that the cull subtracts so it can only
# be more conservative than the exact test.
_CHEB_K = 32
_CHEB_ERR = 0.03


def _lam_c(m, a, s):
    """Critical lambda of the spherical photon orbit at radius s."""
    return (s * s * (3.0 * m - s) - a * a * (m + s)) / (a * (s - m))


def _eta_c(m, a, s):
    """Critical eta of the spherical photon orbit at radius s."""
    sm = s - m
    return s**3 * (4.0 * a * a * m - s * (s - 3.0 * m) ** 2) / (a * a * sm * sm)


def photon_orbit_radii(m, a):
    """Pro/retrograde equatorial circular photon radii
    r = 2M {1 + cos[(2/3) arccos(-+ a/M)]}."""
    x = np.clip(a / m, -1.0, 1.0)
    s_pro = 2.0 * m * (1.0 + np.cos(2.0 / 3.0 * np.arccos(-x)))
    s_retro = 2.0 * m * (1.0 + np.cos(2.0 / 3.0 * np.arccos(x)))
    return s_pro, s_retro


def _eta_crit_cheb_coeffs(m, a):
    """Chebyshev interpolation of eta_c(lam) along the critical curve, float64.

    Bisects s*(lam) at the K Chebyshev nodes of [lam_lo, lam_hi], then
    projects eta_c(s*) by a DCT. Returns (coeffs (K,), mid, half, lam_lo,
    lam_hi) where the series variable is t = (lam - mid) / half.
    """
    m = np.float64(m)
    a = np.float64(a)
    s_pro, s_retro = photon_orbit_radii(m, a)
    lam_hi = _lam_c(m, a, s_pro)
    lam_lo = _lam_c(m, a, s_retro)
    mid = 0.5 * (lam_hi + lam_lo)
    half = 0.5 * (lam_hi - lam_lo)
    k = np.arange(_CHEB_K, dtype=np.float64)
    x = np.cos(np.pi * (k + 0.5) / _CHEB_K)
    lam_k = mid + half * x
    lo = np.full(lam_k.shape, s_pro)
    hi = np.full(lam_k.shape, s_retro)
    for _ in range(40):
        s_mid = 0.5 * (lo + hi)
        go_right = _lam_c(m, a, s_mid) > lam_k
        lo = np.where(go_right, s_mid, lo)
        hi = np.where(go_right, hi, s_mid)
    eta_k = _eta_c(m, a, 0.5 * (lo + hi))
    dct = np.cos(np.pi * k[:, None] * (k[None, :] + 0.5) / _CHEB_K)
    coeffs = (2.0 / _CHEB_K) * (eta_k[None, :] * dct).sum(axis=1)
    coeffs[0] *= 0.5
    return coeffs, mid, half, lam_lo, lam_hi
