"""Kerr metric pieces the render prologue needs, as host float64 scalars.

Counterpart of ``blackhole_simulation_tpu/geometry/metrics.py``: the
Boyer-Lindquist covariant metric at one point (``kerr_cov_bl``) and the
derived radii of ``Kerr`` (event horizon, prograde photon sphere, ISCO).
Everything here runs once per frame on the host in float64 with numpy; the
per-pixel work lives in the render kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np

def kerr_sigma(a, r, theta):
    """Sigma = r^2 + a^2 cos^2(theta)."""
    c = np.cos(theta)
    return r * r + a * a * c * c


def kerr_delta(m, a, r):
    """Delta = r^2 - 2 M r + a^2."""
    return r * r - 2.0 * m * r + a * a


def kerr_cov_bl(m, a, r, theta) -> np.ndarray:
    """Covariant Kerr metric in the Boyer-Lindquist chart at one point: (4, 4)."""
    s = np.sin(theta)
    s2 = s * s
    sig = kerr_sigma(a, r, theta)
    delta = kerr_delta(m, a, r)
    two_mr = 2.0 * m * r
    g = np.zeros((4, 4), np.float64)
    g[0, 0] = -(1.0 - two_mr / sig)
    g[0, 3] = g[3, 0] = -two_mr * a * s2 / sig
    g[1, 1] = sig / delta
    g[2, 2] = sig
    g[3, 3] = (r * r + a * a + two_mr * a * a * s2 / sig) * s2
    return g


@dataclasses.dataclass(frozen=True)
class Kerr:
    """Kerr black hole of mass M and angular momentum a = J/M (geometric units).

    ``mass`` and ``spin`` are plain floats; the radii are float64 and
    prograde.
    """

    mass: float
    spin: float

    @property
    def spin_ratio(self) -> float:
        return self.spin / self.mass

    def event_horizon(self) -> float:
        """r+ = M + sqrt(M^2 - a^2)."""
        m, a = float(self.mass), float(self.spin)
        return m + float(np.sqrt(max(m * m - a * a, 0.0)))

    def photon_sphere(self) -> float:
        """Equatorial circular photon orbit r_ph = 2M{1 + cos[(2/3) acos(-|a*|)]}."""
        a_star = abs(float(np.clip(self.spin_ratio, -1.0, 1.0)))
        return float(
            2.0 * self.mass * (1.0 + np.cos((2.0 / 3.0) * np.arccos(-a_star)))
        )

    def isco(self) -> float:
        """Bardeen-Press-Teukolsky innermost stable circular orbit."""
        a_star = abs(float(np.clip(self.spin_ratio, -1.0, 1.0)))
        z1 = 1.0 + np.cbrt(1.0 - a_star**2) * (
            np.cbrt(1.0 + a_star) + np.cbrt(1.0 - a_star)
        )
        z2 = np.sqrt(3.0 * a_star**2 + z1 * z1)
        root = np.sqrt(max((3.0 - z1) * (3.0 + z1 + 2.0 * z2), 0.0))
        return float(self.mass * (3.0 + z2 - root))
