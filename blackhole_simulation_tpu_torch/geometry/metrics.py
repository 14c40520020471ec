"""Kerr metric pieces the render prologue needs.

Counterpart of ``blackhole_simulation_tpu/geometry/metrics.py``: the
Boyer-Lindquist covariant metric at one point (``kerr_cov_bl``) and the
derived radii of ``Kerr`` (event horizon, prograde photon sphere, ISCO,
:235-265). ``Kerr`` holds host floats and computes the radii in float64 with
numpy, once per frame. ``event_horizon_t``, ``photon_sphere_t`` and
``isco_t`` compute the same radii from 0-d tensors, differentiably in mass
and spin, for the staged and training paths: in the inputs' dtype,
operation by operation as the JAX package computes them from float32 mass
and spin, with each square root, arccos, cos and cube root evaluated in
float64 and rounded once (the cube root as ``x ** (1/3)`` on x >= 0, since
torch has no cbrt).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def _radii_args(mass, spin):
    m = torch.as_tensor(mass)
    a = torch.as_tensor(spin)
    dt = torch.promote_types(m.dtype, a.dtype)
    return m.to(dt), a.to(dt)


def _round(fn, x):
    """fn(x) computed in float64 and rounded once to x's dtype."""
    return fn(x.double()).to(x.dtype)


def _cbrt(x):
    """Cube root of x >= 0 (torch has no cbrt)."""
    return _round(lambda v: torch.clamp(v, min=0.0) ** (1.0 / 3.0), x)


def event_horizon_t(mass, spin) -> torch.Tensor:
    """r+ = M + sqrt(M^2 - a^2) from 0-d tensors (differentiable)."""
    m, a = _radii_args(mass, spin)
    return m + _round(torch.sqrt, torch.clamp(m * m - a * a, min=0.0))


def _abs_spin_ratio(m, a):
    return torch.abs(torch.clamp(a / m, -1.0, 1.0))


def photon_sphere_t(mass, spin) -> torch.Tensor:
    """Prograde equatorial photon orbit 2M{1 + cos[(2/3) acos(-|a*|)]}."""
    m, a = _radii_args(mass, spin)
    a_star = _abs_spin_ratio(m, a)
    angle = (2.0 / 3.0) * _round(torch.arccos, -a_star)
    return 2.0 * m * (1.0 + _round(torch.cos, angle))


def isco_t(mass, spin) -> torch.Tensor:
    """Prograde Bardeen-Press-Teukolsky ISCO from 0-d tensors."""
    m, a = _radii_args(mass, spin)
    a_star = _abs_spin_ratio(m, a)
    z1 = 1.0 + _cbrt(1.0 - a_star * a_star) * (
        _cbrt(1.0 + a_star) + _cbrt(1.0 - a_star))
    z2 = _round(torch.sqrt, 3.0 * (a_star * a_star) + z1 * z1)
    root = _round(torch.sqrt, torch.clamp(
        (3.0 - z1) * (3.0 + z1 + 2.0 * z2), min=0.0))
    return m * (3.0 + z2 - root)
