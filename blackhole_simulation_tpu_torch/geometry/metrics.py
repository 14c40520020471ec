"""Kerr metric: host scalars for the render prologue, and the tensor metrics
of the float64 oracle layer.

Counterpart of ``blackhole_simulation_tpu/geometry/metrics.py``.

Host and render side: the derived radii of ``Kerr`` (event horizon,
prograde photon sphere, ISCO, :235-265). ``Kerr``'s mass and spin are
numbers or 0-d tensors (a scene's data leaves, which may require grad, as
the JAX package's ``Scene`` leaves are differentiable); its methods compute
the radii of their values in float64 with numpy, for the host's static
decisions.
``event_horizon_t``, ``photon_sphere_t`` and ``isco_t`` compute the same
radii from 0-d tensors, differentiably in mass and spin, for the staged and
training paths: in the inputs' dtype, operation by operation as the JAX
package computes them from float32 mass and spin, with each square root,
arccos, cos and cube root evaluated in float64 and rounded once (the cube
root as ``x ** (1/3)`` on x >= 0, since torch has no cbrt).

Oracle side (tensors, batched over leading ray axes, any float dtype):
``kerr_sigma`` and ``kerr_delta`` (:58-67), ``kerr_cov_bl`` (:69), ``kerr_con_bl`` (:85), ``kerr_cov_ks`` (:102),
``kerr_con_ks`` (:124), ``hamiltonian_bl`` (:147), ``hamiltonian_ks``
(:166), and the metric classes ``KerrMetric``
(the JAX package's tensor ``Kerr``, :198-293, named apart from the host
``Kerr`` above), ``Schwarzschild`` (:296), ``Minkowski`` (:336) and
their union ``Metric`` (:369).

The JAX package's ``Kerr(mass, spin, chart)`` is the port's
``KerrMetric``; the port's ``Kerr`` is the render path's holder of the
scene's mass and spin, which every scene and render entry takes. The two
names part on purpose: the render path reads its leaves through
``_elementwise.leaf`` (arithmetic, keeping the graph) and ``host`` (static
decisions), and the radii that enter its arithmetic come from the tensor
functions above.

The JAX package takes (dH/dr, dH/dtheta) from ``jax.grad`` of the summed
Hamiltonian (``_ham_derivs`` :184). Here they are the closed forms of
``hamiltonian_ks`` / ``hamiltonian_bl`` (``*_flow``), evaluated together
with the contravariant momentum g^{mu nu} p_nu in one pass: no autograd in
a right-hand side. Where the pole clamp s2 = max(sin^2, 1e-12) holds, s2
has no theta derivative; at an exact tie it gets half, as ``jax.grad`` of
``jnp.maximum`` gives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import host as _host


@dataclasses.dataclass(frozen=True)
class Kerr:
    """Kerr black hole of mass M and angular momentum a = J/M (geometric units).

    ``mass`` and ``spin`` are numbers or 0-d tensors (which may require
    grad); the methods' radii are host float64 values of them, prograde.
    A tensor field hashes by identity, so no cache takes a ``Kerr``.
    """

    mass: float | torch.Tensor
    spin: float | torch.Tensor

    @property
    def spin_ratio(self) -> float:
        return _host(self.spin) / _host(self.mass)

    def event_horizon(self) -> float:
        """r+ = M + sqrt(M^2 - a^2)."""
        m, a = _host(self.mass), _host(self.spin)
        return m + float(np.sqrt(max(m * m - a * a, 0.0)))

    def photon_sphere(self) -> float:
        """Equatorial circular photon orbit r_ph = 2M{1 + cos[(2/3) acos(-|a*|)]}."""
        a_star = abs(float(np.clip(self.spin_ratio, -1.0, 1.0)))
        return float(
            2.0 * _host(self.mass)
            * (1.0 + np.cos((2.0 / 3.0) * np.arccos(-a_star)))
        )

    def isco(self) -> float:
        """Bardeen-Press-Teukolsky innermost stable circular orbit."""
        a_star = abs(float(np.clip(self.spin_ratio, -1.0, 1.0)))
        z1 = 1.0 + np.cbrt(1.0 - a_star**2) * (
            np.cbrt(1.0 + a_star) + np.cbrt(1.0 - a_star)
        )
        z2 = np.sqrt(3.0 * a_star**2 + z1 * z1)
        root = np.sqrt(max((3.0 - z1) * (3.0 + z1 + 2.0 * z2), 0.0))
        return float(_host(self.mass) * (3.0 + z2 - root))


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


def cauchy_horizon_t(mass, spin) -> torch.Tensor:
    """r- = M - sqrt(M^2 - a^2) from 0-d tensors."""
    m, a = _radii_args(mass, spin)
    return m - _round(torch.sqrt, torch.clamp(m * m - a * a, min=0.0))


def photon_sphere_t(mass, spin, prograde: bool = True) -> torch.Tensor:
    """Equatorial photon orbit 2M{1 + cos[(2/3) acos(-+|a*|)]} (prograde:
    co-rotating, the minus sign)."""
    m, a = _radii_args(mass, spin)
    a_star = _abs_spin_ratio(m, a)
    angle = (2.0 / 3.0) * _round(torch.arccos, -a_star if prograde else a_star)
    return 2.0 * m * (1.0 + _round(torch.cos, angle))


def isco_t(mass, spin, prograde: bool = True) -> torch.Tensor:
    """Bardeen-Press-Teukolsky ISCO from 0-d tensors
    M [3 + Z2 -+ sqrt((3 - Z1)(3 + Z1 + 2 Z2))] (minus: prograde)."""
    m, a = _radii_args(mass, spin)
    a_star = _abs_spin_ratio(m, a)
    z1 = 1.0 + _cbrt(1.0 - a_star * a_star) * (
        _cbrt(1.0 + a_star) + _cbrt(1.0 - a_star))
    z2 = _round(torch.sqrt, 3.0 * (a_star * a_star) + z1 * z1)
    root = _round(torch.sqrt, torch.clamp(
        (3.0 - z1) * (3.0 + z1 + 2.0 * z2), min=0.0))
    return m * (3.0 + z2 - root if prograde else 3.0 + z2 + root)


# ---------------------------------------------------------------------------
# Tensor metrics (the oracle layer)
# ---------------------------------------------------------------------------

BL = "bl"
KS = "ks"

_SIN2_EPS = 1e-12


def _sym4(rows) -> torch.Tensor:
    """A symmetric (..., 4, 4) tensor from its upper-triangle entries."""
    (tt, tr, tth, tph), (rr, rth, rph), (thth, thph), phph = rows
    return torch.stack([
        torch.stack([tt, tr, tth, tph], dim=-1),
        torch.stack([tr, rr, rth, rph], dim=-1),
        torch.stack([tth, rth, thth, thph], dim=-1),
        torch.stack([tph, rph, thph, phph], dim=-1),
    ], dim=-2)


def _angles(theta):
    """(sin, cos, s2 = max(sin^2, eps), d(s2)/d(theta)): the clamp passes no
    derivative where it holds and half of it at an exact tie."""
    s = torch.sin(theta)
    c = torch.cos(theta)
    ss = s * s
    s2 = torch.clamp(ss, min=_SIN2_EPS)
    d = 2.0 * s * c
    s2_th = torch.where(ss > _SIN2_EPS, d,
                        torch.where(ss == _SIN2_EPS, 0.5 * d, 0.0 * d))
    return s, c, s2, s2_th


def _zeros(r, *others):
    return torch.zeros(torch.broadcast_shapes(r.shape, *(o.shape for o in others)),
                       dtype=r.dtype, device=r.device)


def kerr_sigma(a, r, theta):
    """Sigma = r^2 + a^2 cos^2(theta)."""
    c = torch.cos(theta)
    return r * r + a * a * c * c


def kerr_delta(m, a, r):
    """Delta = r^2 - 2 M r + a^2."""
    return r * r - 2.0 * m * r + a * a


def kerr_cov_bl(m, a, r, theta) -> torch.Tensor:
    """Covariant Kerr metric, Boyer-Lindquist chart, (..., 4, 4) tensors."""
    s = torch.sin(theta)
    s2 = s * s
    c = torch.cos(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    two_mr = 2.0 * m * r
    z = _zeros(r, theta)
    g_tt = -(1.0 - two_mr / sig)
    g_tph = -two_mr * a * s2 / sig
    g_rr = sig / delta
    g_thth = sig + z
    g_phph = (r * r + a * a + two_mr * a * a * s2 / sig) * s2
    return _sym4([(g_tt + z, z, z, g_tph + z), (g_rr + z, z, z), (g_thth, z),
                  g_phph + z])


def kerr_con_bl(m, a, r, theta) -> torch.Tensor:
    """Contravariant Kerr metric, Boyer-Lindquist chart, (..., 4, 4)."""
    _, c, s2, _ = _angles(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    r2a2 = r * r + a * a
    big_a = r2a2 * r2a2 - a * a * delta * s2
    z = _zeros(r, theta)
    g_tt = -big_a / (sig * delta)
    g_tph = -2.0 * m * a * r / (sig * delta)
    g_rr = delta / sig
    g_thth = 1.0 / sig
    g_phph = (delta - a * a * s2) / (sig * delta * s2)
    return _sym4([(g_tt + z, z, z, g_tph + z), (g_rr + z, z, z),
                  (g_thth + z, z), g_phph + z])


def kerr_cov_ks(m, a, r, theta) -> torch.Tensor:
    """Covariant Kerr metric, Kerr-Schild ingoing chart: g = eta + 2H l l,
    H = M r / Sigma, l = (1, 1, 0, -a sin^2 theta)."""
    s = torch.sin(theta)
    s2 = s * s
    c = torch.cos(theta)
    sig = r * r + a * a * c * c
    h2 = 2.0 * m * r / sig
    z = _zeros(r, theta)
    g_tt = -1.0 + h2
    g_tr = h2
    g_tph = -h2 * a * s2
    g_rr = 1.0 + h2
    g_rph = -a * s2 * (1.0 + h2)
    g_thth = sig
    g_phph = s2 * (r * r + a * a + h2 * a * a * s2)
    return _sym4([(g_tt + z, g_tr + z, z, g_tph + z), (g_rr + z, z, g_rph + z),
                  (g_thth + z, z), g_phph + z])


def kerr_con_ks(m, a, r, theta) -> torch.Tensor:
    """Contravariant Kerr metric, Kerr-Schild ingoing chart: g^tt = -(1+2H),
    g^tr = 2H, g^rr = Delta/Sigma, g^rphi = a/Sigma, g^thth = 1/Sigma,
    g^phph = 1/(Sigma sin^2 theta); no Delta in a denominator."""
    _, c, s2, _ = _angles(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    h2 = 2.0 * m * r / sig
    z = _zeros(r, theta)
    g_tt = -(1.0 + h2)
    g_tr = h2
    g_rr = delta / sig
    g_rph = a / sig
    g_thth = 1.0 / sig
    g_phph = 1.0 / (sig * s2)
    return _sym4([(g_tt + z, g_tr + z, z, z), (g_rr + z, z, g_rph + z),
                  (g_thth + z, z), g_phph + z])


def hamiltonian_bl(m, a, r, theta, p) -> torch.Tensor:
    """H = 1/2 g^{mu nu} p_mu p_nu, BL chart, sparse. p: (..., 4)."""
    _, c, s2, _ = _angles(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    r2a2 = r * r + a * a
    big_a = r2a2 * r2a2 - a * a * delta * s2
    pt, pr, pth, pph = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    inv_sd = 1.0 / (sig * delta)
    return 0.5 * (
        -big_a * inv_sd * pt * pt
        - 4.0 * m * a * r * inv_sd * pt * pph
        + delta / sig * pr * pr
        + pth * pth / sig
        + (delta - a * a * s2) * inv_sd / s2 * pph * pph
    )


def hamiltonian_ks(m, a, r, theta, p) -> torch.Tensor:
    """H = 1/2 g^{mu nu} p_mu p_nu, KS chart, sparse. p: (..., 4)."""
    _, c, s2, _ = _angles(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    h2 = 2.0 * m * r / sig
    pt, pr, pth, pph = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return 0.5 * (
        -(1.0 + h2) * pt * pt
        + 2.0 * h2 * pt * pr
        + delta / sig * pr * pr
        + 2.0 * a / sig * pr * pph
        + pth * pth / sig
        + pph * pph / (sig * s2)
    )


def ks_flow(m, a, r, theta, p):
    """Hamilton's equations in the KS chart, closed form: (dx (..., 4) =
    g^{mu nu} p_nu, dH/dr, dH/dtheta) of ``hamiltonian_ks``."""
    s, c, s2, s2_th = _angles(theta)
    pt, pr, pth, pph = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    inv = 1.0 / sig
    inv2 = inv * inv
    h2 = 2.0 * m * r * inv
    inv_s2 = 1.0 / s2
    dx = torch.stack([
        -(1.0 + h2) * pt + h2 * pr,
        h2 * pt + delta * inv * pr + a * inv * pph,
        pth * inv,
        a * inv * pr + pph * inv * inv_s2,
    ], dim=-1)
    sig_r = 2.0 * r
    sig_th = -2.0 * a * a * c * s
    delta_r = 2.0 * r - 2.0 * m
    h2_r = 2.0 * m * (sig - r * sig_r) * inv2
    h2_th = -2.0 * m * r * sig_th * inv2
    quad = (pt * pt, pt * pr, pr * pr, pr * pph, pth * pth, pph * pph)

    def d_h(h2_x, ds_x, sig_x, s2_x):
        return 0.5 * (
            -h2_x * quad[0]
            + 2.0 * h2_x * quad[1]
            + ds_x * quad[2]
            - 2.0 * a * sig_x * inv2 * quad[3]
            - sig_x * inv2 * quad[4]
            - (sig_x * s2 + sig * s2_x) * (inv2 * inv_s2 * inv_s2) * quad[5]
        )

    dh_dr = d_h(h2_r, (delta_r * sig - delta * sig_r) * inv2, sig_r, 0.0 * s2)
    dh_dth = d_h(h2_th, -delta * sig_th * inv2, sig_th, s2_th)
    return dx, dh_dr, dh_dth


def bl_flow(m, a, r, theta, p):
    """Hamilton's equations in the BL chart, closed form: (dx (..., 4),
    dH/dr, dH/dtheta) of ``hamiltonian_bl``."""
    s, c, s2, s2_th = _angles(theta)
    pt, pr, pth, pph = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    r2a2 = r * r + a * a
    big_a = r2a2 * r2a2 - a * a * delta * s2
    big_p = sig * delta
    inv_p = 1.0 / big_p
    inv_sig = 1.0 / sig
    num5 = delta - a * a * s2
    den5 = big_p * s2
    dx = torch.stack([
        -big_a * inv_p * pt - 2.0 * m * a * r * inv_p * pph,
        delta * inv_sig * pr,
        pth * inv_sig,
        -2.0 * m * a * r * inv_p * pt + num5 / den5 * pph,
    ], dim=-1)
    sig_r = 2.0 * r
    sig_th = -2.0 * a * a * c * s
    delta_r = 2.0 * r - 2.0 * m
    p_r = sig_r * delta + sig * delta_r
    p_th = sig_th * delta
    a_r = 4.0 * r * r2a2 - a * a * delta_r * s2
    a_th = -a * a * delta * s2_th
    inv_p2 = inv_p * inv_p
    quad = (pt * pt, pt * pph, pr * pr, pth * pth, pph * pph)

    def d_h(a_x, p_x, mar_x, ds_x, sig_x, num_x, s2_x):
        den_x = p_x * s2 + big_p * s2_x
        return 0.5 * (
            -(a_x * big_p - big_a * p_x) * inv_p2 * quad[0]
            - 4.0 * m * a * mar_x * quad[1]
            + ds_x * quad[2]
            - sig_x * inv_sig * inv_sig * quad[3]
            + (num_x * den5 - num5 * den_x) / (den5 * den5) * quad[4]
        )

    zero = 0.0 * s2
    dh_dr = d_h(a_r, p_r, (big_p - r * p_r) * inv_p2,
                (delta_r * sig - delta * sig_r) * inv_sig * inv_sig, sig_r,
                delta_r + zero, zero)
    dh_dth = d_h(a_th, p_th, -r * p_th * inv_p2,
                 -delta * sig_th * inv_sig * inv_sig, sig_th,
                 -a * a * s2_th, s2_th)
    return dx, dh_dr, dh_dth


def _as_tensor(x, dtype=None, device=None):
    if torch.is_tensor(x):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    return torch.tensor(x, dtype=dtype or torch.float64, device=device)


@dataclasses.dataclass(frozen=True)
class KerrMetric:
    """Kerr black hole of mass M and spin a = J/M as 0-d tensors, in the
    Boyer-Lindquist (``BL``) or ingoing Kerr-Schild (``KS``) chart: the
    JAX package's tensor ``Kerr``. Everything broadcasts over leading ray
    axes."""

    mass: torch.Tensor
    spin: torch.Tensor
    chart: str = BL

    @classmethod
    def create(cls, mass, spin, chart=BL, dtype=torch.float64, device=None):
        return cls(mass=_as_tensor(mass, dtype, device),
                   spin=_as_tensor(spin, dtype, device), chart=chart)

    def covariant(self, r, theta):
        fn = kerr_cov_bl if self.chart == BL else kerr_cov_ks
        return fn(self.mass, self.spin, r, theta)

    def contravariant(self, r, theta):
        fn = kerr_con_bl if self.chart == BL else kerr_con_ks
        return fn(self.mass, self.spin, r, theta)

    def hamiltonian(self, r, theta, p):
        fn = hamiltonian_bl if self.chart == BL else hamiltonian_ks
        return fn(self.mass, self.spin, r, theta, p)

    def flow(self, r, theta, p):
        """(g^{mu nu} p_nu, dH/dr, dH/dtheta), closed form."""
        fn = bl_flow if self.chart == BL else ks_flow
        return fn(self.mass, self.spin, r, theta, p)

    def hamiltonian_derivatives(self, r, theta, p):
        """(dH/dr, dH/dtheta), closed form."""
        return self.flow(r, theta, p)[1:]

    def with_chart(self, chart: str) -> "KerrMetric":
        return dataclasses.replace(self, chart=chart)

    @property
    def spin_ratio(self):
        return self.spin / self.mass

    def event_horizon(self):
        return event_horizon_t(self.mass, self.spin)

    def cauchy_horizon(self):
        return cauchy_horizon_t(self.mass, self.spin)

    def photon_sphere(self, prograde: bool = True):
        return photon_sphere_t(self.mass, self.spin, prograde)

    def isco(self, prograde: bool = True):
        return isco_t(self.mass, self.spin, prograde)

    def _t(self, x):
        """A number or tensor as a tensor of the metric's dtype and device."""
        return torch.as_tensor(x, dtype=self.mass.dtype,
                               device=self.mass.device)

    def ergosphere(self, theta):
        """Outer ergosurface M + sqrt(M^2 - a^2 cos^2 theta)."""
        c = torch.cos(self._t(theta))
        return self.mass + torch.sqrt(torch.clamp(
            self.mass**2 - self.spin**2 * c * c, min=0.0))

    def frame_dragging(self, r, theta):
        """ZAMO angular velocity 2 M a r / A."""
        r = self._t(r)
        s = torch.sin(self._t(theta))
        s2 = s * s
        delta = r * r - 2.0 * self.mass * r + self.spin**2
        r2a2 = r * r + self.spin**2
        big_a = r2a2 * r2a2 - self.spin**2 * delta * s2
        return 2.0 * self.mass * self.spin * r / big_a

    def keplerian_omega(self, r, prograde: bool = True):
        """Circular equatorial orbit +-M^(1/2) / (r^(3/2) +- a M^(1/2))."""
        r = self._t(r)
        sqm = torch.sqrt(self.mass)
        sgn = 1.0 if prograde else -1.0
        return sgn * sqm / (r ** 1.5 + sgn * self.spin * sqm)

    def time_dilation(self, r, theta):
        """Static-observer lapse sqrt(1 - 2Mr/Sigma), clipped at 0."""
        r = self._t(r)
        c = torch.cos(self._t(theta))
        sig = r * r + self.spin * self.spin * c * c
        return torch.sqrt(torch.clamp(1.0 - 2.0 * self.mass * r / sig, min=0.0))


@dataclasses.dataclass(frozen=True)
class Schwarzschild:
    """Schwarzschild (a = 0) metric; ``mass`` a 0-d tensor."""

    mass: torch.Tensor

    @classmethod
    def create(cls, mass, dtype=torch.float64, device=None):
        return cls(mass=_as_tensor(mass, dtype, device))

    def covariant(self, r, theta):
        f = 1.0 - 2.0 * self.mass / r
        s = torch.sin(theta)
        z = _zeros(r, theta)
        return _sym4([(-f + z, z, z, z), (1.0 / f + z, z, z), (r * r + z, z),
                      r * r * s * s + z])

    def contravariant(self, r, theta):
        f = 1.0 - 2.0 * self.mass / r
        s2 = torch.clamp(torch.sin(theta) ** 2, min=_SIN2_EPS)
        z = _zeros(r, theta)
        return _sym4([(-1.0 / f + z, z, z, z), (f + z, z, z),
                      (1.0 / (r * r) + z, z), 1.0 / (r * r * s2) + z])

    def hamiltonian(self, r, theta, p):
        return hamiltonian_bl(self.mass, torch.zeros_like(self.mass), r,
                              theta, p)

    def flow(self, r, theta, p):
        """g^{mu nu} p_nu from this metric's own components (its 1 / f
        form), and (dH/dr, dH/dtheta) of ``hamiltonian_bl`` at a = 0."""
        _, dh_dr, dh_dth = bl_flow(self.mass, torch.zeros_like(self.mass), r,
                                   theta, p)
        f = 1.0 - 2.0 * self.mass / r
        s2 = torch.clamp(torch.sin(theta) ** 2, min=_SIN2_EPS)
        pt, pr, pth, pph = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
        dx = torch.stack([-1.0 / f * pt, f * pr, 1.0 / (r * r) * pth,
                          1.0 / (r * r * s2) * pph], dim=-1)
        return dx, dh_dr, dh_dth

    def hamiltonian_derivatives(self, r, theta, p):
        return self.flow(r, theta, p)[1:]

    def event_horizon(self):
        return 2.0 * self.mass

    def photon_sphere(self, prograde: bool = True):
        return 3.0 * self.mass

    def isco(self, prograde: bool = True):
        return 6.0 * self.mass

    def time_dilation(self, r, theta=None):
        return torch.sqrt(torch.clamp(1.0 - 2.0 * self.mass / r, min=0.0))


@dataclasses.dataclass(frozen=True)
class Minkowski:
    """Flat spacetime in spherical coordinates."""

    def covariant(self, r, theta):
        s = torch.sin(theta)
        z = _zeros(r, theta)
        one = z + 1.0
        return _sym4([(-one, z, z, z), (one, z, z), (r * r + z, z),
                      r * r * s * s + z])

    def contravariant(self, r, theta):
        s2 = torch.clamp(torch.sin(theta) ** 2, min=_SIN2_EPS)
        z = _zeros(r, theta)
        one = z + 1.0
        return _sym4([(-one, z, z, z), (one, z, z), (1.0 / (r * r) + z, z),
                      1.0 / (r * r * s2) + z])

    def hamiltonian(self, r, theta, p):
        g = self.contravariant(r, theta)
        return 0.5 * torch.einsum("...ij,...i,...j->...", g, p, p)

    def flow(self, r, theta, p):
        _, _, s2, s2_th = _angles(theta)
        pt, pr, pth, pph = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
        inv_r2 = 1.0 / (r * r)
        dx = torch.stack([-pt, pr + 0.0 * pt, pth * inv_r2,
                          pph * inv_r2 / s2], dim=-1)
        dh_dr = -(pth * pth + pph * pph / s2) * inv_r2 / r
        dh_dth = -0.5 * s2_th * pph * pph * inv_r2 / (s2 * s2)
        return dx, dh_dr, dh_dth

    def hamiltonian_derivatives(self, r, theta, p):
        return self.flow(r, theta, p)[1:]

    def event_horizon(self):
        return torch.zeros((), dtype=torch.float64)


# Any of the tensor metrics (the JAX package's ``Metric``, :369, whose
# ``Kerr`` is the port's ``KerrMetric``).
Metric = KerrMetric | Schwarzschild | Minkowski
