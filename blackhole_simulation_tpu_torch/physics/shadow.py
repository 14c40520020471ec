"""Bardeen shadow (critical curve) and gravitational-lensing analytics, on
the host in float64 with numpy.

Counterpart of ``blackhole_simulation_tpu/physics/shadow.py``:
``shadow_critical_params`` (:26), ``schwarzschild_shadow_radius`` (:45),
``bardeen_shadow`` (:69, with ``_bardeen_half`` :51) and the lensing
helpers ``magnification``, ``magnification_point_lens`` and
``einstein_angle`` (:117-134). The critical curve is a handful of scalars
per frame: the render kernel reads it from its parameter row (the overlay
block) and the staged overlay from these arrays.
"""

from __future__ import annotations

import numpy as np


def photon_orbit_radius(m, a, prograde: bool = True):
    """Equatorial circular photon orbit 2M{1 + cos[(2/3) acos(-+|a*|)]}:
    the co-rotating orbit with ``prograde``, the counter-rotating one
    without."""
    a_star = np.abs(np.clip(a / m, -1.0, 1.0))
    sgn = -1.0 if prograde else 1.0
    return 2.0 * m * (1.0 + np.cos((2.0 / 3.0) * np.arccos(sgn * a_star)))


def shadow_critical_params(m, a, r):
    """Chandrasekhar critical impact parameters (xi, eta) of the spherical
    photon orbit at Boyer-Lindquist radius r, guarded for a -> 0 and
    r -> M."""
    a_safe = np.where(np.abs(a) < 1e-8, 1e-8, a)
    delta = r * r - 2.0 * m * r + a_safe * a_safe
    rm = np.where(np.abs(r - m) < 1e-12, 1e-12, r - m)
    xi = (m * (r * r - a_safe * a_safe) - r * delta) / (a_safe * rm)
    eta = r * r * r * (4.0 * a_safe * a_safe * m
                       - r * ((r - 3.0 * m) * (r - 3.0 * m))) / (
        a_safe * a_safe * rm * rm
    )
    return xi, eta


def schwarzschild_shadow_radius(m=1.0):
    """Critical impact parameter b_crit = 3 sqrt(3) M."""
    return 3.0 * np.sqrt(3.0) * np.asarray(m, np.float64)


def _bardeen_half(m, a, theta_obs, n):
    """(alpha, beta, beta^2) of the upper branch over n cosine-clustered
    radii between the prograde and retrograde photon orbits."""
    r_pro = photon_orbit_radius(m, a, prograde=True)
    r_ret = photon_orbit_radius(m, a, prograde=False)
    ts = 0.5 * (1.0 - np.cos(np.linspace(0.0, np.pi, n)))
    rs = r_pro + (r_ret - r_pro) * ts
    xi, eta = shadow_critical_params(m, a, rs)
    s = np.sin(theta_obs)
    c = np.cos(theta_obs)
    s_safe = np.maximum(np.abs(s), 1e-8)
    alpha = -xi / s_safe
    cs = c / s_safe
    beta_sq = eta + a * a * c * c - xi * xi * (cs * cs)
    beta = np.sqrt(np.maximum(beta_sq, 0.0))
    return alpha, beta, beta_sq


def bardeen_shadow(m=1.0, a=0.0, theta_obs=np.pi / 2, n: int = 32):
    """The shadow boundary on the observer's sky: float64 (alpha, beta) and
    bool ``valid``, each (2n,): the upper branch (+beta), then the reversed
    lower branch (-beta), a closed polyline. ``valid`` masks the points with
    beta^2 >= 0. For |a| < 1e-6 the analytic circle of radius 3 sqrt(3) M
    replaces the curve; seen down the spin axis (|sin(theta_obs)| < 0.05)
    the circle through the xi = 0 spherical orbit does."""
    m = float(m)
    a = float(a)
    theta_obs = float(theta_obs)
    alpha, beta, beta_sq = _bardeen_half(m, a, theta_obs, n)
    valid = beta_sq >= 0.0

    phi = np.linspace(0.0, np.pi, n)
    b0 = schwarzschild_shadow_radius(m)
    near_schw = abs(a) < 1e-6
    if near_schw:
        alpha = b0 * np.cos(phi)
        beta = b0 * np.sin(phi)
        valid = np.ones_like(valid)

    # Newton on r0^3 - 3M r0^2 + a^2 r0 + M a^2 = 0 (root -> 3M as a -> 0).
    r0 = 3.0 * m
    for _ in range(8):
        fval = r0 * r0 * r0 - 3.0 * m * (r0 * r0) + a * a * r0 + m * a * a
        fp = 3.0 * (r0 * r0) - 6.0 * m * r0 + a * a
        r0 = r0 - fval / fp
    _, eta0 = shadow_critical_params(m, a, np.float64(r0))
    b_axis = np.sqrt(np.maximum(eta0 + a * a, 0.0))
    on_axis = abs(np.sin(theta_obs)) < 0.05
    if on_axis and not near_schw:
        alpha = b_axis * np.cos(phi)
        beta = b_axis * np.sin(phi)
    if on_axis:
        valid = np.ones_like(valid)

    alpha_full = np.concatenate([alpha, alpha[::-1]])
    beta_full = np.concatenate([beta, -beta[::-1]])
    valid_full = np.concatenate([valid, valid[::-1]])
    return alpha_full, beta_full, valid_full


def magnification(solid_angle_image, solid_angle_source):
    """Lensing magnification as the solid-angle ratio."""
    return (np.asarray(solid_angle_image)
            / np.maximum(solid_angle_source, 1e-30))


def magnification_point_lens(u):
    """Point-lens total magnification (u^2 + 2) / (u sqrt(u^2 + 4)), u the
    angular separation in Einstein radii."""
    u_safe = np.maximum(np.abs(np.asarray(u, np.float64)), 1e-12)
    return (u_safe * u_safe + 2.0) / (u_safe * np.sqrt(u_safe * u_safe + 4.0))


def einstein_angle(m, d_l, d_s):
    """Einstein ring angle sqrt(4 M D_LS / (D_L D_S)), geometric units."""
    d_ls = d_s - d_l
    return np.sqrt(np.maximum(4.0 * m * d_ls / (d_l * d_s), 0.0))
