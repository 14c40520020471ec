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


def bardeen_shadow_t(m, a, theta_obs, n: int = 32):
    """``bardeen_shadow`` with the derivatives of the curve: float64
    tensors (alpha, beta) and the numpy ``valid``, for ``m``, ``a`` and
    ``theta_obs`` numbers or 0-d tensors (which may require grad). The
    values are ``bardeen_shadow``'s, bit for bit; each point takes the
    derivative of its branch (the general curve, the a ~ 0 circle or the
    on-axis circle) as the JAX twin's jnp.where selects it
    (``_elementwise.attach`` of a float64 torch twin)."""
    import torch

    from blackhole_simulation_tpu_torch._elementwise import attach, host, leaf
    from blackhole_simulation_tpu_torch.geometry.metrics import (
        photon_sphere_t,
    )

    alpha_h, beta_h, valid = bardeen_shadow(host(m), host(a),
                                            host(theta_obs), n)
    dev = next((x.device for x in (m, a, theta_obs)
                if isinstance(x, torch.Tensor)), None)
    m, a, th = (leaf(x, torch.float64, dev) for x in (m, a, theta_obs))
    phi = torch.as_tensor(np.linspace(0.0, np.pi, n), device=dev)
    near_schw = abs(host(a)) < 1e-6
    on_axis = abs(np.sin(host(theta_obs))) < 0.05
    if near_schw:
        b0 = 3.0 * np.sqrt(3.0) * m
        alpha, beta = b0 * torch.cos(phi), b0 * torch.sin(phi)
    elif on_axis:
        r0 = 3.0 * m
        for _ in range(8):
            fval = r0 * r0 * r0 - 3.0 * m * (r0 * r0) + a * a * r0 + m * a * a
            fp = 3.0 * (r0 * r0) - 6.0 * m * r0 + a * a
            r0 = r0 - fval / fp
        _, eta0 = _critical_t(m, a, r0)
        b_axis = torch.sqrt(torch.clamp(eta0 + a * a, min=0.0))
        alpha, beta = b_axis * torch.cos(phi), b_axis * torch.sin(phi)
    else:
        r_pro = photon_sphere_t(m, a, prograde=True)
        r_ret = photon_sphere_t(m, a, prograde=False)
        ts = torch.as_tensor(0.5 * (1.0 - np.cos(np.linspace(0.0, np.pi, n))),
                             device=dev)
        xi, eta = _critical_t(m, a, r_pro + (r_ret - r_pro) * ts)
        s, c = torch.sin(th), torch.cos(th)
        s_safe = torch.clamp(torch.abs(s), min=1e-8)
        alpha = -xi / s_safe
        cs = c / s_safe
        beta = torch.sqrt(torch.clamp(eta + a * a * c * c - xi * xi * (cs * cs),
                                      min=0.0))
    alpha_t = torch.cat([alpha, alpha.flip(0)])
    beta_t = torch.cat([beta, -beta.flip(0)])
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)
    return attach(f64(alpha_h), alpha_t), attach(f64(beta_h), beta_t), valid


def _critical_t(m, a, r):
    """``shadow_critical_params`` on tensors (away from its guards)."""
    delta = r * r - 2.0 * m * r + a * a
    rm = r - m
    xi = (m * (r * r - a * a) - r * delta) / (a * rm)
    eta = r * r * r * (4.0 * a * a * m - r * ((r - 3.0 * m) * (r - 3.0 * m))) / (
        a * a * rm * rm)
    return xi, eta


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
