"""The analytic Bardeen shadow-curve overlay of the staged render.

Counterpart of ``blackhole_simulation_tpu/render/overlay.py``:
``pixel_celestial_coords`` (:29), ``_polyline_distance_sq`` (:59) and
``shadow_overlay`` (:88). Each pixel's ray carries the conserved
(lambda, eta); mapped to Bardeen celestial coordinates at the observer's
inclination,

    alpha = -lambda / sin(theta_0)
    beta  = +-sqrt(eta + a^2 cos^2(theta_0) - lambda^2 cot^2(theta_0)),

a pixel lies on the shadow's edge where (alpha, beta) lies on the critical
curve (``physics/shadow.bardeen_shadow``), and the line's weight falls off
with the squared distance to that polyline. The render kernel draws the
same line from its parameter row; ``render`` calls this on the staged path
only, as the JAX package does.
"""

from __future__ import annotations

import torch

from blackhole_simulation_tpu_torch._elementwise import (
    clip,
    const,
    cos,
    exp,
    maximum,
    sin,
    sqrt,
)


def pixel_celestial_coords(y0: torch.Tensor, a, theta_obs):
    """Per-ray Bardeen (alpha, beta, beta^2 deficit) from (N, 8) theta-form
    states at the camera (``camera_rays``). beta's sign follows -p_theta;
    where beta^2 < 0 beta folds to 0 and the deficit |beta^2| is returned,
    to be added to the squared distance. ``theta_obs``: a number or a 0-d
    tensor, rounded to the rows' dtype."""
    a = torch.as_tensor(a, dtype=y0.dtype, device=y0.device)
    th = y0[:, 2]
    pt, pth, pph = y0[:, 4], y0[:, 6], y0[:, 7]
    e = -pt
    inv_e = 1.0 / torch.where(torch.abs(e) < 1e-12, 1.0, e)
    lam = pph * inv_e
    sth = sin(th)
    s2 = maximum(sth * sth, 1e-12)
    cth = cos(th)
    c2 = cth * cth
    q = pth * pth + c2 * (pph * pph / s2 - a * a * pt * pt)
    eta = q * inv_e * inv_e

    th0 = (theta_obs.to(y0.dtype) if isinstance(theta_obs, torch.Tensor)
           else const(y0, float(theta_obs)))
    s0 = sin(th0)
    c0 = cos(th0)
    s0 = torch.where(torch.abs(s0) < 1e-6, 1e-6, s0)
    alpha = -lam / s0
    cs = c0 / s0
    beta_sq = eta + a * a * c0 * c0 - lam * lam * (cs * cs)
    beta = torch.sign(-pth) * sqrt(maximum(beta_sq, 0.0))
    deficit = maximum(-beta_sq, 0.0)
    return alpha, beta, deficit


def _polyline_distance_sq(px, py, deficit, cx, cy, valid):
    """Least squared distance from the points (px, py) to the closed
    polyline (cx, cy) (K,), skipping the segments with an invalid
    endpoint (``valid``: host bools), plus the beta^2 deficit."""
    k = cx.shape[0]
    dmin = torch.full_like(px, 1e30)
    for i in range(k):
        j = (i + 1) % k
        if not (valid[i] and valid[j]):
            continue   # min(dmin, 1e30) leaves dmin as it is
        ax, ay, bx, by = cx[i], cy[i], cx[j], cy[j]
        dx, dy = bx - ax, by - ay
        len_sq = dx * dx + dy * dy
        t = ((px - ax) * dx + (py - ay) * dy) / maximum(len_sq, 1e-20)
        t = clip(t, 0.0, 1.0)
        ex = px - (ax + t * dx)
        ey = py - (ay + t * dy)
        dmin = torch.minimum(dmin, ex * ex + ey * ey)
    return dmin + deficit


def shadow_overlay(radiance: torch.Tensor, y0: torch.Tensor, m, a,
                   theta_obs, n_pts: int = 32, line_width=None,
                   color=(0.15, 1.0, 0.35), gain: float = 1.2) -> torch.Tensor:
    """Add the analytic critical curve to (N, 3) linear radiance, in the
    rays' dtype (the JAX twin's ``dtype``: float32, or float64).

    ``y0``: (N, 8) theta-form camera rays; ``m``, ``a``: 0-d tensors of
    the rays' dtype; ``theta_obs``: a number or a 0-d tensor; ``line_width``: the
    Gaussian half-width in impact-parameter units (0.06 M when None; the
    pipeline passes ~1.5 pixels' worth). Differentiable in the rows, m, a,
    theta_obs and the width: the curve is ``bardeen_shadow_t``'s, float64
    rounded to the rays' dtype as the JAX twin's."""
    from blackhole_simulation_tpu_torch.physics.shadow import bardeen_shadow_t

    m = torch.as_tensor(m, dtype=y0.dtype, device=y0.device)
    if line_width is None:
        line_width = 0.06 * m
    alpha_c, beta_c, valid = bardeen_shadow_t(m, a, theta_obs, n_pts)
    px, py, deficit = pixel_celestial_coords(y0, a, theta_obs)
    d_sq = _polyline_distance_sq(px, py, deficit,
                                 alpha_c.to(y0.device, y0.dtype),
                                 beta_c.to(y0.device, y0.dtype),
                                 valid.tolist())
    w = torch.as_tensor(line_width, dtype=y0.dtype, device=y0.device)
    weight = gain * exp(-d_sq / maximum(w * w, 1e-12))
    tint = torch.tensor(color, dtype=y0.dtype, device=y0.device)
    return radiance + weight[:, None] * tint[None, :]
