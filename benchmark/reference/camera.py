"""Camera rays (frozen from the port's ``render/camera.py``): the ZAMO
tetrad lowered to Kerr-Schild, pinhole pixel directions with a sub-pixel
jitter, u-chart rows normalized to p_t = -1 and projected onto the null
shell. The tetrad is computed in the dtype of mass, spin and theta."""

from __future__ import annotations

import math

import torch

from benchmark.reference.geodesic import renormalize_pr
from benchmark.reference.numerics import const, cos, div_c, sin, sqrt


def _tetrad(m, a, r, theta):
    s = sin(theta)
    s2 = torch.clamp(s * s, min=1e-12)
    c = cos(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    r2a2 = r * r + a * a
    big_a = r2a2 * r2a2 - a * a * delta * s2
    alpha = sqrt(torch.clamp(delta * sig / big_a, min=1e-30))
    omega = 2.0 * m * a * r / big_a
    return ([1.0 / alpha, None, None, omega / alpha],
            [None, sqrt(torch.clamp(delta / sig, min=1e-30)), None, None],
            [None, None, 1.0 / sqrt(sig), None],
            [None, None, None,
             sqrt(torch.clamp(sig / big_a, min=1e-30)) / sqrt(s2)])


def _lower(m, a, r, theta, v):
    s = sin(theta)
    s2 = s * s
    c = cos(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    two_mr = 2.0 * m * r
    g_tt = -(1.0 - two_mr / sig)
    g_tph = -two_mr * a * s2 / sig
    g_rr = sig / delta
    g_thth = sig
    g_phph = (r * r + a * a + two_mr * a * a * s2 / sig) * s2
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    vt, vr, vth, vph = (zero if x is None else x for x in v)
    p = [g_tt * vt + g_tph * vph, g_rr * vr, g_thth * vth,
         g_tph * vt + g_phph * vph]
    p[1] = p[1] + (-(2.0 * m * r / delta) * p[0] - (a / delta) * p[3])
    return p


def camera_scalars(m, a, theta, r0: float, fov: float, width: int,
                   height: int):
    """(c0, c_r, c_th, c_ph, k1, k2, roll_c, roll_s) for 0-d tensors m, a,
    theta of one dtype (no roll)."""
    dt, dev = m.dtype, m.device
    r = torch.tensor(r0, dtype=torch.float64, device=dev).to(dt)
    coeffs = [torch.stack(_lower(m, a, r, theta, v))
              for v in _tetrad(m, a, r, theta)]
    num = lambda x: torch.tensor(x, dtype=torch.float64, device=dev).to(dt)
    half = num(math.tan(fov / 2.0))
    return (*coeffs, half * num(width / height), half, num(1.0), num(0.0))


def rays(m, a, theta, cam: dict, pix_ids: torch.Tensor, jitter=(0.0, 0.0)):
    """(8, N) u-chart rows of the row-major pixel ids, null-projected;
    ``jitter`` a pair of numbers or of (N,) tensors, rounded to the rows'
    dtype.
    ``cam``: r, phi, fov, width, height; ``theta`` a 0-d tensor (may carry
    a gradient): the tetrad takes it in the rows' dtype, cos theta and
    sin theta of the birth point in its own (float64 for a camera's
    number, as a parameter row forms them)."""
    dt = m.dtype
    w, h = cam["width"], cam["height"]
    c0, c_r, c_th, c_ph, k1, k2, roll_c, roll_s = camera_scalars(
        m, a, theta.to(dt), cam["r"], cam["fov"], w, h)
    ix = (pix_ids % w).to(dt)
    iy = (pix_ids // w).to(dt)
    jx, jy = (torch.as_tensor(j, device=m.device).to(dt) for j in jitter)
    nx = div_c(ix + 0.5 + jx, float(w)) * 2.0 - 1.0
    ny = 1.0 - div_c(iy + 0.5 + jy, float(h)) * 2.0
    cx, cy = nx * k1, ny * k2
    cx, cy = cx * roll_c - cy * roll_s, cx * roll_s + cy * roll_c
    inv_norm = 1.0 / sqrt(1.0 + cx * cx + cy * cy)
    n_r, n_th, n_ph = -inv_norm, -cy * inv_norm, -cx * inv_norm
    p = [c0[j] + n_r * c_r[j] + n_th * c_th[j] + n_ph * c_ph[j]
         for j in range(4)]
    inv = 1.0 / (-p[0])
    ct = cos(theta)
    u0 = ct.to(dt)
    s0 = sqrt(torch.clamp(1.0 - ct * ct, min=1e-12)).to(dt)
    zero = torch.zeros_like(nx)
    r = zero + torch.tensor(cam["r"], dtype=dt, device=m.device)
    u = zero + u0
    pt = zero - 1.0
    pr, pu, pph = p[1] * inv, -(p[2] * inv) / s0, p[3] * inv
    pr = renormalize_pr(m, a, r, u, pt, pr, pu, pph)
    phi = zero + torch.tensor(cam.get("phi", 0.0), dtype=dt, device=m.device)
    return torch.stack([zero, r, u, phi, pt, pr, pu, pph])


def conserved_lam(rows: torch.Tensor) -> torch.Tensor:
    """L_z / E = -p_phi / p_t."""
    return -rows[7] / torch.where(torch.abs(rows[4]) < 1e-12,
                                  const(rows[4], -1.0), rows[4])
