"""Kerr-Schild geodesic step math in u = cos(theta) coordinates.

Counterpart of ``blackhole_simulation_tpu/ops/ks_kernel.py`` (``w_floor``
:253, ``_geom_u`` :287, ``ks_rhs_rows`` :382, ``ks_symplectic_step_rows``
:433, ``ks_renormalize_pr`` :465, ``ks_renormalize_u`` :369,
``theta_state_to_u`` / ``u_state_to_theta`` :270-285), and the
theta-form ``_geom`` (:36) and ``ks_hamiltonian`` (:50) on packed
(..., 8) states, which the march telemetry reads. With u = cos(theta) the
Hamiltonian

    H = 1/2 [ -(1+h) p_t^2 + 2 h p_t p_r + (D/S) p_r^2 + (2a/S) p_r p_phi
              + (w/S) p_u^2 + p_phi^2 / (S w) ],
    S = r^2 + a^2 u^2,  w = 1 - u^2,  h = 2 M r / S,  D = r^2 - 2 M r + a^2,

is rational, so the step has no trigonometry. The functions work on
unpacked rows of any shape; scalars (m, a, p_t) are 0-dim tensors or
numbers. The expressions and their order are the JAX twin's, and the render
kernel's device functions (``csrc/render.cu``) repeat them line for line.
"""

from __future__ import annotations

import torch

from blackhole_simulation_tpu_torch._elementwise import (
    arccos,
    clip,
    cos,
    maximum,
    sin,
    sqrt,
)

# The chart maps' floor for sin^2(theta) = 1 - u^2, in every dtype.
_W_EPS = 1e-12
_SIN2_EPS = 1e-12


def _geom(m, a, r, th):
    """(sin^2, sin 2theta, S, D, 1/S, h) at one theta-form point."""
    s = sin(th)
    c = cos(th)
    s2 = maximum(s * s, _SIN2_EPS)
    sin2t = 2.0 * s * c
    S = r * r + a * a * c * c
    D = r * r - 2.0 * m * r + a * a
    inv_S = 1.0 / S
    h = 2.0 * m * r * inv_S
    return s2, sin2t, S, D, inv_S, h


def ks_hamiltonian(m, a, y: torch.Tensor) -> torch.Tensor:
    """H of packed theta-form states y (..., 8) -> (...)."""
    r, th = y[..., 1], y[..., 2]
    pt, pr, pth, pph = y[..., 4], y[..., 5], y[..., 6], y[..., 7]
    s2, _, S, D, inv_S, h = _geom(m, a, r, th)
    return 0.5 * (
        -(1.0 + h) * pt * pt
        + 2.0 * h * pt * pr
        + D * inv_S * pr * pr
        + 2.0 * a * inv_S * pr * pph
        + pth * pth * inv_S
        + pph * pph * inv_S / s2
    )


def w_floor(dtype) -> float:
    """Pole guard floor for w = 1 - u^2: 1e-6 in float32 (so the 1/w^2 polar
    terms cannot overflow inside one implicit-midpoint step), 1e-12 in
    float64."""
    return 1e-12 if torch.finfo(dtype).bits >= 64 else 1e-6


def _geom_u(m, a, r, u):
    """(w, S, D, 1/S, h) at one evaluation point."""
    w = maximum(1.0 - u * u, w_floor(u.dtype))
    S = r * r + a * a * u * u
    D = r * r - 2.0 * m * r + a * a
    inv_S = 1.0 / S
    h = 2.0 * m * r * inv_S
    return w, S, D, inv_S, h


def ks_rhs_rows(m, a, r, u, pt, pr, pu, pph):
    """dy/dlambda on unpacked rows -> (dt, dr, du, dph, dpr, dpu); the
    conserved p_t and p_phi have zero derivative and are not returned.
    Divides exactly (the JAX twin's ``recip`` override, the approximate
    reciprocal, exists only in the kernel)."""
    w, S, D, inv_S, h = _geom_u(m, a, r, u)
    inv_S2 = inv_S * inv_S
    inv_w = 1.0 / w

    dt = -(1.0 + h) * pt + h * pr
    dr = h * pt + D * inv_S * pr + a * inv_S * pph
    du = w * inv_S * pu
    dph = a * inv_S * pr + pph * inv_S * inv_w

    S_r = 2.0 * r
    D_r = 2.0 * r - 2.0 * m
    h_r = 2.0 * m * (S - 2.0 * r * r) * inv_S2
    DS_r = (D_r * S - D * S_r) * inv_S2
    invS_r = -S_r * inv_S2
    wS_r = -w * S_r * inv_S2
    invSw_r = -S_r * inv_S2 * inv_w
    dH_dr = 0.5 * (
        -h_r * pt * pt
        + 2.0 * h_r * pt * pr
        + DS_r * pr * pr
        + 2.0 * a * invS_r * pr * pph
        + wS_r * pu * pu
        + invSw_r * pph * pph
    )

    S_u = 2.0 * a * a * u
    w_u = -2.0 * u
    h_u = -2.0 * m * r * S_u * inv_S2
    DS_u = -D * S_u * inv_S2
    invS_u = -S_u * inv_S2
    wS_u = (w_u * S - w * S_u) * inv_S2
    invSw_u = -(S_u * w + S * w_u) * inv_S2 * inv_w * inv_w
    dH_du = 0.5 * (
        -h_u * pt * pt
        + 2.0 * h_u * pt * pr
        + DS_u * pr * pr
        + 2.0 * a * invS_u * pr * pph
        + wS_u * pu * pu
        + invSw_u * pph * pph
    )
    return dt, dr, du, dph, -dH_dr, -dH_du


def ks_symplectic_step_rows(m, a, rows, dlam, iterations: int = 2):
    """Implicit-midpoint step on unpacked rows (t, r, u, ph, pt, pr, pu, pph):
    ``iterations`` fixed-point rounds from an explicit-Euler seed. Returns the
    six evolving rows (t, r, u, ph, pr, pu)."""
    t, r, u, ph, pt, pr, pu, pph = rows
    d = ks_rhs_rows(m, a, r, u, pt, pr, pu, pph)
    nt = t + dlam * d[0]
    nr = r + dlam * d[1]
    nu = u + dlam * d[2]
    nph = ph + dlam * d[3]
    npr = pr + dlam * d[4]
    npu = pu + dlam * d[5]
    for _ in range(iterations):
        d = ks_rhs_rows(
            m, a,
            0.5 * (r + nr), 0.5 * (u + nu),
            pt, 0.5 * (pr + npr), 0.5 * (pu + npu), pph,
        )
        nt = t + dlam * d[0]
        nr = r + dlam * d[1]
        nu = u + dlam * d[2]
        nph = ph + dlam * d[3]
        npr = pr + dlam * d[4]
        npu = pu + dlam * d[5]
    return nt, nr, nu, nph, npr, npu


def ks_renormalize_pr(m, a, r, u, pt, pr, pu, pph):
    """Project p_r onto the null shell H = 0: the root of the quadratic
    A p_r^2 + B p_r + C = 0 nearest the current p_r (unchanged where there
    is no real root). Always divides exactly."""
    w, S, D, inv_S, h = _geom_u(m, a, r, u)
    A = D * inv_S
    B = 2.0 * (h * pt + a * inv_S * pph)
    C = -(1.0 + h) * pt * pt + w * inv_S * pu * pu + pph * pph * inv_S / w
    disc = B * B - 4.0 * A * C
    valid = (disc >= 0.0) & (torch.abs(A) > 1e-12)
    sqrt_d = sqrt(torch.where(valid, maximum(disc, 1e-30), 1.0))
    denom = torch.where(valid, 2.0 * A, 1.0)
    sol1 = (-B + sqrt_d) / denom
    sol2 = (-B - sqrt_d) / denom
    nearest = torch.where(
        torch.abs(sol1 - pr) < torch.abs(sol2 - pr), sol1, sol2
    )
    return torch.where(valid, nearest, pr)


def ks_renormalize_u(m, a, yt):
    """ks_renormalize_pr on (8, N) u-chart rows: the rows with p_r (row 5)
    projected onto the null shell; differentiable (autograd)."""
    new_pr = ks_renormalize_pr(m, a, yt[1], yt[2], yt[4], yt[5], yt[6], yt[7])
    return torch.cat([yt[:5], new_pr[None], yt[6:]], dim=0)


def theta_state_to_u(yt: torch.Tensor) -> torch.Tensor:
    """(8, N) state rows with theta, p_theta -> u = cos(theta),
    p_u = -p_theta / sin(theta)."""
    c = cos(yt[2])
    s = sqrt(maximum(1.0 - c * c, _W_EPS))
    return torch.stack([yt[0], yt[1], c, yt[3], yt[4], yt[5], -yt[6] / s,
                        yt[7]])


def u_state_to_theta(yt: torch.Tensor) -> torch.Tensor:
    """(8, N) u-chart rows -> theta = arccos(u), p_theta = -p_u sin(theta)."""
    u = clip(yt[2], -1.0, 1.0)
    s = sqrt(maximum(1.0 - u * u, _W_EPS))
    return torch.stack([yt[0], yt[1], arccos(u), yt[3], yt[4], yt[5],
                        -yt[6] * s, yt[7]])
