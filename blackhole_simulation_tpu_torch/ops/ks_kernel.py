"""Kerr-Schild geodesic step math: the u = cos(theta) forms of the march,
and the theta forms on packed and transposed states.

Counterpart of ``blackhole_simulation_tpu/ops/ks_kernel.py``, every public
function of it:

* theta form, packed (..., 8) states: ``_geom`` (:36), ``ks_hamiltonian``
  (:50, the march telemetry reads it), ``ks_rhs`` (:64), ``ks_renormalize``
  (:123) and ``ks_symplectic_step`` (:148);
* theta form, transposed (8, N) rows: ``ks_rhs_t`` (:169),
  ``ks_renormalize_t`` (:222) and ``ks_symplectic_step_t`` (:243);
* u form, the march's: ``w_floor`` (:253), ``set_row`` (:263),
  ``theta_state_to_u`` / ``u_state_to_theta`` (:270-285), ``_geom_u``
  (:287), ``ks_hamiltonian_u`` (:299), ``ks_rhs_u`` (:314),
  ``ks_renormalize_u`` (:369), ``ks_rhs_rows`` (:382),
  ``ks_symplectic_step_rows`` (:433), ``ks_renormalize_pr`` (:465) and
  ``ks_symplectic_step_u`` (:484).

With u = cos(theta) the Hamiltonian

    H = 1/2 [ -(1+h) p_t^2 + 2 h p_t p_r + (D/S) p_r^2 + (2a/S) p_r p_phi
              + (w/S) p_u^2 + p_phi^2 / (S w) ],
    S = r^2 + a^2 u^2,  w = 1 - u^2,  h = 2 M r / S,  D = r^2 - 2 M r + a^2,

is rational, so the step has no trigonometry. The functions work on
unpacked rows of any shape; scalars (m, a, p_t) are 0-dim tensors or
numbers. The expressions and their order are the JAX twin's, and the render
kernel's device functions (``csrc/render.cu``) repeat them line for line.
``recip``, where a function takes it, replaces the two reciprocals 1/S and
1/w (the JAX twin's hook for the approximate reciprocal); the default
divides exactly. The theta forms' sin and cos round once from float64.
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


def _rhs_theta(m, a, r, th, pt, pr, pth, pph):
    """(dt, dr, dth, dph, -dH/dr, -dH/dth) of the theta form: g^{mu nu}
    p_nu and the closed-form Hamiltonian derivatives (the JAX twin's
    ``ks_rhs`` body, :64-120)."""
    s2, sin2t, S, D, inv_S, h = _geom(m, a, r, th)
    inv_S2 = inv_S * inv_S

    dt = -(1.0 + h) * pt + h * pr
    dr = h * pt + D * inv_S * pr + a * inv_S * pph
    dth = pth * inv_S
    dph = a * inv_S * pr + pph * inv_S / s2

    S_r = 2.0 * r
    D_r = 2.0 * r - 2.0 * m
    h_r = 2.0 * m * (S - 2.0 * r * r) * inv_S2
    DS_r = (D_r * S - D * S_r) * inv_S2
    invS_r = -S_r * inv_S2
    invSs2_r = -S_r * inv_S2 / s2
    dH_dr = 0.5 * (
        -h_r * pt * pt
        + 2.0 * h_r * pt * pr
        + DS_r * pr * pr
        + 2.0 * a * invS_r * pr * pph
        + invS_r * pth * pth
        + invSs2_r * pph * pph
    )

    S_th = -(a * a) * sin2t
    h_th = -2.0 * m * r * S_th * inv_S2
    DS_th = -D * S_th * inv_S2
    invS_th = -S_th * inv_S2
    invSs2_th = -(S_th * s2 + S * sin2t) * inv_S2 / (s2 * s2)
    dH_dth = 0.5 * (
        -h_th * pt * pt
        + 2.0 * h_th * pt * pr
        + DS_th * pr * pr
        + 2.0 * a * invS_th * pr * pph
        + invS_th * pth * pth
        + invSs2_th * pph * pph
    )
    return dt, dr, dth, dph, -dH_dr, -dH_dth


def _renorm_theta(m, a, r, th, pt, pr, pth, pph):
    """The theta form's p_r projected onto H = 0 (the JAX twin's
    ``ks_renormalize`` body, :123-145)."""
    s2, _, S, D, inv_S, h = _geom(m, a, r, th)
    A = D * inv_S
    B = 2.0 * (h * pt + a * inv_S * pph)
    C = -(1.0 + h) * pt * pt + pth * pth * inv_S + pph * pph * inv_S / s2
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


def ks_rhs(m, a, y: torch.Tensor) -> torch.Tensor:
    """dy/dlambda of packed theta-form states y (..., 8) -> (..., 8):
    dx/dlambda = g^{mu nu} p_nu, dp_r = -dH/dr, dp_theta = -dH/dtheta,
    p_t and p_phi conserved."""
    d = _rhs_theta(m, a, y[..., 1], y[..., 2], y[..., 4], y[..., 5],
                   y[..., 6], y[..., 7])
    zeros = torch.zeros_like(y[..., 1])
    return torch.stack([d[0], d[1], d[2], d[3], zeros, d[4], d[5], zeros],
                       dim=-1)


def ks_renormalize(m, a, y: torch.Tensor) -> torch.Tensor:
    """Packed theta-form states (..., 8) with p_r projected onto H = 0:
    the root of A p_r^2 + B p_r + C = 0 nearest the current p_r."""
    new_pr = _renorm_theta(m, a, y[..., 1], y[..., 2], y[..., 4], y[..., 5],
                           y[..., 6], y[..., 7])
    return torch.cat([y[..., :5], new_pr[..., None], y[..., 6:]], dim=-1)


def ks_symplectic_step(m, a, y: torch.Tensor, dlam, iterations: int = 2):
    """Implicit midpoint on packed theta-form states (..., 8), ``dlam``
    (...): ``iterations`` fixed-point rounds from an explicit-Euler seed."""
    hh = dlam[..., None]
    y_next = y + hh * ks_rhs(m, a, y)
    for _ in range(iterations):
        y_next = y + hh * ks_rhs(m, a, 0.5 * (y + y_next))
    return y_next


def ks_rhs_t(m, a, yt: torch.Tensor) -> torch.Tensor:
    """ks_rhs on transposed theta-form rows: (8, N) -> (8, N)."""
    d = _rhs_theta(m, a, yt[1], yt[2], yt[4], yt[5], yt[6], yt[7])
    zeros = torch.zeros_like(yt[1])
    return torch.stack([d[0], d[1], d[2], d[3], zeros, d[4], d[5], zeros])


def ks_renormalize_t(m, a, yt: torch.Tensor) -> torch.Tensor:
    """ks_renormalize on transposed theta-form rows (8, N)."""
    new_pr = _renorm_theta(m, a, yt[1], yt[2], yt[4], yt[5], yt[6], yt[7])
    return torch.cat([yt[:5], new_pr[None], yt[6:]], dim=0)


def ks_symplectic_step_t(m, a, yt: torch.Tensor, dlam, iterations: int = 2):
    """ks_symplectic_step on transposed rows: yt (8, N), dlam (N,)."""
    hh = dlam[None, :]
    y_next = yt + hh * ks_rhs_t(m, a, yt)
    for _ in range(iterations):
        y_next = yt + hh * ks_rhs_t(m, a, 0.5 * (yt + y_next))
    return y_next


def w_floor(dtype) -> float:
    """Pole guard floor for w = 1 - u^2: 1e-6 in float32 (so the 1/w^2 polar
    terms cannot overflow inside one implicit-midpoint step), 1e-12 in
    float64."""
    return 1e-12 if torch.finfo(dtype).bits >= 64 else 1e-6


def _geom_u(m, a, r, u, recip=None):
    """(w, S, D, 1/S, h) at one evaluation point."""
    w = maximum(1.0 - u * u, w_floor(u.dtype))
    S = r * r + a * a * u * u
    D = r * r - 2.0 * m * r + a * a
    inv_S = recip(S) if recip is not None else 1.0 / S
    h = 2.0 * m * r * inv_S
    return w, S, D, inv_S, h


def ks_rhs_rows(m, a, r, u, pt, pr, pu, pph, recip=None):
    """dy/dlambda on unpacked rows -> (dt, dr, du, dph, dpr, dpu); the
    conserved p_t and p_phi have zero derivative and are not returned."""
    w, S, D, inv_S, h = _geom_u(m, a, r, u, recip)
    inv_S2 = inv_S * inv_S
    inv_w = recip(w) if recip is not None else 1.0 / w

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


def ks_symplectic_step_rows(m, a, rows, dlam, iterations: int = 2,
                            recip=None):
    """Implicit-midpoint step on unpacked rows (t, r, u, ph, pt, pr, pu, pph):
    ``iterations`` fixed-point rounds from an explicit-Euler seed. Returns the
    six evolving rows (t, r, u, ph, pr, pu)."""
    t, r, u, ph, pt, pr, pu, pph = rows
    d = ks_rhs_rows(m, a, r, u, pt, pr, pu, pph, recip)
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
            pt, 0.5 * (pr + npr), 0.5 * (pu + npu), pph, recip,
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


def set_row(yt: torch.Tensor, k: int, val: torch.Tensor) -> torch.Tensor:
    """(8, N) rows with row ``k`` replaced by ``val`` (N,), selected by a row
    mask as the JAX twin does."""
    row_ids = torch.arange(yt.shape[0], device=yt.device)[:, None]
    return torch.where(row_ids == k, val[None, :], yt)


def ks_hamiltonian_u(m, a, yt: torch.Tensor) -> torch.Tensor:
    """H of (8, N) u-chart rows -> (N,)."""
    r, u = yt[1], yt[2]
    pt, pr, pu, pph = yt[4], yt[5], yt[6], yt[7]
    w, S, D, inv_S, h = _geom_u(m, a, r, u)
    return 0.5 * (
        -(1.0 + h) * pt * pt
        + 2.0 * h * pt * pr
        + D * inv_S * pr * pr
        + 2.0 * a * inv_S * pr * pph
        + w * inv_S * pu * pu
        + pph * pph * inv_S / w
    )


def ks_rhs_u(m, a, yt: torch.Tensor, recip=None) -> torch.Tensor:
    """dy/dlambda of (8, N) u-chart rows -> (8, N): ks_rhs_rows with zero
    rows for the conserved p_t and p_phi."""
    d = ks_rhs_rows(m, a, yt[1], yt[2], yt[4], yt[5], yt[6], yt[7], recip)
    zeros = torch.zeros_like(yt[1])
    return torch.stack([d[0], d[1], d[2], d[3], zeros, d[4], d[5], zeros])


def ks_symplectic_step_u(m, a, yt: torch.Tensor, dlam, iterations: int = 2,
                         recip=None) -> torch.Tensor:
    """Implicit midpoint on (8, N) u-chart rows, ``dlam`` (N,):
    ks_symplectic_step_rows with p_t and p_phi passed through."""
    nt, nr, nu, nph, npr, npu = ks_symplectic_step_rows(
        m, a, tuple(yt[i] for i in range(8)), dlam, iterations, recip)
    return torch.stack([nt, nr, nu, nph, yt[4], npr, npu, yt[7]])


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
