"""Conservation-law machinery: H, null renormalization, constants of motion.

Counterpart of ``blackhole_simulation_tpu/geodesic/invariants.py``, batched
over leading ray axes, in the state's dtype.
"""

from __future__ import annotations

import dataclasses

import torch


def hamiltonian(y: torch.Tensor, metric) -> torch.Tensor:
    """H = 1/2 g^{mu nu} p_mu p_nu for state y: (..., 8) -> (...)."""
    return metric.hamiltonian(y[..., 1], y[..., 2], y[..., 4:])


def renormalize_null(y: torch.Tensor, metric) -> torch.Tensor:
    """Project p_r onto the null surface H = 0: the root of
    A p_r^2 + B p_r + C = 0 nearest the current p_r (A = g^rr,
    B = 2 (g^tr p_t + g^rphi p_phi), C = the rest of 2H). Rays with a
    negative discriminant or A ~ 0 are left unchanged; the square root sees
    a positive argument on them (the safe-where), so no gradient through a
    masked lane is inf."""
    r, theta = y[..., 1], y[..., 2]
    p_t, p_r, p_th, p_ph = y[..., 4], y[..., 5], y[..., 6], y[..., 7]
    g = metric.contravariant(r, theta)
    a_quad = g[..., 1, 1]
    b_quad = 2.0 * (g[..., 0, 1] * p_t + g[..., 1, 3] * p_ph)
    c_quad = (
        g[..., 0, 0] * p_t * p_t
        + g[..., 2, 2] * p_th * p_th
        + g[..., 3, 3] * p_ph * p_ph
        + 2.0 * g[..., 0, 3] * p_t * p_ph
    )
    disc = b_quad * b_quad - 4.0 * a_quad * c_quad
    valid = (disc >= 0.0) & (torch.abs(a_quad) > 1e-12)
    sqrt_d = torch.sqrt(torch.where(valid, torch.clamp(disc, min=1e-30), 1.0))
    denom = torch.where(valid, 2.0 * a_quad, 1.0)
    sol1 = (-b_quad + sqrt_d) / denom
    sol2 = (-b_quad - sqrt_d) / denom
    nearest = torch.where(torch.abs(sol1 - p_r) < torch.abs(sol2 - p_r),
                          sol1, sol2)
    new_pr = torch.where(valid, nearest, p_r)
    return torch.cat([y[..., :5], new_pr[..., None], y[..., 6:]], dim=-1)


@dataclasses.dataclass(frozen=True)
class ConstantsOfMotion:
    energy: torch.Tensor
    angular_momentum: torch.Tensor
    carter_constant: torch.Tensor
    hamiltonian: torch.Tensor
    walker_penrose: torch.Tensor  # complex


def constants_of_motion(y: torch.Tensor, metric) -> ConstantsOfMotion:
    """E = -p_t, L_z = p_phi, Carter Q = p_theta^2 + cos^2(theta)
    (L_z^2 / sin^2(theta) - a^2 E^2), H, and the Walker-Penrose proxy
    (r + i a cos(theta)) sqrt(max(Q, 0)) as a complex tensor (complex128
    for float64 states)."""
    r, theta = y[..., 1], y[..., 2]
    p_t, p_th, p_ph = y[..., 4], y[..., 6], y[..., 7]
    a = getattr(metric, "spin", None)
    if a is None:
        a = torch.zeros((), dtype=y.dtype, device=y.device)
    energy = -p_t
    lz = p_ph
    c, s = torch.cos(theta), torch.sin(theta)
    s2 = s * s
    lz_term = torch.where(s2 < 1e-12, 0.0,
                          lz * lz / torch.clamp(s2, min=1e-12))
    carter = p_th * p_th + c * c * (lz_term - a * a * energy * energy)
    h = hamiltonian(y, metric)
    wp = torch.complex(r, a * c) * torch.sqrt(torch.clamp(carter, min=0.0))
    return ConstantsOfMotion(energy=energy, angular_momentum=lz,
                             carter_constant=carter, hamiltonian=h,
                             walker_penrose=wp)
