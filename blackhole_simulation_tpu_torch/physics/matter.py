"""Matter fields: accretion-disk and relativistic-jet density and bulk
velocity.

Counterpart of ``blackhole_simulation_tpu/physics/matter.py``: the
``MatterField`` protocol, the thin Keplerian ``AccretionDisk``, the
bi-conical ``RelativisticJet`` (with its Doppler factor and a
Blandford-Znajek power estimate) and the dust stress-energy
``stress_energy_dust``. Every field is a batched function of position and
the hole's (m, a), tensors in and out on the inputs' device (numbers and
arrays become float64 tensors). The render path's shading reads its own
``DiskParams`` / ``JetParams``; this is the physics-facing API.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Protocol, runtime_checkable

import torch

from blackhole_simulation_tpu_torch._elementwise import f64_args
from blackhole_simulation_tpu_torch.geometry import radii


@runtime_checkable
class MatterField(Protocol):
    """Density and bulk velocity at a point, in geometric units."""

    def density(self, m, a, r, theta, phi): ...

    def four_velocity(self, m, a, r, theta): ...


@dataclasses.dataclass(frozen=True)
class AccretionDisk:
    """Geometrically thin Keplerian disk: Gaussian in height with scale
    ``h_ratio * r``, a power law in radius on [isco, r_out], zero inside
    the ISCO."""

    r_out: float = 20.0
    h_ratio: float = 0.08
    density_index: float = -1.5
    rho0: float = 1.0

    def density(self, m, a, r, theta, phi=0.0):
        r, theta, m, a = f64_args(r, theta, m, a)
        r_in = radii.isco(m, a, prograde=True)
        z = r * torch.cos(theta)
        h = self.h_ratio * r
        radial = torch.where(
            (r >= r_in) & (r <= self.r_out),
            (r / torch.clamp(r_in, min=1e-6)) ** self.density_index,
            0.0,
        )
        return self.rho0 * radial * torch.exp(
            -0.5 * (z / torch.clamp(h, min=1e-6)) ** 2)

    def four_velocity(self, m, a, r, theta):
        """Circular equatorial u^mu = u^t (1, 0, 0, Omega_K), u^t from the
        equatorial Boyer-Lindquist normalization."""
        r, m, a = f64_args(r, m, a)
        sm = torch.sqrt(m)
        omega = sm / (r ** 1.5 + a * sm)
        g_tt = -(1.0 - 2.0 * m / r)
        g_tph = -2.0 * m * a / r
        g_phph = r * r + a * a + 2.0 * m * a * a / r
        ut = 1.0 / torch.sqrt(torch.clamp(
            -(g_tt + 2.0 * g_tph * omega + g_phph * omega * omega), min=1e-12))
        zeros = torch.zeros_like(r)
        return torch.stack([ut, zeros, zeros, ut * omega], dim=-1)

    def surface_density(self, m, a, r):
        """Vertically integrated density Sigma(r) = sqrt(2 pi) H rho."""
        (r,) = f64_args(r)
        return math.sqrt(2.0 * math.pi) * self.h_ratio * r * self.density(
            m, a, r, math.pi / 2)


@dataclasses.dataclass(frozen=True)
class RelativisticJet:
    """Bi-conical jet about the spin axis: opening half-angle
    ``half_angle``, bulk speed ``beta`` along the axis, a power-law falloff
    along it."""

    half_angle: float = 0.15
    beta: float = 0.92
    r_base: float = 2.0
    r_max: float = 60.0
    rho0: float = 0.05
    falloff: float = -2.0

    def density(self, m, a, r, theta, phi=0.0):
        r, theta = f64_args(r, theta)
        ang = torch.minimum(theta, math.pi - theta)
        core = torch.exp(-0.5 * (ang / max(self.half_angle, 1e-6)) ** 2)
        radial = torch.where(
            (r >= self.r_base) & (r <= self.r_max),
            (r / self.r_base) ** self.falloff,
            0.0,
        )
        return self.rho0 * core * radial

    def _gamma(self) -> float:
        return 1.0 / math.sqrt(1.0 - self.beta * self.beta)

    def four_velocity(self, m, a, r, theta):
        """Outflow along +e_r at speed beta in the local static frame:
        u = gamma (1, beta, 0, 0) (flat-space normalized)."""
        (r,) = f64_args(r)
        gamma = self._gamma()
        zeros = torch.zeros_like(r)
        return torch.stack([torch.full_like(r, gamma),
                            torch.full_like(r, gamma * self.beta), zeros,
                            zeros], dim=-1)

    def doppler(self, costh_view):
        """Doppler delta = 1 / (gamma (1 - beta cos theta))."""
        (costh_view,) = f64_args(costh_view)
        return 1.0 / (self._gamma() * (1.0 - self.beta * costh_view))

    def blandford_znajek_power(self, m, a, b_field=1.0):
        """kappa (B pi r+^2)^2 Omega_H^2 / (4 pi), Omega_H = a / (2 M r+),
        kappa = 0.053 (split monopole)."""
        m, a, b_field = f64_args(m, a, b_field)
        r_p = radii.event_horizon(m, a)
        omega_h = a / (2.0 * m * r_p)
        phi_flux = b_field * math.pi * r_p * r_p
        return 0.053 * phi_flux * phi_flux * omega_h * omega_h / (4.0 * math.pi)


def stress_energy_dust(rho, u_con, g_cov):
    """T^{mu nu} = rho u^mu u^nu (pressureless dust) and its trace
    rho (u . u). ``u_con``: (..., 4), ``g_cov``: (..., 4, 4)."""
    rho, u_con, g_cov = f64_args(rho, u_con, g_cov)
    t_con = rho[..., None, None] * u_con[..., :, None] * u_con[..., None, :]
    u_cov = torch.einsum("...ij,...j->...i", g_cov, u_con)
    trace = rho * torch.einsum("...i,...i->...", u_con, u_cov)
    return t_con, trace
