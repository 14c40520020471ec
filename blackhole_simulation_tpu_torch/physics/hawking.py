"""Hawking temperature of a Kerr black hole.

Counterpart of ``blackhole_simulation_tpu/physics/hawking.py``: the surface
gravity kappa = (r+ - r-) / (2 (r+^2 + a^2)) in geometric units, then
T_H = hbar kappa_SI / (2 pi k_B c) through SI. Tensors in, tensors out
(numbers become float64 tensors).
"""

from __future__ import annotations

import math

import torch

from blackhole_simulation_tpu_torch._elementwise import f64_args
from blackhole_simulation_tpu_torch.constants import (
    C_SI,
    G_SI,
    HBAR,
    K_B,
    M_SUN,
)


def surface_gravity(m, a):
    """kappa = (r+ - r-) / (2 (r+^2 + a^2)), geometric units (1/M)."""
    m, a = f64_args(m, a)
    root = torch.sqrt(torch.clamp(m * m - a * a, min=0.0))
    r_plus = m + root
    r_minus = m - root
    return (r_plus - r_minus) / (2.0 * (r_plus * r_plus + a * a))


def hawking_temperature(mass_solar, a_star=0.0):
    """Hawking temperature in kelvin of a hole of ``mass_solar`` solar masses
    and dimensionless spin a*; ~6.17e-8 K / M_sun at a* = 0."""
    mass_solar, a_star = f64_args(mass_solar, a_star)
    m_si = mass_solar * M_SUN
    kappa_geom = surface_gravity(torch.ones_like(a_star), a_star)
    kappa_si = kappa_geom * C_SI**4 / (G_SI * m_si)
    return HBAR * kappa_si / (2.0 * math.pi * K_B * C_SI)
