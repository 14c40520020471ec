"""Page-Thorne relativistic thin-disk flux and temperature, host float64.

Counterpart of ``blackhole_simulation_tpu/physics/disk.py``: circular orbit
E(r), L_z(r), Omega(r), the Page-Thorne flux integral
(``page_thorne_flux`` :59), the effective temperature ``disk_temperature``
(:101), the normalized temperature LUT ``generate_temperature_lut`` (:113)
and ``temperature_profile`` (:126). The JAX package takes the exact
derivatives dL/dr and dOmega/dr with ``jax.grad``; here ``torch.autograd``
takes them, in float64 on the CPU. It runs once per scene, to build the
spectral disk tables (``render/shading.py``), and behind the engine facade
(``engine/facade.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from blackhole_simulation_tpu_torch.geometry.metrics import Kerr


def circular_orbit_energy(m, a, r):
    """Specific energy E(r) of a prograde circular equatorial orbit."""
    x = torch.sqrt(m / r)
    denom = torch.sqrt(torch.clamp(1.0 - 3.0 * x * x + 2.0 * a * x**3 / m, min=1e-12))
    return (1.0 - 2.0 * x * x + a * x**3 / m) / denom


def circular_orbit_angular_momentum(m, a, r):
    """Specific angular momentum L_z(r), prograde."""
    x = torch.sqrt(m / r)
    denom = torch.sqrt(torch.clamp(1.0 - 3.0 * x * x + 2.0 * a * x**3 / m, min=1e-12))
    return r * x * (1.0 - 2.0 * a * x**3 / m + (a / r) ** 2) / denom


def circular_orbit_omega(m, a, r):
    """Keplerian angular velocity Omega(r), prograde."""
    sqm = math.sqrt(m)
    return sqm / (r**1.5 + a * sqm)


def _d_dr(fn, m, a, r):
    """Elementwise exact d fn(m, a, r) / dr by autograd (fn is pointwise),
    also when the caller runs under ``torch.no_grad``."""
    with torch.enable_grad():
        rr = r.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(m, a, rr).sum(), rr)
    return g.detach()


def page_thorne_flux(r, m=1.0, a=0.0, mdot=1.0, n_grid: int = 512):
    """Page-Thorne flux F(r) per unit disk area at accretion rate ``mdot``,
    float64 numpy array of r's shape.

    ``r``: float64 radii (a number or an array). Zero inside the ISCO
    (no-torque boundary). The inner integral is a cumulative trapezoid over
    a log-spaced grid from the ISCO to max(r), interpolated at r, as the
    JAX twin computes it. The arguments' positions are the JAX twin's.
    """
    m = float(m)
    a = float(a)
    shape = np.shape(r)
    r_np = np.atleast_1d(np.asarray(r, np.float64)).ravel()
    r_isco = Kerr(mass=m, spin=a).isco()
    r_max = max(float(r_np.max()), r_isco * 2.0) * 1.001
    with torch.no_grad():
        ts = torch.linspace(0.0, 1.0, n_grid, dtype=torch.float64)
        grid = r_isco * (r_max / r_isco) ** ts
    e_g = circular_orbit_energy(m, a, grid)
    l_g = circular_orbit_angular_momentum(m, a, grid)
    om_g = circular_orbit_omega(m, a, grid)
    vals = (e_g - om_g * l_g) * _d_dr(circular_orbit_angular_momentum, m, a, grid)
    panels = 0.5 * (vals[1:] + vals[:-1]) * torch.diff(grid)
    cum = torch.cat([torch.zeros(1, dtype=torch.float64), torch.cumsum(panels, 0)])
    integral = np.interp(r_np, grid.numpy(), cum.numpy())

    rt = torch.as_tensor(r_np)
    e = circular_orbit_energy(m, a, rt)
    lz = circular_orbit_angular_momentum(m, a, rt)
    om = circular_orbit_omega(m, a, rt)
    dom_dr = _d_dr(circular_orbit_omega, m, a, rt)
    flux = (
        -(float(mdot) / (4.0 * math.pi * rt))
        * dom_dr
        / torch.clamp((e - om * lz) ** 2, min=1e-30)
        * torch.as_tensor(integral)
    )
    flux = torch.where(rt > r_isco, torch.clamp(flux, min=0.0), 0.0)
    return flux.detach().numpy().reshape(shape)


def disk_temperature(r, m=1.0, a=0.0, mdot=1.0, t_scale=1e7):
    """Effective temperature T(r) = F(r)^{1/4}, scaled so that the peak
    over r in [1, 50] M lands at ``t_scale`` kelvin."""
    t_raw = np.maximum(page_thorne_flux(r, m, a, mdot), 0.0) ** 0.25
    r_probe = np.linspace(1.0, 50.0, 256) * float(m)
    peak = np.max(np.maximum(page_thorne_flux(r_probe, m, a, mdot), 0.0)
                  ** 0.25)
    return t_raw / max(peak, 1e-30) * t_scale


def generate_temperature_lut(m=1.0, a=0.0, mdot=1.0, width: int = 512,
                             r_max=50.0):
    """Normalized T(r) over [r_isco, r_max M] as a float32 (width,) array:
    (lut, r_isco, r_max M)."""
    r_isco = Kerr(mass=float(m), spin=float(a)).isco()
    rs = r_isco + (r_max * float(m) - r_isco) * np.linspace(0.0, 1.0, width)
    t = np.maximum(page_thorne_flux(rs, m, a, mdot), 0.0) ** 0.25
    t = t / max(t.max(), 1e-30)
    return t.astype(np.float32), r_isco, r_max * float(m)


def temperature_profile(m=1.0, a=0.0, mdot=1.0, n: int = 128, r_max=50.0):
    """(r, T(r)) over [r_isco, r_max M] at n radii, for plotting."""
    r_isco = Kerr(mass=float(m), spin=float(a)).isco()
    rs = r_isco + (r_max * float(m) - r_isco) * np.linspace(0.0, 1.0, n)
    return rs, disk_temperature(rs, m, a, mdot)
