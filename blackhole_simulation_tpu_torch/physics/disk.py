"""Page-Thorne relativistic thin-disk flux and temperature, float64.

Counterpart of ``blackhole_simulation_tpu/physics/disk.py``: circular orbit
E(r), L_z(r), Omega(r), the Page-Thorne flux integral
(``page_thorne_flux`` :59), the effective temperature ``disk_temperature``
(:101), the normalized temperature LUT ``generate_temperature_lut`` (:113)
and ``temperature_profile`` (:126). The JAX package takes the exact
derivatives dL/dr and dOmega/dr with ``jax.grad``; here ``torch.autograd``
takes them, in float64.

``page_thorne_flux_t`` is the flux on float64 tensors, differentiable in
r, m and a (the derivatives dL/dr and dOmega/dr keep their graphs, so the
second derivatives reach m and a, as ``jax.grad`` of the JAX twin gives
them): the spectral disk's tables are built from it in the render's graph
when the scene's mass or spin requires grad (``render/shading.py::
build_disk_luts_t``). ``page_thorne_flux`` is its numpy face, for the
cached tables and the engine facade (``engine/facade.py``). The inner
integral's interpolation is ``jnp.interp``'s arithmetic
(``_elementwise.interp``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import (
    attach,
    grad_wanted,
    host,
    interp,
    maximum,
)
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
    sqm = torch.sqrt(m) if isinstance(m, torch.Tensor) else math.sqrt(m)
    return sqm / (r**1.5 + a * sqm)


def _d_dr(fn, m, a, r):
    """Elementwise exact d fn(m, a, r) / dr by autograd (fn is pointwise),
    also when the caller runs under ``torch.no_grad``. Where autograd wants
    a derivative of the result (``grad_wanted`` of m, a, r) it keeps its
    graph, so that the second derivatives reach m, a and r."""
    if grad_wanted(m, a, r):
        rr = r if r.requires_grad else r.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(m, a, rr).sum(), rr, create_graph=True)
        return g
    with torch.enable_grad():
        rr = r.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(m, a, rr).sum(), rr)
    return g.detach()


def page_thorne_flux_t(r, m, a, mdot=1.0, n_grid: int = 512):
    """Page-Thorne flux F(r) per unit disk area at accretion rate ``mdot``
    on float64 tensors: ``r`` of any shape, ``m`` and ``a`` numbers or 0-d
    tensors, differentiable in all three. Zero inside the ISCO (no-torque
    boundary). The inner integral is a cumulative trapezoid over a
    log-spaced grid from the ISCO to max(r), interpolated at r, as the JAX
    twin computes it. The ISCO keeps its host float64 value
    (``Kerr.isco``) and takes its derivative from ``isco_t``."""
    from blackhole_simulation_tpu_torch.geometry.metrics import isco_t

    f64 = lambda x: (x.to(torch.float64) if isinstance(x, torch.Tensor)
                     else torch.tensor(float(x), dtype=torch.float64))
    m, a, r = f64(m), f64(a), f64(r)
    dev = r.device
    m, a = m.to(dev), a.to(dev)
    r_isco = attach(
        torch.tensor(Kerr(mass=host(m), spin=host(a)).isco(),
                     dtype=torch.float64, device=dev),
        isco_t(m, a))
    r_max = maximum(torch.amax(r), r_isco * 2.0) * 1.001
    ts = torch.linspace(0.0, 1.0, n_grid, dtype=torch.float64, device=dev)
    grid = r_isco * (r_max / r_isco) ** ts
    e_g = circular_orbit_energy(m, a, grid)
    l_g = circular_orbit_angular_momentum(m, a, grid)
    om_g = circular_orbit_omega(m, a, grid)
    vals = (e_g - om_g * l_g) * _d_dr(circular_orbit_angular_momentum, m, a,
                                      grid)
    panels = 0.5 * (vals[1:] + vals[:-1]) * torch.diff(grid)
    cum = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                     torch.cumsum(panels, 0)])
    rf = r.reshape(-1)
    integral = interp(rf, grid, cum)

    e = circular_orbit_energy(m, a, rf)
    lz = circular_orbit_angular_momentum(m, a, rf)
    om = circular_orbit_omega(m, a, rf)
    dom_dr = _d_dr(circular_orbit_omega, m, a, rf)
    flux = (
        -(float(mdot) / (4.0 * math.pi * rf))
        * dom_dr
        / maximum((e - om * lz) ** 2, 1e-30)
        * integral
    )
    flux = torch.where(rf > r_isco, maximum(flux, 0.0), 0.0)
    return flux.reshape(r.shape)


def page_thorne_flux(r, m=1.0, a=0.0, mdot=1.0, n_grid: int = 512):
    """``page_thorne_flux_t`` of host values: a float64 numpy array of r's
    shape. The arguments' positions are the JAX twin's."""
    shape = np.shape(r)
    r_t = torch.as_tensor(np.atleast_1d(np.asarray(r, np.float64)).ravel())
    with torch.no_grad():
        flux = page_thorne_flux_t(r_t, host(m), host(a), mdot, n_grid)
    return flux.numpy().reshape(shape)


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
