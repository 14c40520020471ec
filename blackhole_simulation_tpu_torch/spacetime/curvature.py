"""Kretschmann curvature scalar fields.

Counterpart of ``blackhole_simulation_tpu/spacetime/curvature.py``: the
closed-form Kerr Kretschmann invariant, its Schwarzschild case and the
(r, theta, K) field. Tensors on the inputs' device (numbers and arrays
become float64 tensors).
"""

from __future__ import annotations

import torch

from blackhole_simulation_tpu_torch._elementwise import f64_args


def kretschmann_kerr(m, a, r, theta):
    """K = 48 M^2 (r^6 - 15 r^4 a^2 c^2 + 15 r^2 a^4 c^4 - a^6 c^6) / Sigma^6,
    c = cos(theta); 48 M^2 / r^6 at a = 0."""
    m, a, r, theta = f64_args(m, a, r, theta)
    c = torch.cos(theta)
    ac = a * c
    r2 = r * r
    ac2 = ac * ac
    sig = r * r + a * a * c * c
    num = r2**3 - 15.0 * r2 * r2 * ac2 + 15.0 * r2 * ac2 * ac2 - ac2**3
    return 48.0 * m * m * num / sig**6


def kretschmann_schwarzschild(m, r):
    """K = 48 M^2 / r^6."""
    m, r = f64_args(m, r)
    return 48.0 * m * m / r**6


def curvature_field(m, a, r_grid, theta_grid):
    """The field K(r, theta) on the meshgrid of the two 1-D grids
    (indexing "ij"): (r, theta, K)."""
    m, a, r_grid, theta_grid = f64_args(m, a, r_grid, theta_grid)
    r, th = torch.meshgrid(r_grid, theta_grid, indexing="ij")
    return r, th, kretschmann_kerr(m, a, r, th)
