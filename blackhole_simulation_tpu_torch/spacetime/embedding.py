"""Embedding diagrams: the Flamm paraboloid, the Kerr funnel, proper
distances.

Counterpart of ``blackhole_simulation_tpu/spacetime/embedding.py``: Flamm's
z = 2 sqrt(r_s (r - r_s)), the equatorial Kerr embedding
Int sqrt(|g_rr - 1|) dr (cumulative trapezoid over the same fixed n-point
grid, dense near the horizon), the proper radial distance Int sqrt(g_rr) dr
(trapezoid over n points) and the funnel mesh. On the inputs' device
(numbers and arrays become float64 tensors).
"""

from __future__ import annotations

import math

import torch

from blackhole_simulation_tpu_torch._elementwise import f64_args, interp

_C_EQ = math.cos(math.pi / 2)


def flamm_height(r, m=1.0):
    """Flamm paraboloid z(r) = 2 sqrt(r_s (r - r_s)), r_s = 2M; zero inside
    the horizon."""
    r, m = f64_args(r, m)
    rs = 2.0 * m
    return 2.0 * torch.sqrt(rs * torch.clamp(r - rs, min=0.0))


def _g_rr_equatorial(m, a, r):
    """Boyer-Lindquist g_rr = Sigma / Delta on the equator, Delta floored."""
    sig = r * r + a * a * _C_EQ * _C_EQ
    delta = r * r - 2.0 * m * r + a * a
    return sig / torch.clamp(delta, min=1e-9)


def _r_plus(m, a):
    return m + torch.sqrt(torch.clamp(m * m - a * a, min=0.0))


def kerr_embedding_height(r, m=1.0, a=0.0, n: int = 256):
    """Equatorial Kerr embedding z(r) = Int_{r+}^{r} sqrt(|g_rr - 1|) dr',
    a cumulative trapezoid from just outside the horizon outward over n
    points, interpolated at r."""
    r, m, a = f64_args(r, m, a)
    r0 = _r_plus(m, a) * (1.0 + 1e-6)
    r_hi = torch.maximum(torch.max(r), r0 * 2.0)
    t = torch.linspace(0.0, 1.0, n, dtype=r0.dtype, device=r0.device)
    grid = r0 + (r_hi - r0) * t**2
    integrand = torch.sqrt(torch.abs(_g_rr_equatorial(m, a, grid) - 1.0))
    panels = 0.5 * (integrand[1:] + integrand[:-1]) * torch.diff(grid)
    cum = torch.cat([torch.zeros_like(grid[:1]), torch.cumsum(panels, 0)])
    return interp(r.reshape(-1), grid, cum).reshape(r.shape)


def proper_distance(r_from, r_to, m=1.0, a=0.0, n: int = 256):
    """Proper radial distance Int sqrt(g_rr) dr on the equator, a
    trapezoid over n points."""
    r_from, r_to, m, a = f64_args(r_from, r_to, m, a)
    t = torch.linspace(0.0, 1.0, n, dtype=r_from.dtype, device=r_from.device)
    grid = r_from + (r_to - r_from) * t
    grid[-1] = r_to
    integrand = torch.sqrt(_g_rr_equatorial(m, a, grid))
    return torch.trapezoid(integrand, grid)


def embedding_mesh(m=1.0, a=0.0, n_r: int = 48, n_phi: int = 64, r_max=20.0):
    """The embedding funnel as flat xyz float32 vertices, (n_r n_phi, 3):
    rings of radius r at height -z(r)."""
    m, a = f64_args(m, a)
    r_plus = _r_plus(m, a)
    t = torch.linspace(0.0, 1.0, n_r, dtype=m.dtype, device=m.device)
    rs = r_plus * (1.0 + 1e-4) + (r_max * m - r_plus) * t**1.5
    z = kerr_embedding_height(rs, m, a)
    phi = torch.linspace(0.0, 2.0 * math.pi, n_phi, dtype=m.dtype,
                         device=m.device)
    x = rs[:, None] * torch.cos(phi)[None, :]
    y = rs[:, None] * torch.sin(phi)[None, :]
    zz = -torch.broadcast_to(z[:, None], x.shape)
    return torch.stack([x, y, zz], dim=-1).reshape(-1, 3).to(torch.float32)
