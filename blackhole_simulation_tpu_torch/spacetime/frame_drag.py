"""Frame-dragging (ZAMO) fields and the ergosphere surface.

Counterpart of ``blackhole_simulation_tpu/spacetime/frame_drag.py``: the
omega(r, theta) field and the ergosphere mesh r_E(theta) = M +
sqrt(M^2 - a^2 cos^2 theta) as flat xyz vertices, through the port's
``KerrMetric``, on the inputs' device (numbers become float64 tensors on
the CPU).
"""

from __future__ import annotations

import math

import torch

from blackhole_simulation_tpu_torch._elementwise import f64_args
from blackhole_simulation_tpu_torch.geometry.metrics import KerrMetric


def frame_dragging_omega(m, a, r, theta):
    """ZAMO angular velocity omega = -g_tphi / g_phiphi = 2 M a r / A."""
    m, a, r, theta = f64_args(m, a, r, theta)
    return KerrMetric(mass=m, spin=a).frame_dragging(r, theta)


def frame_drag_field(m, a, r_grid, theta_grid):
    """The field omega(r, theta) on the meshgrid (indexing "ij"):
    (r, theta, omega)."""
    m, a, r_grid, theta_grid = f64_args(m, a, r_grid, theta_grid)
    r, th = torch.meshgrid(r_grid, theta_grid, indexing="ij")
    return r, th, frame_dragging_omega(m, a, r, th)


def ergosphere_mesh(m=1.0, a=0.9, n_theta: int = 32, n_phi: int = 48):
    """The outer ergosurface as flat xyz float32 vertices, (n_theta n_phi, 3)."""
    m, a = f64_args(m, a)
    bh = KerrMetric(mass=m, spin=a)
    th = torch.linspace(1e-3, math.pi - 1e-3, n_theta, dtype=m.dtype,
                        device=m.device)
    ph = torch.linspace(0.0, 2.0 * math.pi, n_phi, dtype=m.dtype,
                        device=m.device)
    r_e = bh.ergosphere(th)
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    x = (r_e * sin_t)[:, None] * torch.cos(ph)[None, :]
    y = (r_e * sin_t)[:, None] * torch.sin(ph)[None, :]
    z = torch.broadcast_to((r_e * cos_t)[:, None], x.shape)
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3).to(torch.float32)
