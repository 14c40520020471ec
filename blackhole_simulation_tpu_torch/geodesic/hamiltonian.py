"""Hamilton's equations for null geodesics.

Counterpart of ``blackhole_simulation_tpu/geodesic/hamiltonian.py``:
dx^mu/dlambda = g^{mu nu} p_nu, dp_mu/dlambda = -dH/dx^mu (nonzero for r
and theta only: t and phi are Killing directions). The metric's ``flow``
gives g^{mu nu} p_nu and (dH/dr, dH/dtheta) in closed form, where the JAX
twin raises the index through the (..., 4, 4) tensor and differentiates H
by ``jax.grad``.
"""

from __future__ import annotations

import torch


def state_derivative(metric, y: torch.Tensor) -> torch.Tensor:
    """dy/dlambda for state y: (..., 8) -> (..., 8)."""
    dx, dh_dr, dh_dth = metric.flow(y[..., 1], y[..., 2], y[..., 4:])
    zeros = torch.zeros_like(dh_dr)
    dp = torch.stack([zeros, -dh_dr, -dh_dth, zeros], dim=-1)
    return torch.cat([dx, dp], dim=-1)
