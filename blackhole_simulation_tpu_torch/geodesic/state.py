"""Phase-space state layout for geodesics.

Counterpart of ``blackhole_simulation_tpu/geodesic/state.py``: a state is a
flat ``(..., 8)`` tensor, x^mu = (t, r, theta, phi) then p_mu = (p_t, p_r,
p_theta, p_phi).
"""

from __future__ import annotations

import torch

STATE_DIM = 8

T, R, TH, PH = 0, 1, 2, 3       # position slots
PT, PR, PTH, PPH = 4, 5, 6, 7   # momentum slots


def pack_state(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Concatenate position (..., 4) and momentum (..., 4) into (..., 8)."""
    return torch.cat([x, p], dim=-1)


def position(y: torch.Tensor) -> torch.Tensor:
    return y[..., :4]


def momentum(y: torch.Tensor) -> torch.Tensor:
    return y[..., 4:]


def null_ray(x, p_spatial, metric) -> torch.Tensor:
    """A null ray at position x with spatial momentum (p_r, p_th, p_ph):
    p_t = -1 (unit energy) and p_r projected onto the H = 0 surface."""
    from blackhole_simulation_tpu_torch.geodesic.invariants import (
        renormalize_null,
    )

    x = torch.as_tensor(x)
    p_spatial = torch.as_tensor(p_spatial, dtype=x.dtype, device=x.device)
    p_t = -torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    p = torch.cat([p_t, p_spatial], dim=-1)
    return renormalize_null(pack_state(x, p), metric)

