"""Neural Radiance Surrogate: the 3 -> 16 -> 16 -> 16 -> 3 tanh MLP that
stands in for the march on far-field rays.

Counterpart of ``blackhole_simulation_tpu/models/nrs.py`` (:32-143):
``NRS_LAYERS``, ``NRS_HIDDEN``, ``nrs_init``, ``nrs_apply``,
``nrs_flat_weights``, ``nrs_from_flat`` and ``nrs_far_field_rows``. The MLP
maps (|b| / 40, theta / pi, a) to (deflection, time delay, escape logit);
the render uses the deflection. Weights are a list of (w (in, out),
b (out,)) float32 pairs; ``nrs_params_from_numpy`` carries the JAX
package's over. Training (``generate_training_data``, ``train_nrs``) labels
its data with the float64 geodesic oracle, which the port does not have
yet, and is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import (
    arccos,
    clip,
    cos,
    div_c,
    maximum,
    sin,
    sqrt,
    tanh,
)

NRS_LAYERS = 4
NRS_HIDDEN = 16
_IN, _OUT = 3, 3
_SIZES = [_IN] + [NRS_HIDDEN] * (NRS_LAYERS - 1) + [_OUT]


def nrs_init(seed: int = 0, device=None):
    """Xavier-style normal init from ``torch.Generator().manual_seed(seed)``
    (zero biases). Deterministic, but not the JAX package's weights:
    ``jax.random``'s stream is not ``torch``'s, so the same seed gives other
    numbers. To run the JAX package's weights, convert them with
    ``nrs_params_from_numpy``."""
    gen = torch.Generator().manual_seed(seed)
    params = []
    for fan_in, fan_out in zip(_SIZES[:-1], _SIZES[1:]):
        scale = math.sqrt(2.0 / (fan_in + fan_out))
        w = torch.randn((fan_in, fan_out), generator=gen) * scale
        params.append((w.to(device), torch.zeros(fan_out, device=device)))
    return params


def nrs_params_from_numpy(params, device=None):
    """The JAX package's NRS weights, a list of (w (in, out), b (out,))
    arrays (numpy, or anything ``np.asarray`` takes), as the port's float32
    tensors on ``device``."""
    as_t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    return [(as_t(w), as_t(b)) for w, b in params]


def nrs_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: x (..., 3) -> (..., 3) = (deflection, delay, escape
    logit); tanh between the layers (through float64, as in the kernel)."""
    h = x
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            h = tanh(h)
    return h


def nrs_flat_weights(params) -> np.ndarray:
    """The single float32 weight buffer: each layer's w (row-major), then
    its b. The render kernel reads this layout from its parameter row."""
    return np.concatenate([
        np.asarray(torch.as_tensor(t).detach().cpu(), np.float32).ravel()
        for w_b in params for t in w_b
    ])


def nrs_from_flat(flat, device=None):
    """Inverse of nrs_flat_weights."""
    flat = np.asarray(flat, np.float32)
    params, off = [], 0
    for fan_in, fan_out in zip(_SIZES[:-1], _SIZES[1:]):
        w = flat[off:off + fan_in * fan_out].reshape(fan_in, fan_out)
        off += fan_in * fan_out
        b = flat[off:off + fan_out]
        off += fan_out
        params.append((torch.as_tensor(w.copy(), device=device),
                       torch.as_tensor(b.copy(), device=device)))
    return params


def nrs_far_field_rows(params, rays_u: torch.Tensor, m, a,
                       b_min: float = 12.0):
    """The far-field march skip: rays whose total impact parameter
    b = sqrt(eta + lambda^2) exceeds ``b_min`` take the surrogate's
    deflection instead of a march, their incoming direction rotated by
    alpha(b) about the orbital-plane normal (Rodrigues).

    ``rays_u``: (8, N) u-chart rows with p_t = -1; ``m``, ``a``: 0-d
    float32 tensors. Returns (far (N,) bool, (dx, dy, dz) deflected
    escape-direction rows)."""
    from blackhole_simulation_tpu_torch.render.shading import (
        escape_direction_u_rows,
    )

    r, u, ph = rays_u[1], rays_u[2], rays_u[3]
    pu, pph = rays_u[6], rays_u[7]
    w = maximum(1.0 - u * u, 1e-12)
    lam = pph
    eta = pu * pu * w + u * u * (pph * pph / w - a * a)
    b = sqrt(maximum(eta + lam * lam, 1e-12))
    far = b > b_min

    rows = tuple(rays_u[i] for i in range(8))
    vx, vy, vz = escape_direction_u_rows(rows, m, a)
    s = sqrt(w)
    px = r * s * cos(ph)
    py = r * s * sin(ph)
    pz = r * u

    theta_row = arccos(clip(u, -1.0, 1.0))
    x_in = torch.stack([div_c(torch.abs(b), 40.0), div_c(theta_row, math.pi),
                        torch.zeros_like(b) + a], dim=-1)
    alpha = nrs_apply(params, x_in)[..., 0]

    nx = py * vz - pz * vy
    ny = pz * vx - px * vz
    nz = px * vy - py * vx
    inv_n = 1.0 / sqrt(maximum(nx * nx + ny * ny + nz * nz, 1e-20))
    nx, ny, nz = nx * inv_n, ny * inv_n, nz * inv_n
    ca = cos(alpha)
    sa = sin(alpha)
    cx = ny * vz - nz * vy
    cy = nz * vx - nx * vz
    cz = nx * vy - ny * vx
    return far, (vx * ca + cx * sa, vy * ca + cy * sa, vz * ca + cz * sa)
