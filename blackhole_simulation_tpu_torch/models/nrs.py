"""Neural Radiance Surrogate: the 3 -> 16 -> 16 -> 16 -> 3 tanh MLP that
stands in for the march on far-field rays.

Counterpart of ``blackhole_simulation_tpu/models/nrs.py``: ``NRS_LAYERS``,
``NRS_HIDDEN``, ``nrs_init``, ``nrs_apply``, ``nrs_flat_weights``,
``nrs_from_flat`` and ``nrs_far_field_rows`` (:32-143), and the training
half, ``generate_training_data`` (:146-183) and ``train_nrs`` (:186-214).
The MLP maps (|b| / 40, theta / pi, a) to (deflection, time delay, escape
logit); the render uses the deflection. Weights are a list of
(w (in, out), b (out,)) float32 pairs; ``nrs_init(seed)`` draws the JAX
package's weights for the same seed (``models/threefry.py``), and
``nrs_params_from_numpy`` carries any of the JAX package's over.

The training labels come from the float64 geodesic integrator
(``geodesic/integrate.py``): the whole equatorial ray family is one batch,
integrated where the tensors live. Training is full-batch MSE by autograd
with the JAX package's Adam written out term for term. Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``.
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
from blackhole_simulation_tpu_torch.perf import spans

NRS_LAYERS = 4
NRS_HIDDEN = 16
_IN, _OUT = 3, 3
_SIZES = [_IN] + [NRS_HIDDEN] * (NRS_LAYERS - 1) + [_OUT]


def _device(device):
    from blackhole_simulation_tpu_torch.render.pipeline import resolve_device

    return resolve_device(device)


def nrs_init(seed: int = 0, device=None):
    """Xavier-style normal init with zero biases, on ``device`` (``cuda``
    unless the caller passes ``"cpu"``): the JAX package's ``nrs_init(seed)``
    weights, drawn from ``jax.random``'s threefry stream as
    ``models/threefry.py`` computes it in numpy (about 1.5% of them up to
    3 float32 ulps away)."""
    from blackhole_simulation_tpu_torch.models import threefry

    device = _device(device)
    key = threefry.prng_key(seed)
    params = []
    for fan_in, fan_out in zip(_SIZES[:-1], _SIZES[1:]):
        key, sub = threefry.split(key)
        scale = np.float32(math.sqrt(2.0 / (fan_in + fan_out)))
        w = threefry.normal(sub, (fan_in, fan_out)) * scale
        params.append((torch.from_numpy(w).to(device),
                       torch.zeros(fan_out, device=device)))
    return params


def nrs_params_from_numpy(params, device=None):
    """The JAX package's NRS weights, a list of (w (in, out), b (out,))
    arrays (numpy, or anything ``np.asarray`` takes), as the port's float32
    tensors on ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    device = _device(device)
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
    its b. The render kernel reads this layout from its parameter row.
    Each CUDA tensor's copy to the host waits for its stream: in a frame
    that ``render`` records each counts one ``stream_syncs``
    (``perf/spans.py``)."""
    tensors = [torch.as_tensor(t).detach() for w_b in params for t in w_b]
    if spans.on:
        spans.count("stream_syncs", sum(t.is_cuda for t in tensors))
    return np.concatenate([np.asarray(t.cpu(), np.float32).ravel()
                           for t in tensors])


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


def generate_training_data(n: int = 256, spin_range=(-0.99, 0.99),
                           b_range=(3.0, 40.0), r0: float = 200.0,
                           seed: int = 0, device=None):
    """Oracle-labelled dataset of the equatorial ray family: inputs
    (b / b_range[1], theta / pi, a) and targets (deflection, time delay
    against flat space / 50, escaped flag), float32 (n, 3) tensors on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    b and a are drawn from ``np.random.default_rng(seed)`` as the JAX
    package draws them, so the inputs are bit-equal to its. All n rays are
    integrated as one batch in float64: a Kerr-Schild metric whose spin is
    the (n,) tensor of draws, rays born at (0, r0, pi/2, 0) with
    p = (-1, 0, b) projected onto the null cone, RKF45 to termination
    (30,000 steps, escape at 1.5 r0). The labels are the JAX package's
    (nrs.py:161-176), in float64, then rounded."""
    from blackhole_simulation_tpu_torch.geodesic import (
        TERM_ESCAPE,
        IntegrationOptions,
        integrate,
        null_ray,
    )
    from blackhole_simulation_tpu_torch.geometry.metrics import (
        KS,
        KerrMetric,
    )

    device = _device(device)
    rng = np.random.default_rng(seed)
    b = rng.uniform(*b_range, n)
    a = rng.uniform(*spin_range, n)
    theta = np.full(n, np.pi / 2)

    f64 = dict(dtype=torch.float64, device=device)
    b_t = torch.tensor(b, **f64)
    bh = KerrMetric.create(1.0, torch.tensor(a, **f64), chart=KS,
                           device=device)
    zero = torch.zeros_like(b_t)
    x = torch.stack([zero, zero + r0, zero + math.pi / 2, zero], dim=-1)
    y0 = null_ray(x, torch.stack([zero - 1.0, zero, b_t], dim=-1), bh)
    traj = integrate(y0, bh, IntegrationOptions(max_steps=30_000,
                                                escape_radius=r0 * 1.5))
    fin = traj.final_state
    esc = traj.termination == TERM_ESCAPE
    r_out = fin[:, 1]
    out_angle = torch.arctan2(fin[:, 7] / r_out, fin[:, 5])
    in_angle = (torch.arcsin(torch.clamp(torch.abs(b_t) / r0, 0.0, 1.0))
                * torch.sign(b_t))
    deflection = torch.where(esc, fin[:, 3] + out_angle + in_angle - math.pi,
                             0.0)
    delay = torch.where(esc, fin[:, 0] - (r_out - r0), 0.0)
    x_in = np.stack([b / b_range[1], theta / np.pi, a], axis=-1).astype(
        np.float32)
    y = torch.stack([deflection, delay / 50.0, esc.to(torch.float64)],
                    dim=-1).to(torch.float32)
    return torch.from_numpy(x_in).to(device), y


def train_nrs(x, y, n_steps: int = 500, lr: float = 3e-3, seed: int = 0, *,
              params=None, device=None):
    """Full-batch Adam on the MSE of ``nrs_apply(params, x)`` against ``y``:
    (params, loss history), the loss recorded at step 1 and every 50th, as
    the JAX package records it. Starts from ``nrs_init(seed)`` unless
    ``params`` are given (e.g. the JAX package's weights through
    ``nrs_params_from_numpy``). The Adam update is the JAX package's term
    for term (nrs.py:198-207): m = 0.9 m + 0.1 g, v = 0.999 v + 0.001 g^2,
    the bias corrections, then p - lr m_hat / (sqrt(v_hat) + 1e-8) (not
    ``torch.optim.Adam``, which folds the corrections into the step size).
    Runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    device = _device(device)
    x = torch.as_tensor(x, device=device)
    y = torch.as_tensor(y, device=device)
    if params is None:
        params = nrs_init(seed, device)
    leaves = [t.detach().to(device).clone().requires_grad_(True)
              for pair in params for t in pair]
    opt_m = [torch.zeros_like(p) for p in leaves]
    opt_v = [torch.zeros_like(p) for p in leaves]
    pairs = lambda ts: [(ts[i], ts[i + 1]) for i in range(0, len(ts), 2)]
    losses = []
    for t in range(1, n_steps + 1):
        loss = torch.mean((nrs_apply(pairs(leaves), x) - y) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            bc1, bc2 = 1 - 0.9 ** float(t), 1 - 0.999 ** float(t)
            for i, (p, g) in enumerate(zip(leaves, grads)):
                opt_m[i] = 0.9 * opt_m[i] + 0.1 * g
                opt_v[i] = 0.999 * opt_v[i] + 0.001 * g * g
                mhat = div_c(opt_m[i], bc1)
                vhat = div_c(opt_v[i], bc2)
                p.sub_(lr * mhat / (sqrt(vhat) + 1e-8))
        if t % 50 == 0 or t == 1:
            losses.append(float(loss.detach()))
    return [(w.detach(), b.detach()) for w, b in pairs(leaves)], losses
