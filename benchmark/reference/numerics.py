"""Elementwise helpers and the Kerr radii (frozen from the port's
``_elementwise.py`` and ``geometry/metrics.py``): transcendentals through
float64 and rounded once to the argument's dtype."""

from __future__ import annotations

import numpy as np
import torch


def const(like: torch.Tensor, value) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def div_c(x: torch.Tensor, c: float) -> torch.Tensor:
    return x / const(x, c)


def _f64(fn, x):
    return fn(x.double()).to(x.dtype)


def sqrt(x):
    return _f64(torch.sqrt, x)


def sin(x):
    return _f64(torch.sin, x)


def cos(x):
    return _f64(torch.cos, x)


def exp(x):
    return _f64(torch.exp, x)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """minimum(maximum(x, lo), hi)."""
    if (not isinstance(lo, torch.Tensor) and not isinstance(hi, torch.Tensor)
            and not x.requires_grad):
        return torch.clamp(x, lo, hi)
    lo = lo if isinstance(lo, torch.Tensor) else const(x, lo)
    hi = hi if isinstance(hi, torch.Tensor) else const(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def maximum(x: torch.Tensor, y) -> torch.Tensor:
    if isinstance(y, torch.Tensor):
        return torch.maximum(x, y)
    if x.requires_grad:
        return torch.maximum(x, const(x, y))
    return torch.clamp(x, min=y)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """np.interp with constant extrapolation on 1-D tensors."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    np_dtype = np.float64 if xp.dtype == torch.float64 else np.float32
    eps = float(np.spacing(np.finfo(np_dtype).eps))
    dx0 = torch.abs(dx) <= eps
    f0 = fp[i - 1]
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _cbrt(x):
    return _f64(lambda v: torch.clamp(v, min=0.0) ** (1.0 / 3.0), x)


def event_horizon(m, a):
    """r+ = M + sqrt(M^2 - a^2), in the dtype of the 0-d tensors m, a."""
    return m + _f64(torch.sqrt, torch.clamp(m * m - a * a, min=0.0))


def _spin_ratio(m, a):
    return torch.abs(torch.clamp(a / m, -1.0, 1.0))


def photon_sphere(m, a):
    """The prograde equatorial photon orbit 2M{1 + cos[(2/3) acos(-|a*|)]}."""
    angle = (2.0 / 3.0) * _f64(torch.arccos, -_spin_ratio(m, a))
    return 2.0 * m * (1.0 + _f64(torch.cos, angle))


def isco(m, a):
    """The prograde Bardeen-Press-Teukolsky ISCO."""
    s = _spin_ratio(m, a)
    z1 = 1.0 + _cbrt(1.0 - s * s) * (_cbrt(1.0 + s) + _cbrt(1.0 - s))
    z2 = _f64(torch.sqrt, 3.0 * (s * s) + z1 * z1)
    root = _f64(torch.sqrt, torch.clamp((3.0 - z1) * (3.0 + z1 + 2.0 * z2),
                                        min=0.0))
    return m * (3.0 + z2 - root)
