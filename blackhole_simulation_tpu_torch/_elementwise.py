"""Elementwise helpers that keep the plain PyTorch code's rounding equal to
the kernel's and the JAX package's.

* ``div_c``: divide by a constant exactly (IEEE), as each JAX operation
  does on its own. PyTorch's CUDA division by a Python number multiplies by
  the reciprocal instead, which rounds differently.
* ``sqrt``, ``sin``, ``cos``, ``tan``, ``exp``, ``tanh``, ``arccos``, ``pow``:
  correctly rounded (or nearly), by way of float64.
  PyTorch's vectorized CPU float32 sqrt is not always correctly rounded
  (IEEE sqrtf is, on the card and in XLA), and a last-bit difference in a
  ray grows without bound along a chaotic photon-ring orbit; the escape
  direction's sin/cos pick sub-pixel star spots, which turn a last-bit
  difference into a visible one. The kernel uses sqrtf (IEEE) and
  float64 sin/cos; the jets', the NRS MLP's and the overlay's exp, tanh and
  pow go through float64 in both as well.
* ``clip``, ``maximum``: ``jnp.clip`` / ``jnp.maximum`` semantics (NaN
  propagates) for any mix of Python numbers and tensors as bounds. Under
  autograd they go through ``torch.maximum`` / ``torch.minimum``, whose
  gradient splits half and half at ties as JAX's does (``torch.clamp``
  passes the whole gradient to ``x``); the values are the same either way.
* ``interp``: ``jnp.interp`` (constant extrapolation), the same arithmetic.
* ``f64_args``: numbers and arrays as float64 tensors beside the tensors
  among the arguments, for the analytic functions that run where their
  tensor inputs are.
"""

from __future__ import annotations

import numpy as np
import torch


def const(like: torch.Tensor, value) -> torch.Tensor:
    """A 0-dim tensor holding ``value`` in ``like``'s dtype and device."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def div_c(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with c rounded to x's dtype, divided exactly."""
    return x / const(x, c)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(x.dtype)


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).to(x.dtype)


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).to(x.dtype)


def tan(x: torch.Tensor) -> torch.Tensor:
    return torch.tan(x.double()).to(x.dtype)


def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).to(x.dtype)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x.double()).to(x.dtype)


def arccos(x: torch.Tensor) -> torch.Tensor:
    return torch.arccos(x.double()).to(x.dtype)


def pow_(x: torch.Tensor, p: float) -> torch.Tensor:
    """x ** p for a Python float p."""
    return (x.double() ** p).to(x.dtype)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """minimum(maximum(x, lo), hi), as jnp.clip computes it."""
    if (not isinstance(lo, torch.Tensor) and not isinstance(hi, torch.Tensor)
            and not x.requires_grad):
        return torch.clamp(x, lo, hi)
    lo = lo if isinstance(lo, torch.Tensor) else const(x, lo)
    hi = hi if isinstance(hi, torch.Tensor) else const(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def maximum(x: torch.Tensor, y) -> torch.Tensor:
    """jnp.maximum (NaN propagates) against a tensor or a Python number."""
    if isinstance(y, torch.Tensor):
        return torch.maximum(x, y)
    if x.requires_grad:
        return torch.maximum(x, const(x, y))
    return torch.clamp(x, min=y)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp (constant extrapolation) on 1-D tensors, same arithmetic."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    np_dtype = np.float64 if xp.dtype == torch.float64 else np.float32
    eps = float(np.spacing(np.finfo(np_dtype).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def f64_args(*xs):
    """Each argument as a tensor: tensors as they are, numbers and arrays as
    float64 tensors on the device of the first tensor argument (the CPU
    when there is none)."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return tuple(x if isinstance(x, torch.Tensor)
                 else torch.as_tensor(np.asarray(x, np.float64), device=dev)
                 for x in xs)
