"""Elementwise helpers that keep the plain PyTorch code's rounding equal to
the kernel's and the JAX package's.

* ``div_c``: divide by a constant exactly (IEEE), as each JAX operation
  does on its own. PyTorch's CUDA division by a Python number multiplies by
  the reciprocal instead, which rounds differently.
* ``sqrt``, ``sin``, ``cos``, ``exp``, ``tanh``, ``arccos``, ``pow``:
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
"""

from __future__ import annotations

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
