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
* ``host``, ``leaf``, ``grad_wanted``, ``attach``: a scene's data leaves
  (mass, spin, the camera's r, theta, phi, fov, roll) are numbers or 0-d
  tensors, which may require grad. ``host`` reads a leaf's value for the
  static decisions of the host (tile shapes, caches, the precull switch),
  ``leaf`` makes it a tensor for the arithmetic, keeping its graph,
  ``grad_wanted`` says whether autograd will ask for a derivative, and
  ``attach`` gives a value computed on the host the derivative of its
  tensor twin without changing one bit of it.
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
    """jnp.interp (constant extrapolation) on 1-D tensors, same arithmetic.
    The table reads are ``index_select``s: where the tables carry a graph
    (the spectral disk's, differentiated in spin), their backward adds
    into the short tables with atomics, where advanced indexing's sorts
    each run of a repeated index serially (4 s of a 1080p frame's backward
    on the H100, chip_smoke.py phase 22)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    flat, shape = i.reshape(-1), i.shape
    at = lambda t, j: torch.index_select(t, 0, j).reshape(shape)
    df = at(fp, flat) - at(fp, flat - 1)
    dx = at(xp, flat) - at(xp, flat - 1)
    delta = x - at(xp, flat - 1)
    np_dtype = np.float64 if xp.dtype == torch.float64 else np.float32
    eps = float(np.spacing(np.finfo(np_dtype).eps))
    dx0 = torch.abs(dx) <= eps
    f0 = at(fp, flat - 1)
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
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


def host(x) -> float:
    """A number, or a 0-d tensor's detached value, as a Python float. A
    CUDA tensor's read waits for its stream: in a request that
    ``perf/spans.py`` records it counts one ``stream_syncs``."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            from blackhole_simulation_tpu_torch.perf import spans

            if spans.on:
                spans.count("stream_syncs")
        return float(x.detach())
    return float(x)


def leaf(x, dtype=torch.float32, device=None) -> torch.Tensor:
    """A scene leaf as a 0-d ``dtype`` tensor on ``device``: a tensor is
    cast (keeping its graph; rounded once, as ``torch.tensor(float(x),
    dtype)`` rounds a number), a number is made one."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype).reshape(())
    return torch.tensor(float(x), dtype=dtype, device=device)


def grad_wanted(*xs) -> bool:
    """True when autograd is on and any tensor among ``xs`` requires
    grad."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def attach(value: torch.Tensor, twin: torch.Tensor) -> torch.Tensor:
    """``value`` (computed on the host, no graph) with the gradient of
    ``twin``, a differentiable computation of the same quantity: value +
    (twin - twin.detach()), which adds an exact zero, so the result equals
    ``value`` bit for bit. ``value`` itself where ``twin`` has no graph."""
    if not twin.requires_grad:
        return value
    return value + (twin - twin.detach()).to(value.dtype)
