"""Single-step geodesic integrators: RKF45, RK4, symplectic implicit midpoint,
and the adaptive step controller.

Counterpart of ``blackhole_simulation_tpu/geodesic/integrator.py``: every
step is a batched map (..., 8) -> (..., 8); the accept/reject decision is a
per-ray mask applied by the driver (``geodesic/integrate.py``,
``geodesic/oracle.py``).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from blackhole_simulation_tpu_torch.geodesic.hamiltonian import (
    state_derivative,
)


class IntegrationMethod(enum.Enum):
    RKF45 = "rkf45"
    RK4 = "rk4"
    SYMPLECTIC = "symplectic"


@dataclasses.dataclass(frozen=True)
class IntegrationOptions:
    """The JAX twin's defaults."""

    method: IntegrationMethod = IntegrationMethod.RKF45
    tolerance: float = 1e-8
    initial_step: float = 1e-2
    max_steps: int = 10_000
    escape_radius: float = 1000.0
    renormalize_interval: int = 10
    min_step: float = 1e-5
    max_step: float = 10.0
    safety: float = 0.9
    horizon_factor: float = 1.001  # terminate at r < factor * r_+


# Fehlberg 4(5) Butcher tableau.
_B21 = 1.0 / 4.0
_B31, _B32 = 3.0 / 32.0, 9.0 / 32.0
_B41, _B42, _B43 = 1932.0 / 2197.0, -7200.0 / 2197.0, 7296.0 / 2197.0
_B51, _B52, _B53, _B54 = 439.0 / 216.0, -8.0, 3680.0 / 513.0, -845.0 / 4104.0
_B61, _B62, _B63, _B64, _B65 = (
    -8.0 / 27.0, 2.0, -3544.0 / 2565.0, 1859.0 / 4104.0, -11.0 / 40.0,
)
# 5th-order solution weights
_C1, _C3, _C4, _C5, _C6 = (
    16.0 / 135.0, 6656.0 / 12825.0, 28561.0 / 56430.0, -9.0 / 50.0, 2.0 / 55.0,
)
# 4th-order solution weights (the embedded error estimate)
_D1, _D3, _D4, _D5 = 25.0 / 216.0, 1408.0 / 2565.0, 2197.0 / 4104.0, -1.0 / 5.0


def rkf45_step(metric, y: torch.Tensor, h: torch.Tensor):
    """One Fehlberg 4(5) step. y: (..., 8), h: (...) -> (y5, err): the
    5th-order state and the max-abs componentwise difference between the
    embedded 4th- and 5th-order solutions."""
    hh = h[..., None]
    k1 = state_derivative(metric, y)
    k2 = state_derivative(metric, y + hh * _B21 * k1)
    k3 = state_derivative(metric, y + hh * (_B31 * k1 + _B32 * k2))
    k4 = state_derivative(metric, y + hh * (_B41 * k1 + _B42 * k2 + _B43 * k3))
    k5 = state_derivative(
        metric, y + hh * (_B51 * k1 + _B52 * k2 + _B53 * k3 + _B54 * k4))
    k6 = state_derivative(
        metric,
        y + hh * (_B61 * k1 + _B62 * k2 + _B63 * k3 + _B64 * k4 + _B65 * k5))
    y5 = y + hh * (_C1 * k1 + _C3 * k3 + _C4 * k4 + _C5 * k5 + _C6 * k6)
    y4 = y + hh * (_D1 * k1 + _D3 * k3 + _D4 * k4 + _D5 * k5)
    err = torch.amax(torch.abs(y5 - y4), dim=-1)
    return y5, err


def rk4_step(metric, y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One classic RK4 step. y: (..., 8), h: (...)."""
    hh = h[..., None]
    k1 = state_derivative(metric, y)
    k2 = state_derivative(metric, y + 0.5 * hh * k1)
    k3 = state_derivative(metric, y + 0.5 * hh * k2)
    k4 = state_derivative(metric, y + hh * k3)
    return y + hh / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def symplectic_step(metric, y: torch.Tensor, h: torch.Tensor,
                    iterations: int = 2) -> torch.Tensor:
    """Implicit midpoint y' = y + h f((y + y') / 2), solved by ``iterations``
    fixed-point rounds from an explicit-Euler seed."""
    hh = h[..., None]
    y_next = y + hh * state_derivative(metric, y)
    for _ in range(iterations):
        y_next = y + hh * state_derivative(metric, 0.5 * (y + y_next))
    return y_next


def step_controller(h: torch.Tensor, err: torch.Tensor, tolerance: float,
                    safety: float = 0.9, min_step: float = 1e-5,
                    max_step: float = 10.0):
    """Per-ray adaptive step law: (accept, h_next). Accept where
    err <= tolerance or h is already at min_step; on accept
    h *= min(safety ratio^-0.2, 5), on reject h *= max(safety ratio^-0.25,
    0.1); h_next clipped to [min_step, max_step]. Every constant is a Python
    float, so the arithmetic stays in h's dtype."""
    ratio = err / tolerance
    at_floor = h <= min_step * (1.0 + 1e-12)
    accept = (ratio <= 1.0) | at_floor
    safe_ratio = torch.clamp(ratio, min=1e-30)
    grow = torch.clamp(safety * safe_ratio ** (-0.2), max=5.0)
    shrink = torch.clamp(safety * safe_ratio ** (-0.25), min=0.1)
    factor = torch.where(accept, grow, shrink)
    h_next = torch.clamp(h * factor, min_step, max_step)
    return accept, h_next
