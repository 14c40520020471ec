"""NaN-safe clamping and state validation.

Counterpart of ``blackhole_simulation_tpu/utils/validate.py``:
``clamp_and_validate`` guards every host parameter on its way to the
device, ``clamp_array`` is its vector form, and ``is_finite_state`` is the
camera's rollback predicate.
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np


def clamp_and_validate(
    value: float,
    lo: float,
    hi: float,
    default: float | None = None,
) -> float:
    """Clamp to [lo, hi]; non-finite input returns ``default`` (or the
    midpoint when no default is given) — validation.ts clampAndValidate."""
    if default is None:
        default = 0.5 * (lo + hi)
    try:
        v = float(value)
    except (TypeError, ValueError):
        return default
    if not math.isfinite(v):
        return default
    return min(max(v, lo), hi)


def clamp_array(values, lo: float, hi: float, default: float = 0.0) -> np.ndarray:
    """Vector form: NaN/Inf entries replaced by ``default``, rest clamped."""
    arr = np.asarray(values, dtype=np.float64)
    out = np.where(np.isfinite(arr), np.clip(arr, lo, hi), default)
    return out


def is_finite_state(values: Iterable[float]) -> bool:
    """True iff every component is finite (the rollback predicate)."""
    return all(math.isfinite(float(v)) for v in values)
