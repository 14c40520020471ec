"""Kerr geometry: host float64 scalars and differentiable radii for the
render path; tensor metrics, tensor algebra and radii for the oracle."""

from blackhole_simulation_tpu_torch.geometry import radii
from blackhole_simulation_tpu_torch.geometry.metrics import (
    BL,
    KS,
    Kerr,
    KerrMetric,
    Metric,
    Minkowski,
    Schwarzschild,
    event_horizon_t,
    isco_t,
    photon_sphere_t,
)
from blackhole_simulation_tpu_torch.geometry.tensor import (
    christoffel,
    contract,
    determinant,
    lower_index,
    raise_index,
)

__all__ = ["BL", "KS", "Kerr", "KerrMetric", "Metric", "Minkowski", "Schwarzschild",
           "christoffel", "contract", "determinant", "event_horizon_t",
           "isco_t", "lower_index", "photon_sphere_t", "raise_index", "radii"]
