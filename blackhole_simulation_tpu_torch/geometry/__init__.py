"""Kerr metric scalars: host float64, and differentiable radii."""

from blackhole_simulation_tpu_torch.geometry.metrics import (
    Kerr,
    event_horizon_t,
    isco_t,
    kerr_cov_bl,
    kerr_delta,
    kerr_sigma,
    photon_sphere_t,
)

__all__ = ["Kerr", "event_horizon_t", "isco_t", "kerr_cov_bl", "kerr_delta",
           "kerr_sigma", "photon_sphere_t"]
