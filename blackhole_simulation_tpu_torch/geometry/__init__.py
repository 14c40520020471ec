"""Kerr metric scalars on the host (float64)."""

from blackhole_simulation_tpu_torch.geometry.metrics import (
    Kerr,
    kerr_cov_bl,
    kerr_delta,
    kerr_sigma,
)

__all__ = ["Kerr", "kerr_cov_bl", "kerr_delta", "kerr_sigma"]
