"""Light-cone tilt fields from the covariant metric.

Counterpart of ``blackhole_simulation_tpu/spacetime/lightcone.py``: in a
diagonal chart the tilt atan(sqrt(-g_tt / g_rr)); in a non-diagonal one
(Kerr-Schild) the half-opening atan(|s+ - s-| / 2) of the null slopes
dr/dt = (-g_tr +- sqrt(g_tr^2 - g_tt g_rr)) / g_rr; and the (r, theta,
tilt) field. ``metric`` is the port's ``KerrMetric`` (either chart) or any
metric with ``covariant(r, theta)``; on its device.
"""

from __future__ import annotations

import torch


def _on_metric(metric, x):
    ref = getattr(metric, "mass", None)
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    return torch.as_tensor(x, dtype=torch.float64)


def light_cone_tilt(metric, r, theta):
    """Tilt of the local light cone in the (t, r) plane: pi/4 in flat
    space, 0 at a Boyer-Lindquist horizon."""
    g = metric.covariant(_on_metric(metric, r), _on_metric(metric, theta))
    g_tt, g_tr, g_rr = g[..., 0, 0], g[..., 0, 1], g[..., 1, 1]
    diag = torch.abs(g_tr) < 1e-12
    ratio = torch.clamp(-g_tt, min=0.0) / torch.clamp(g_rr, min=1e-12)
    tilt_diag = torch.arctan(torch.sqrt(ratio))
    disc = torch.clamp(g_tr * g_tr - g_tt * g_rr, min=0.0)
    denom = torch.where(torch.abs(g_rr) < 1e-12, 1e-12, g_rr)
    s_plus = (-g_tr + torch.sqrt(disc)) / denom
    s_minus = (-g_tr - torch.sqrt(disc)) / denom
    tilt_skew = torch.arctan(0.5 * torch.abs(s_plus - s_minus))
    return torch.where(diag, tilt_diag, tilt_skew)


def tilt_field(metric, r_grid, theta_grid):
    """The field tilt(r, theta) on the meshgrid (indexing "ij"):
    (r, theta, tilt)."""
    r, th = torch.meshgrid(_on_metric(metric, r_grid),
                           _on_metric(metric, theta_grid), indexing="ij")
    return r, th, light_cone_tilt(metric, r, th)
