"""``PhysicsEngine``: the scalar, LUT, mesh, field and tick API in one
object.

Counterpart of ``blackhole_simulation_tpu/engine/facade.py``: the horizon,
ISCO, photon sphere and dilation; the disk and spectrum LUTs; the
embedding and ergosphere meshes; the shadow curve, radius and shift; the
disk flux and g-factor; the Kretschmann, frame-drag and light-cone fields,
the Flamm height and proper distance; ``tick`` through the seqlock bridge
(``engine/native.py``); and ``integrate_ray_relativistic`` through the
float64 RKF45 integrator (``geodesic/integrate.py``).

The engine holds float64 ``KerrMetric``s in both charts on its device
(``cuda`` unless the caller passes ``device="cpu"``); the fields, meshes,
g-factor, dilation, Hawking temperature and the ray run there. The disk
and spectrum LUTs, the flux and the shadow curve are host float64 numpy,
as in ``physics/``. Every method returns Python floats and numpy arrays,
as the JAX twin's do.
"""

from __future__ import annotations

import numpy as np
import torch

from blackhole_simulation_tpu_torch.engine.native import load_bridge
from blackhole_simulation_tpu_torch.geodesic import (
    IntegrationMethod,
    IntegrationOptions,
    integrate,
)
from blackhole_simulation_tpu_torch.geometry.metrics import BL, KS, KerrMetric
from blackhole_simulation_tpu_torch.physics import (
    bardeen_shadow,
    generate_blackbody_lut,
    generate_temperature_lut,
    hawking_temperature,
    kerr_g_factor,
    page_thorne_flux,
    schwarzschild_shadow_radius,
)
from blackhole_simulation_tpu_torch.render.pipeline import resolve_device
from blackhole_simulation_tpu_torch.spacetime import (
    curvature_field,
    embedding_mesh,
    ergosphere_mesh,
    flamm_height,
    frame_drag_field,
    proper_distance,
    tilt_field,
)


def _np(*ts):
    return tuple(t.cpu().numpy() for t in ts)


class PhysicsEngine:
    """Owns the Boyer-Lindquist and Kerr-Schild metric pair, the camera
    bridge and every derived-physics entry point."""

    def __init__(self, mass: float = 1.0, spin: float = 0.9,
                 prefer_native: bool = True, device=None):
        self.device = resolve_device(device)
        self._mass = float(mass)
        self._spin = float(spin)
        self.bridge = load_bridge(mass, spin, prefer_native=prefer_native)
        self._rebuild()

    def _rebuild(self) -> None:
        self.kerr_bl = KerrMetric.create(self._mass, self._spin, chart=BL,
                                         device=self.device)
        self.kerr_ks = self.kerr_bl.with_chart(KS)

    def _t(self, x) -> torch.Tensor:
        """A number or array as a float64 tensor on the engine's device."""
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device)

    @property
    def mass(self) -> float:
        return self._mass

    @property
    def spin(self) -> float:
        return self._spin

    def update_parameters(self, mass: float | None = None,
                          spin: float | None = None):
        if mass is not None:
            self._mass = float(mass)
        if spin is not None:
            self._spin = float(spin)
        self.bridge.set_params(self._mass, self._spin)
        self._rebuild()

    # -- scalar radii ------------------------------------------------------
    def compute_horizon(self) -> float:
        return float(self.kerr_bl.event_horizon())

    def compute_isco(self, prograde: bool = True) -> float:
        return float(self.kerr_bl.isco(prograde))

    def compute_photon_sphere(self, prograde: bool = True) -> float:
        return float(self.kerr_bl.photon_sphere(prograde))

    def compute_dilation(self, r: float, theta: float = np.pi / 2) -> float:
        return float(self.kerr_bl.time_dilation(self._t(r), self._t(theta)))

    def compute_hawking_temperature(self, mass_solar: float | None = None
                                    ) -> float:
        return float(hawking_temperature(self._t(mass_solar or self._mass),
                                         self._t(self._spin / self._mass)))

    # -- LUTs ----------------------------------------------------------------
    def generate_disk_lut(self, width: int = 512, mdot: float = 1.0):
        lut, r_in, r_out = generate_temperature_lut(self._mass, self._spin,
                                                    mdot, width)
        return lut, float(r_in), float(r_out)

    def generate_spectrum_lut(self, width: int = 256, height: int = 64):
        return generate_blackbody_lut(width, height)

    # -- meshes --------------------------------------------------------------
    def generate_embedding_mesh(self, n_r: int = 48, n_phi: int = 64):
        return _np(embedding_mesh(self.kerr_bl.mass, self.kerr_bl.spin, n_r,
                                  n_phi))[0]

    def generate_ergosphere_mesh(self, n_theta: int = 32, n_phi: int = 48):
        return _np(ergosphere_mesh(self.kerr_bl.mass, self.kerr_bl.spin,
                                   n_theta, n_phi))[0]

    # -- shadow --------------------------------------------------------------
    def compute_shadow_curve(self, theta_obs: float, n: int = 32):
        alpha, beta, valid = bardeen_shadow(self._mass, self._spin,
                                            theta_obs, n)
        return np.asarray(alpha), np.asarray(beta), np.asarray(valid)

    def compute_shadow_radius(self) -> float:
        return float(schwarzschild_shadow_radius(self._mass))

    def compute_shadow_shift(self, theta_obs: float = np.pi / 2) -> float:
        """Centroid displacement of the critical curve (frame-drag shift)."""
        alpha, _, valid = self.compute_shadow_curve(theta_obs)
        a = alpha[valid]
        return float((a.max() + a.min()) / 2.0) if a.size else 0.0

    # -- disk physics ----------------------------------------------------------
    def compute_disk_flux(self, r: float, mdot: float = 1.0) -> float:
        return float(page_thorne_flux(r, self._mass, self._spin, mdot))

    def compute_g_factor(self, r: float, lam: float = 0.0) -> float:
        return float(kerr_g_factor(self._t(r), self.kerr_bl.mass,
                                   self.kerr_bl.spin, self._t(lam)))

    # -- fields ----------------------------------------------------------------
    def compute_kretschmann_field(self, r_grid, theta_grid):
        return _np(*curvature_field(self.kerr_bl.mass, self.kerr_bl.spin,
                                    self._t(r_grid), self._t(theta_grid)))

    def compute_frame_drag_field(self, r_grid, theta_grid):
        return _np(*frame_drag_field(self.kerr_bl.mass, self.kerr_bl.spin,
                                     self._t(r_grid), self._t(theta_grid)))

    def compute_light_cone_field(self, r_grid, theta_grid,
                                 use_ks: bool = True):
        metric = self.kerr_ks if use_ks else self.kerr_bl
        return _np(*tilt_field(metric, self._t(r_grid), self._t(theta_grid)))

    def compute_flamm_height(self, r: float) -> float:
        return float(flamm_height(self._t(r), self.kerr_bl.mass))

    def compute_proper_distance(self, r_from: float, r_to: float) -> float:
        return float(proper_distance(self._t(r_from), self._t(r_to),
                                     self.kerr_bl.mass, self.kerr_bl.spin))

    # -- tick ------------------------------------------------------------------
    def tick(self, dt: float) -> dict:
        """Advance the camera's kinematics (the bridge) and return the
        camera and physics snapshot with the shadow curve."""
        self.bridge.tick(dt)
        snap = {"camera": self.bridge.camera(),
                "physics": self.bridge.physics()}
        pts, extents = self.bridge.shadow_curve()
        snap["shadow_curve"] = pts
        snap["shadow_extents"] = extents
        return snap

    def input(self, dx: float = 0.0, dy: float = 0.0, zoom: float = 0.0):
        self.bridge.input(dx, dy, zoom)

    def start_heartbeat(self, hz: float = 75.0) -> None:
        self.bridge.start(hz)

    def stop_heartbeat(self) -> None:
        self.bridge.stop()

    # -- one ray in float64 ------------------------------------------------------
    def integrate_ray_relativistic(self, state, max_steps: int = 10_000,
                                   tolerance: float = 1e-8,
                                   use_ks: bool = True,
                                   method: IntegrationMethod =
                                   IntegrationMethod.RKF45):
        metric = self.kerr_ks if use_ks else self.kerr_bl
        opts = IntegrationOptions(method=method, tolerance=tolerance,
                                  max_steps=max_steps)
        traj = integrate(self._t(state), metric, opts)
        return {
            "final_state": traj.final_state.cpu().numpy(),
            "termination": int(traj.termination),
            "steps_taken": int(traj.steps_taken),
            "max_hamiltonian_drift": float(traj.max_hamiltonian_drift),
        }

    def close(self) -> None:
        self.bridge.close()
