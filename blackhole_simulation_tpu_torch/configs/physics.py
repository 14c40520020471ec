"""Physics tuning constants of the march, the disk and the oracle.

Counterpart of ``blackhole_simulation_tpu/configs/physics.py``, the same
dict: the defaults of ``MarchConfig``, ``DiskParams`` and the oracle's
options, gathered for the readout.
"""

from __future__ import annotations

PHYSICS_CONSTANTS = {
    "ray_marching": {
        "min_step": 5e-3,          # MIN_STEP (physics.config.ts rayMarching)
        "max_step": 4.0,           # MAX_STEP
        "step_rate": 0.12,         # curvature-adaptive rate vs (r - r_h)
        "escape_radius": 120.0,    # MAX_DIST analogue (camera-scale)
        "horizon_threshold": 1.01, # horizon stop factor (reference 1.15 visual)
        "hard_step_cap": 500,      # fragment.glsl.ts:115
    },
    "disk": {
        "g_factor_clip": (0.05, 5.0),   # LUT g-range (spectrum.rs:76-102)
        "temperature_clip": (1000.0, 40000.0),
        "nt_peak_x": 49.0 / 36.0,       # argmax of the zero-torque profile
    },
    "oracle": {
        "tolerance": 1e-8,         # RKF45 local error (integrator.rs:38-45)
        "max_steps": 10_000,
        "escape_radius": 1000.0,
        "renormalize_interval": 10,
    },
}
