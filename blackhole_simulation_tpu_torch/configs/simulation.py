"""Simulation parameter schema, presets, and the scene they build.

Counterpart of ``blackhole_simulation_tpu/configs/simulation.py``:
``ParamSpec``, ``PARAMETER_SCHEMA``, ``QUALITY_RAY_STEPS``,
``SimulationParams``, ``clamp_params``, ``PRESETS``, ``apply_preset``,
``detect_preset`` and ``scene_from_params`` (:157-212), the bridge from the
CLI's parameters (``cli render --set enable_jets=1``) to a render Scene.
Where the JAX package turns on the fused kernel path (``use_pallas``,
``fused``, ``approx_recip``) on a TPU, the port turns it on when the
resolved device is CUDA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    default: float
    min: float
    max: float
    step: float
    unit: str
    label: str


# The schema: default, min, max, step, unit and label of each parameter.
PARAMETER_SCHEMA: dict[str, ParamSpec] = {
    "mass": ParamSpec(1.0, 0.1, 10.0, 0.1, "M_sun(scaled)", "Black-hole mass"),
    "spin": ParamSpec(0.9, -0.99, 0.99, 0.01, "a/M", "Dimensionless spin"),
    "camera_distance": ParamSpec(30.0, 6.0, 200.0, 1.0, "M", "Camera radius"),
    "inclination": ParamSpec(
        math.pi / 2 - 0.25, 0.01, math.pi - 0.01, 0.01, "rad", "Camera inclination"
    ),
    "fov": ParamSpec(0.5, 0.05, 1.5, 0.01, "rad", "Field of view"),
    "disk_outer_radius": ParamSpec(18.0, 4.0, 60.0, 0.5, "M", "Disk outer radius"),
    "disk_density": ParamSpec(0.7, 0.0, 1.0, 0.01, "", "Disk density"),
    "disk_temperature": ParamSpec(9000.0, 2000.0, 30000.0, 100.0, "K", "Disk peak temperature"),
    "disk_turbulence": ParamSpec(0.6, 0.0, 1.0, 0.01, "", "Disk turbulence"),
    "beaming": ParamSpec(4.0, 0.0, 6.0, 0.1, "", "Beaming exponent"),
    "render_scale": ParamSpec(1.0, 0.25, 2.0, 0.05, "", "Render resolution scale"),
    "exposure": ParamSpec(1.0, 0.1, 4.0, 0.05, "", "Exposure"),
}

# Quality tier -> ray-step budget (hard cap 500).
QUALITY_RAY_STEPS: dict[str, int] = {
    "off": 0,
    "low": 32,
    "medium": 64,
    "high": 128,
    "ultra": 256,
}
MAX_RAY_STEPS = 500


@dataclasses.dataclass(frozen=True)
class SimulationParams:
    """A validated, clamped parameter set (plain floats: the UI/CLI state).
    ``quality`` selects the ray-step budget."""

    mass: float = PARAMETER_SCHEMA["mass"].default
    spin: float = PARAMETER_SCHEMA["spin"].default
    camera_distance: float = PARAMETER_SCHEMA["camera_distance"].default
    inclination: float = PARAMETER_SCHEMA["inclination"].default
    fov: float = PARAMETER_SCHEMA["fov"].default
    disk_outer_radius: float = PARAMETER_SCHEMA["disk_outer_radius"].default
    disk_density: float = PARAMETER_SCHEMA["disk_density"].default
    disk_temperature: float = PARAMETER_SCHEMA["disk_temperature"].default
    disk_turbulence: float = PARAMETER_SCHEMA["disk_turbulence"].default
    beaming: float = PARAMETER_SCHEMA["beaming"].default
    render_scale: float = PARAMETER_SCHEMA["render_scale"].default
    exposure: float = PARAMETER_SCHEMA["exposure"].default
    quality: str = "ultra"
    enable_disk: bool = True
    enable_jets: bool = False
    enable_starfield: bool = True
    enable_photon_ring: bool = True
    enable_bloom: bool = True


def clamp_params(params: SimulationParams) -> SimulationParams:
    """NaN-safe clamping of every schema field: non-finite values fall back
    to the schema default, finite ones clamp to [min, max]; an unknown
    quality becomes "medium"."""
    updates: dict[str, Any] = {}
    for name, spec in PARAMETER_SCHEMA.items():
        v = getattr(params, name)
        if not math.isfinite(v):
            updates[name] = spec.default
        else:
            updates[name] = min(max(v, spec.min), spec.max)
    if params.quality not in QUALITY_RAY_STEPS:
        updates["quality"] = "medium"
    return dataclasses.replace(params, **updates)


# The preset table: four tiers.
PRESETS: dict[str, dict[str, Any]] = {
    "minimal": {
        "quality": "low",
        "enable_disk": False,
        "enable_starfield": True,
        "enable_photon_ring": False,
        "enable_bloom": False,
        "render_scale": 0.5,
    },
    "balanced": {
        "quality": "medium",
        "enable_disk": True,
        "enable_starfield": True,
        "enable_photon_ring": True,
        "enable_bloom": False,
        "render_scale": 0.75,
    },
    "quality": {
        "quality": "high",
        "enable_disk": True,
        "enable_starfield": True,
        "enable_photon_ring": True,
        "enable_bloom": True,
        "render_scale": 1.0,
    },
    "cinematic": {
        "quality": "ultra",
        "enable_disk": True,
        "enable_starfield": True,
        "enable_photon_ring": True,
        "enable_bloom": True,
        "render_scale": 1.0,
        "exposure": 1.2,
    },
}


def apply_preset(params: SimulationParams, name: str) -> SimulationParams:
    """Apply a preset on top of the current params."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return clamp_params(dataclasses.replace(params, **PRESETS[name]))


def detect_preset(params: SimulationParams) -> str | None:
    """The name of the preset the params exactly match, else None."""
    for name, overrides in PRESETS.items():
        if all(getattr(params, k) == v for k, v in overrides.items()):
            return name
    return None


def scene_from_params(params: SimulationParams, width: int = 512,
                      height: int = 512, device=None):
    """A render Scene from validated params: the camera, the disk, the
    feature toggles (jets require the disk) and the production
    MarchConfig (precull, step rate 0.2, far-field cap, one midpoint
    iteration), with the kernel path on where ``device`` resolves to CUDA
    (``render/pipeline.resolve_device``: CUDA unless ``device="cpu"``)."""
    from blackhole_simulation_tpu_torch.render import (
        Camera,
        DiskParams,
        Features,
        MarchConfig,
        PostParams,
        Scene,
    )
    from blackhole_simulation_tpu_torch.render.pipeline import resolve_device

    p = clamp_params(params)
    w = max(int(width * p.render_scale), 8)
    h = max(int(height * p.render_scale), 8)
    cam = Camera.create(
        r=p.camera_distance, theta=p.inclination, fov=p.fov, width=w, height=h
    )
    steps = QUALITY_RAY_STEPS[p.quality] or 32
    on_gpu = resolve_device(device).type == "cuda"
    return Scene.create(
        mass=p.mass,
        spin=p.spin,
        camera=cam,
        disk=DiskParams(
            outer_radius=p.disk_outer_radius,
            density=p.disk_density,
            t_peak=p.disk_temperature,
            turbulence=p.disk_turbulence,
            beaming_exponent=p.beaming,
        ),
        features=Features(
            disk=p.enable_disk,
            jets=p.enable_jets and p.enable_disk,
            starfield=p.enable_starfield,
            photon_ring_glow=p.enable_photon_ring,
        ),
        march_cfg=MarchConfig(
            max_steps=min(steps, MAX_RAY_STEPS),
            use_pallas=on_gpu,
            fused=on_gpu,
            shadow_precull=True,
            step_rate=0.2,
            far_step_cap_rate=0.4,
            far_boost_radius=20.0,
            approx_recip=on_gpu,
            midpoint_iters=1,
        ),
        post=PostParams(exposure=p.exposure, bloom_enabled=p.enable_bloom),
    )
