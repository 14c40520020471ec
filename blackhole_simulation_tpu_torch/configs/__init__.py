"""Configuration: the simulation parameter schema, presets and
``scene_from_params``, the physics constants and the performance
configuration."""

from blackhole_simulation_tpu_torch.configs.simulation import (
    MAX_RAY_STEPS,
    PARAMETER_SCHEMA,
    PRESETS,
    QUALITY_RAY_STEPS,
    ParamSpec,
    SimulationParams,
    apply_preset,
    clamp_params,
    detect_preset,
    scene_from_params,
)
from blackhole_simulation_tpu_torch.configs.physics import PHYSICS_CONSTANTS
from blackhole_simulation_tpu_torch.configs.performance import (
    PERFORMANCE_CONFIG,
)

__all__ = [
    "MAX_RAY_STEPS", "PARAMETER_SCHEMA", "PRESETS", "QUALITY_RAY_STEPS",
    "ParamSpec", "SimulationParams", "apply_preset", "clamp_params",
    "detect_preset", "scene_from_params", "PHYSICS_CONSTANTS",
    "PERFORMANCE_CONFIG",
]
