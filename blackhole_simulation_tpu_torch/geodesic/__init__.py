"""Hamiltonian null-geodesic integration: the float64 oracle layer."""

from blackhole_simulation_tpu_torch.geodesic.hamiltonian import (
    state_derivative,
)
from blackhole_simulation_tpu_torch.geodesic.integrate import (
    TERM_DISK,
    TERM_ESCAPE,
    TERM_HORIZON,
    TERM_MAX_STEPS,
    TERM_NONE,
    TERMINATION_NAMES,
    Trajectory,
    integrate,
    integrate_path,
)
from blackhole_simulation_tpu_torch.geodesic.integrator import (
    IntegrationMethod,
    IntegrationOptions,
    rk4_step,
    rkf45_step,
    step_controller,
    symplectic_step,
)
from blackhole_simulation_tpu_torch.geodesic.invariants import (
    ConstantsOfMotion,
    constants_of_motion,
    hamiltonian,
    renormalize_null,
)
from blackhole_simulation_tpu_torch.geodesic.state import (
    STATE_DIM,
    momentum,
    null_ray,
    pack_state,
    position,
)

__all__ = [
    "STATE_DIM", "null_ray", "pack_state", "position", "momentum",
    "state_derivative", "IntegrationMethod", "IntegrationOptions",
    "rk4_step", "rkf45_step", "step_controller", "symplectic_step",
    "ConstantsOfMotion", "constants_of_motion", "hamiltonian",
    "renormalize_null", "Trajectory", "TERMINATION_NAMES", "TERM_NONE",
    "TERM_HORIZON", "TERM_ESCAPE", "TERM_MAX_STEPS", "TERM_DISK",
    "integrate", "integrate_path",
]
