"""Host-side utilities: validation, error tracking, caching, idle
detection and device detection (counterpart of
``blackhole_simulation_tpu/utils``)."""

from blackhole_simulation_tpu_torch.utils.cache import (
    Debouncer,
    IdleDetector,
    PhysicsCache,
)
from blackhole_simulation_tpu_torch.utils.device import (
    detect_device,
    recommend_preset,
)
from blackhole_simulation_tpu_torch.utils.errors import ErrorTracker
from blackhole_simulation_tpu_torch.utils.validate import (
    clamp_and_validate,
    is_finite_state,
)

__all__ = [
    "PhysicsCache",
    "Debouncer",
    "IdleDetector",
    "detect_device",
    "recommend_preset",
    "ErrorTracker",
    "clamp_and_validate",
    "is_finite_state",
]
