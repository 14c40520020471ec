"""The engine facade, the native state bridge and the camera directors
(counterpart of ``blackhole_simulation_tpu/engine``):

- ``PhysicsEngine`` (facade.py): the compute_*, generate_*_lut, mesh,
  field, tick and integrate_ray_relativistic API;
- ``NativeBridge`` (native.py): the ctypes binding to the C++ seqlock state
  block, camera filter and heartbeat (``native/bridge.cpp``), and
  ``PyBridge``, its Python twin, which ``load_bridge`` returns where no C++
  compiler is available;
- ``CameraRig``, ``grand_survey``, ``descent`` and ``director_track``
  (cinema.py): the orbit camera and the cinematic directors, host float64.
"""

from blackhole_simulation_tpu_torch.engine.facade import PhysicsEngine
from blackhole_simulation_tpu_torch.engine.native import (
    CAMERA_OFFSET,
    CONTROL_OFFSET,
    LUTS_OFFSET,
    PHYSICS_OFFSET,
    TELEMETRY_OFFSET,
    NativeBridge,
    PyBridge,
    load_bridge,
)

__all__ = [
    "CAMERA_OFFSET",
    "CONTROL_OFFSET",
    "LUTS_OFFSET",
    "PHYSICS_OFFSET",
    "TELEMETRY_OFFSET",
    "NativeBridge",
    "PyBridge",
    "load_bridge",
    "PhysicsEngine",
]
