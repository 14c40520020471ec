"""The engine facade and the native state bridge (counterpart of
``blackhole_simulation_tpu/engine``, but for ``cinema``):

- ``PhysicsEngine`` (facade.py): the compute_*, generate_*_lut, mesh,
  field, tick and integrate_ray_relativistic API;
- ``NativeBridge`` (native.py): the ctypes binding to the C++ seqlock state
  block, camera filter and heartbeat (``native/bridge.cpp``), and
  ``PyBridge``, its Python twin, which ``load_bridge`` returns where no C++
  compiler is available.
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
