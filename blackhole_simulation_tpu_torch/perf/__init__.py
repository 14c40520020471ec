"""Performance and observability: the frame monitor, PID and hysteresis
resolution control, the preset benchmark, the feature-cost validator,
device timing and march telemetry (counterpart of
``blackhole_simulation_tpu/perf``)."""

from blackhole_simulation_tpu_torch.perf.monitor import (
    FrameRingBuffer,
    PIDController,
    PerformanceMonitor,
)
from blackhole_simulation_tpu_torch.perf.benchmark import (
    BenchmarkController,
    BenchmarkResult,
)
from blackhole_simulation_tpu_torch.perf.validator import PerformanceValidator
from blackhole_simulation_tpu_torch.perf.telemetry import march_telemetry
from blackhole_simulation_tpu_torch.perf.timer import DeviceTimer

__all__ = [
    "FrameRingBuffer",
    "PIDController",
    "PerformanceMonitor",
    "BenchmarkController",
    "BenchmarkResult",
    "PerformanceValidator",
    "march_telemetry",
    "DeviceTimer",
]
