"""Performance and observability: the frame monitor, PID and hysteresis
resolution control, the preset benchmark, the feature-cost validator and
march telemetry (counterpart of ``blackhole_simulation_tpu/perf``), and
the spans and counters of the frame path and the inverse step
(``perf/spans.py``), recorded while a torch profiler session is active."""

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

__all__ = [
    "FrameRingBuffer",
    "PIDController",
    "PerformanceMonitor",
    "BenchmarkController",
    "BenchmarkResult",
    "PerformanceValidator",
    "march_telemetry",
]
