"""Performance and scheduler configuration: the PID gains of the dynamic
resolution, the calibration protocol, the frame budget and the benchmark
and validation protocols.

Counterpart of ``blackhole_simulation_tpu/configs/performance.py``, the
same dict.
"""

from __future__ import annotations

PERFORMANCE_CONFIG = {
    "target_frame_ms": 16.67,          # 60 FPS budget
    "pid_setpoint_fraction": 0.95,     # PID targets 95% of budget (15.8 ms)
    "pid": {"kp": 0.025, "ki": 0.005, "kd": 0.04},
    "pid_deadzone": 0.05,
    "pid_cooldown_s": 0.5,
    "pid_integral_clamp": 10.0,
    "resolution_clamp": (0.25, 2.0),
    "adaptive_resolution": {
        "down_fps": 60.0, "down_after_s": 2.0, "down_factor": 0.9,
        "up_fps": 75.0, "up_after_s": 5.0, "up_factor": 1.1,
        "clamp": (0.5, 1.0),
    },
    "calibration": {"duration_s": 3.0, "demote_below_fps": 30.0},
    "ring_buffer_frames": 90,
    "benchmark": {
        "presets": ("minimal", "balanced", "quality", "cinematic"),
        "seconds_per_preset": 5.0,
        "recommend_fps_tiers": (60.0, 35.0, 24.0),
    },
    "validation": {"warmup_s": 1.0, "measure_s": 5.0,
                   "targets_fps": {"baseline": 75.0, "mobile": 60.0, "desktop": 120.0}},
}
