"""Frame-time monitoring and PID-controlled dynamic resolution.

Counterpart of ``blackhole_simulation_tpu/perf/monitor.py``: preallocated
90-frame ring buffers, a PID controller on the frame budget with deadzone,
cooldown and integral clamp, the calibration stress test with its quality
demotion, and the warnings ladder. Host-side; time is injected, so tests
drive it deterministically.
"""

from __future__ import annotations

import time as _time

import numpy as np

from blackhole_simulation_tpu_torch.configs.performance import PERFORMANCE_CONFIG


class FrameRingBuffer:
    """Fixed-capacity float64 ring with O(1) push and vector stats
    (monitor.ts:92-121)."""

    def __init__(self, capacity: int = PERFORMANCE_CONFIG["ring_buffer_frames"]):
        self._buf = np.zeros(capacity, dtype=np.float64)
        self._n = 0
        self._i = 0

    def push(self, value: float) -> None:
        self._buf[self._i] = value
        self._i = (self._i + 1) % len(self._buf)
        self._n = min(self._n + 1, len(self._buf))

    def __len__(self) -> int:
        return self._n

    def values(self) -> np.ndarray:
        return self._buf[: self._n]

    def mean(self) -> float:
        return float(self.values().mean()) if self._n else 0.0

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.values(), q)) if self._n else 0.0

    def minimum(self) -> float:
        return float(self.values().min()) if self._n else 0.0

    def maximum(self) -> float:
        return float(self.values().max()) if self._n else 0.0


class PIDController:
    """PID on frame time -> render-resolution scale (monitor.ts:162-215).

    Positive error (frame too slow) lowers the scale. Deadzone suppresses
    jitter; updates rate-limit by the cooldown; the integral term clamps.
    """

    def __init__(
        self,
        setpoint_ms: float | None = None,
        gains: dict | None = None,
        deadzone: float = PERFORMANCE_CONFIG["pid_deadzone"],
        cooldown_s: float = PERFORMANCE_CONFIG["pid_cooldown_s"],
        clamp: tuple = PERFORMANCE_CONFIG["resolution_clamp"],
    ):
        cfg = PERFORMANCE_CONFIG
        self.setpoint = setpoint_ms or cfg["target_frame_ms"] * cfg["pid_setpoint_fraction"]
        g = gains or cfg["pid"]
        self.kp, self.ki, self.kd = g["kp"], g["ki"], g["kd"]
        self.deadzone = deadzone
        self.cooldown = cooldown_s
        self.clamp = clamp
        self.scale = 1.0
        self._integral = 0.0
        self._prev_error = 0.0
        self._last_update = -1e30

    def update(self, frame_ms: float, now: float) -> float:
        error = (frame_ms - self.setpoint) / self.setpoint
        if abs(error) < self.deadzone:
            return self.scale
        if now - self._last_update < self.cooldown:
            return self.scale
        self._integral = float(
            np.clip(self._integral + error, -PERFORMANCE_CONFIG["pid_integral_clamp"],
                    PERFORMANCE_CONFIG["pid_integral_clamp"])
        )
        derivative = error - self._prev_error
        self._prev_error = error
        delta = self.kp * error + self.ki * self._integral + self.kd * derivative
        self.scale = float(np.clip(self.scale - delta, *self.clamp))
        self._last_update = now
        return self.scale


# Quality tiers, worst to best (simulation.config.ts quality ladder; the
# calibration demotion walks one rung down this list).
QUALITY_LADDER = ("low", "medium", "high", "ultra")


class PerformanceMonitor:
    """Frame/device/host timing + rays/s meter + warnings ladder
    (monitor.ts:70-381). ``clock`` is injectable for deterministic tests."""

    def __init__(self, clock=None):
        self._clock = clock or _time.perf_counter
        self.frame = FrameRingBuffer()
        self.device = FrameRingBuffer()
        self.host = FrameRingBuffer()
        self.pid = PIDController()
        self.rays_per_s = 0.0
        self._last_t = None
        self.warnings: list[str] = []
        # Calibration results (monitor.ts:79-86): the startup stress test
        # caps the quality the adaptive controller may ever promote back to.
        self.max_allowed_quality: str = QUALITY_LADDER[-1]
        self.calibrated_fps: float | None = None

    def calibrate(self, render_frame, quality: str = "high",
                  max_frames: int = 1000, frames_per_call: int = 1) -> str:
        """Startup calibration stress test (monitor.ts:79-86, 148-151,
        235-246): render frames for ``calibration.duration_s`` seconds of
        the injected clock, then demote ``quality`` one tier if the average
        FPS fell below ``calibration.demote_below_fps`` (the reference's
        minStableFPS finalizeCalibration rule). The demoted tier also
        becomes ``max_allowed_quality`` — the cap the adaptive controller
        may never promote past (maxAllowedQuality). Returns the (possibly
        demoted) quality; ``calibrated_fps`` records the measured average.

        The stress frames go to a private ring so they don't pollute
        steady-state statistics; ``max_frames`` bounds the loop when the
        injected clock is driven by ``render_frame`` itself (tests).
        """
        cfg = PERFORMANCE_CONFIG["calibration"]
        ring = FrameRingBuffer()
        t_start = self._clock()
        while (self._clock() - t_start < cfg["duration_s"]
               and len(ring) < max_frames):
            t0 = self._clock()
            render_frame()
            # frames_per_call: a pipelined/batched stress callable renders
            # several frames per call so the measured rate reflects
            # sustained THROUGHPUT, not per-frame round-trip latency (the
            # reference measures steady-state frames too).
            ring.push(max((self._clock() - t0) * 1e3 / frames_per_call,
                          1e-6))
        avg_ms = ring.mean()
        avg_fps = 1e3 / avg_ms if avg_ms > 0 else 0.0
        self.calibrated_fps = avg_fps
        if avg_fps < cfg["demote_below_fps"] and quality in QUALITY_LADDER:
            i = QUALITY_LADDER.index(quality)
            quality = QUALITY_LADDER[max(i - 1, 0)]
        self.max_allowed_quality = quality
        return quality

    def begin_frame(self) -> float:
        return self._clock()

    def end_frame(self, t0: float, n_rays: int = 0, device_ms: float | None = None) -> None:
        now = self._clock()
        frame_ms = (now - t0) * 1e3
        self.frame.push(frame_ms)
        if device_ms is not None:
            self.device.push(device_ms)
            self.host.push(max(frame_ms - device_ms, 0.0))
        if n_rays:
            self.rays_per_s = n_rays / max(now - t0, 1e-9)
        self.pid.update(frame_ms, now)
        self._update_warnings()

    def _update_warnings(self) -> None:
        """30/60-FPS + budget ladder (monitor.ts:344-372)."""
        self.warnings.clear()
        avg = self.frame.mean()
        if avg <= 0:
            return
        fps = 1e3 / avg
        budget = PERFORMANCE_CONFIG["target_frame_ms"]
        if fps < 30.0:
            self.warnings.append("critical: below 30 FPS")
        elif fps < 60.0:
            self.warnings.append("warning: below 60 FPS")
        if avg > budget:
            self.warnings.append(
                f"frame budget exceeded: {avg:.1f} ms > {budget:.2f} ms"
            )

    def get_metrics(self) -> dict:
        avg = self.frame.mean()
        return {
            "fps": 1e3 / avg if avg > 0 else 0.0,
            "frame_ms_avg": avg,
            "frame_ms_p95": self.frame.percentile(95),
            "frame_ms_p99": self.frame.percentile(99),
            "device_ms_avg": self.device.mean(),
            "host_ms_avg": self.host.mean(),
            "rays_per_s": self.rays_per_s,
            "render_scale": self.pid.scale,
            "warnings": list(self.warnings),
        }
