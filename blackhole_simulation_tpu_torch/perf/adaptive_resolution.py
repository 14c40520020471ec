"""Adaptive render-resolution controller (hysteresis law).

Counterpart of ``blackhole_simulation_tpu/perf/adaptive_resolution.py``:
the scale steps down 10 % after 2 s below 60 FPS and up 10 % after 5 s
above 75 FPS, within [0.5, 1.0], and approaches its target smoothly. The
fine-grained PID loop lives in ``perf/monitor.PIDController``.
"""

from __future__ import annotations

import dataclasses

from blackhole_simulation_tpu_torch.configs.performance import PERFORMANCE_CONFIG


@dataclasses.dataclass
class AdaptiveResolutionConfig:
    low_fps: float = 60.0
    high_fps: float = 75.0
    low_hold_s: float = 2.0      # sustained-low window before stepping down
    high_hold_s: float = 5.0     # sustained-high window before stepping up
    step: float = 0.10
    min_scale: float = 0.5
    max_scale: float = 1.0
    smooth_rate: float = 4.0     # 1/s exponential approach to target


class AdaptiveResolutionController:
    """FPS-driven hysteresis controller. Feed ``update(fps, now)`` once per
    frame; read ``scale`` (smoothed) or ``target_scale`` (stepped)."""

    def __init__(self, cfg: AdaptiveResolutionConfig | None = None):
        self.cfg = cfg or AdaptiveResolutionConfig()
        self.target_scale = self.cfg.max_scale
        self.scale = self.cfg.max_scale
        self._low_since: float | None = None
        self._high_since: float | None = None
        self._last_t: float | None = None

    def reset(self) -> None:
        self.__init__(self.cfg)

    def update(self, fps: float, now: float) -> float:
        cfg = self.cfg
        dt = 0.0 if self._last_t is None else max(now - self._last_t, 0.0)
        self._last_t = now

        if fps < cfg.low_fps:
            self._high_since = None
            if self._low_since is None:
                self._low_since = now
            elif now - self._low_since >= cfg.low_hold_s:
                self.target_scale = max(
                    cfg.min_scale, round(self.target_scale - cfg.step, 4)
                )
                self._low_since = now  # restart the window after a step
        elif fps > cfg.high_fps:
            self._low_since = None
            if self._high_since is None:
                self._high_since = now
            elif now - self._high_since >= cfg.high_hold_s:
                self.target_scale = min(
                    cfg.max_scale, round(self.target_scale + cfg.step, 4)
                )
                self._high_since = now
        else:
            self._low_since = None
            self._high_since = None

        # Smooth interpolation toward the target (adaptive-resolution.ts's
        # lerp-per-frame, expressed frame-rate independently).
        if dt > 0.0:
            import math

            alpha = 1.0 - math.exp(-cfg.smooth_rate * dt)
            self.scale += (self.target_scale - self.scale) * alpha
        self.scale = min(max(self.scale, cfg.min_scale), cfg.max_scale)
        return self.scale

    def scaled_dims(self, width: int, height: int) -> tuple[int, int]:
        """Render dimensions at the current scale, 8-aligned."""
        w = max(8, int(width * self.scale) // 8 * 8)
        h = max(8, int(height * self.scale) // 8 * 8)
        return w, h


def recommended_initial_scale(device_kind: str | None = None) -> float:
    """Hardware-tier initial scale (docs/PERFORMANCE.md:68-72 tiering:
    LOW 0.5-0.7x / MED 1.0x / ULTRA 1.0-2.0x), keyed on the accelerator
    platform instead of a GPU model string."""
    kind = (device_kind or "").lower()
    if "cpu" in kind or kind == "":
        return 0.5
    return 1.0


__all__ = [
    "AdaptiveResolutionConfig",
    "AdaptiveResolutionController",
    "recommended_initial_scale",
    "PERFORMANCE_CONFIG",
]
