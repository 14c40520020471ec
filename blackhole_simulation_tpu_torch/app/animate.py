"""The frame loop: the host-side animation driver.

Counterpart of ``blackhole_simulation_tpu/app/animate.py``. Each
``tick()``

 1. smooths dt with an EMA and gates runaway frames,
 2. reports idle when no input arrived for 3 s,
 3. steps the camera (the rig's kinematics or a cinematic director),
 4. updates the adaptive-resolution controller from the smoothed FPS,
 5. renders a frame at that scale through an injected
    ``render_fn(camera, scale) -> image`` (so tests drive it with a stub),
 6. resolves it into the temporal accumulator (``render/accumulate.py``;
    a moving camera reprojects the history),
 7. feeds the performance monitor.

A frame is a tensor, or anything ``torch.as_tensor`` takes; it stays on
its device, and so do the accumulator's history and ``last_frame``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from blackhole_simulation_tpu_torch.engine.cinema import DIRECTORS, CameraRig
from blackhole_simulation_tpu_torch.perf.adaptive_resolution import (
    AdaptiveResolutionController,
)
from blackhole_simulation_tpu_torch.perf.monitor import PerformanceMonitor
from blackhole_simulation_tpu_torch.render.accumulate import TemporalAccumulator


@dataclasses.dataclass
class FrameReport:
    index: int
    dt_smoothed: float
    fps: float
    render_scale: float
    idle: bool
    camera: tuple[float, float, float]


class AnimationDriver:
    """Drives frames from a camera source (rig or director) through a
    render function, with EMA dt smoothing, idle throttling, adaptive
    resolution, temporal accumulation, and performance monitoring."""

    EMA_ALPHA = 0.1            # dt smoothing (useAnimation.ts:221-225)
    MAX_RAW_DT = 0.1           # frame gate: clamp spiral-of-death dts
    IDLE_AFTER_S = 3.0         # idle threshold (physics.worker.ts:31-33)
    IDLE_FPS = 30.0            # idle throttle target (useAnimation.ts)

    def __init__(
        self,
        render_fn: Callable[[tuple[float, float, float], float], torch.Tensor],
        director: str | None = None,
        rig: CameraRig | None = None,
        clock: Callable[[], float] = time.monotonic,
        adaptive: bool = True,
        fov: float = 0.5,
    ):
        self.render_fn = render_fn
        self.fov = fov  # for history reprojection (accumulate.reproject_uv)
        self.director = DIRECTORS[director] if director else None
        self.rig = rig or CameraRig()
        self.clock = clock
        self.monitor = PerformanceMonitor(clock=clock)
        self.resolution = AdaptiveResolutionController() if adaptive else None
        self.accumulator = TemporalAccumulator()
        self.frame_index = 0
        self.sim_time = 0.0
        self._dt_smoothed = 1.0 / 60.0
        self._last_t: float | None = None
        self._last_input_t = clock()
        self.last_frame: torch.Tensor | None = None

    # -- input plumbing (marks the session non-idle) --
    def input(self, dx: float = 0.0, dy: float = 0.0, zoom: float = 1.0) -> None:
        self.rig.drag(dx, dy)
        if zoom != 1.0:
            self.rig.zoom(zoom)
        self._last_input_t = self.clock()

    @property
    def idle(self) -> bool:
        return self.clock() - self._last_input_t > self.IDLE_AFTER_S

    def _camera(self) -> tuple[float, float, float]:
        if self.director is not None:
            return self.director(self.sim_time)
        s = self.rig.step(self._dt_smoothed)
        return (s.r, s.theta, s.phi)

    def tick(self) -> FrameReport:
        now = self.clock()
        raw_dt = (
            1.0 / 60.0 if self._last_t is None else min(now - self._last_t, self.MAX_RAW_DT)
        )
        self._last_t = now
        self._dt_smoothed += self.EMA_ALPHA * (raw_dt - self._dt_smoothed)
        self.sim_time += raw_dt

        idle = self.idle and self.director is None
        cam = self._camera()
        camera_moving = self.director is not None or (
            abs(self.rig.state.v_phi) + abs(self.rig.state.v_theta) > 1e-4
        )

        scale = 1.0
        if self.resolution is not None:
            fps = 1.0 / max(self._dt_smoothed, 1e-6)
            scale = self.resolution.update(fps, now)

        t0 = self.monitor.begin_frame()
        frame = torch.as_tensor(self.render_fn(cam, scale))
        # Moving frames REPROJECT the history through the camera delta
        # (accumulate.taa_resolve_reprojected) instead of resetting it.
        frame = self.accumulator.resolve(
            frame, moving=camera_moving,
            camera=(cam[0], cam[1], cam[2], self.fov, 0.0),
        )
        self.monitor.end_frame(t0, n_rays=int(frame.shape[0] * frame.shape[1]))
        self.last_frame = frame
        self.frame_index += 1

        return FrameReport(
            index=self.frame_index,
            dt_smoothed=self._dt_smoothed,
            fps=1.0 / max(self._dt_smoothed, 1e-6),
            render_scale=scale,
            idle=idle,
            camera=cam,
        )

    def run(self, n_frames: int, realtime: bool = False) -> list[FrameReport]:
        """Render ``n_frames``; with ``realtime`` the loop sleeps to the idle
        throttle when idle (offline rendering never sleeps)."""
        reports = []
        for _ in range(n_frames):
            rep = self.tick()
            reports.append(rep)
            if realtime and rep.idle:
                time.sleep(max(1.0 / self.IDLE_FPS - rep.dt_smoothed, 0.0))
        return reports
