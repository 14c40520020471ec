"""Performance validation: the baseline, the cost of each feature, and a
JSON report.

Counterpart of ``blackhole_simulation_tpu/perf/validator.py``: a baseline
with every feature off, then each feature alone (warm-up, then measure:
avg/min/max/p95/p99), the FPS targets, and recommendations. The frame and
the clock are injected.
"""

from __future__ import annotations

import dataclasses
import json
import time as _time

import numpy as np

from blackhole_simulation_tpu_torch.configs.performance import PERFORMANCE_CONFIG
from blackhole_simulation_tpu_torch.configs.simulation import SimulationParams


_FEATURES = ("enable_disk", "enable_starfield", "enable_photon_ring", "enable_bloom")


@dataclasses.dataclass(frozen=True)
class MeasuredConfig:
    name: str
    frame_ms_avg: float
    frame_ms_min: float
    frame_ms_max: float
    frame_ms_p95: float
    frame_ms_p99: float
    fps: float
    frames: int


class PerformanceValidator:
    def __init__(self, render_frame, clock=None,
                 warmup_s: float | None = None, measure_s: float | None = None):
        cfg = PERFORMANCE_CONFIG["validation"]
        self._render = render_frame
        self._clock = clock or _time.perf_counter
        self._warmup = cfg["warmup_s"] if warmup_s is None else warmup_s
        self._measure = cfg["measure_s"] if measure_s is None else measure_s

    def _measure_config(self, name: str, params: SimulationParams) -> MeasuredConfig:
        """1 s warmup + 5 s measure (validation.ts:68-69)."""
        start = self._clock()
        while self._clock() - start < self._warmup:
            self._render(params)
        times = []
        start = self._clock()
        while self._clock() - start < self._measure:
            t0 = self._clock()
            self._render(params)
            times.append((self._clock() - t0) * 1e3)
        arr = np.asarray(times) if times else np.asarray([0.0])
        return MeasuredConfig(
            name=name,
            frame_ms_avg=float(arr.mean()),
            frame_ms_min=float(arr.min()),
            frame_ms_max=float(arr.max()),
            frame_ms_p95=float(np.percentile(arr, 95)),
            frame_ms_p99=float(np.percentile(arr, 99)),
            fps=1e3 / float(arr.mean()) if arr.mean() > 0 else 0.0,
            frames=len(times),
        )

    def run(self) -> dict:
        """Baseline (all off) + each feature alone; report with feature
        costs as frame-time deltas and target checks."""
        off = SimulationParams(
            enable_disk=False, enable_starfield=False,
            enable_photon_ring=False, enable_bloom=False, quality="low",
        )
        baseline = self._measure_config("baseline", off)
        features = []
        for feat in _FEATURES:
            params = dataclasses.replace(off, **{feat: True})
            m = self._measure_config(feat, params)
            features.append(
                {
                    "feature": feat,
                    "frame_ms_avg": m.frame_ms_avg,
                    "cost_ms": m.frame_ms_avg - baseline.frame_ms_avg,
                    "cost_fraction": (
                        (m.frame_ms_avg - baseline.frame_ms_avg) / baseline.frame_ms_avg
                        if baseline.frame_ms_avg > 0 else 0.0
                    ),
                }
            )
        targets = PERFORMANCE_CONFIG["validation"]["targets_fps"]
        checks = {
            name: baseline.fps >= fps_target
            for name, fps_target in targets.items()
        }
        recs = []
        if not checks.get("baseline", True):
            recs.append("baseline below 75 FPS: lower quality tier or resolution")
        expensive = sorted(features, key=lambda f: -f["cost_ms"])
        if expensive and expensive[0]["cost_ms"] > baseline.frame_ms_avg:
            recs.append(f"feature {expensive[0]['feature']} dominates frame time")
        return {
            "baseline": dataclasses.asdict(baseline),
            "features": features,
            "targets_met": checks,
            "recommendations": recs,
        }

    @staticmethod
    def export_json(report: dict, path: str) -> None:
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
