"""Automated benchmark: the preset sweep with incremental statistics and
the recommendation.

Counterpart of ``blackhole_simulation_tpu/perf/benchmark.py``: each preset
for a fixed duration, O(1) Welford FPS statistics, then the highest preset
sustaining 60 FPS, falling back to 35 then 24. The frame and the clock are
injected.
"""

from __future__ import annotations

import dataclasses
import time as _time

from blackhole_simulation_tpu_torch.configs.performance import PERFORMANCE_CONFIG
from blackhole_simulation_tpu_torch.configs.simulation import SimulationParams, apply_preset


@dataclasses.dataclass
class _RunningStats:
    """O(1) Welford accumulator (benchmark.ts incremental stats)."""

    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    min: float = float("inf")
    max: float = 0.0

    def push(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    @property
    def std(self) -> float:
        return (self.m2 / self.n) ** 0.5 if self.n > 1 else 0.0


@dataclasses.dataclass(frozen=True)
class BenchmarkResult:
    preset: str
    fps_avg: float
    fps_min: float
    fps_max: float
    fps_std: float
    frames: int


class BenchmarkController:
    """Run the preset sweep.

    ``render_frame(params) -> None`` executes one frame for the given
    SimulationParams (the injectable backend — a real renderer closure in
    production, a fake in tests). ``clock`` likewise.
    """

    def __init__(self, render_frame, clock=None,
                 seconds_per_preset: float | None = None,
                 presets: tuple = None):
        cfg = PERFORMANCE_CONFIG["benchmark"]
        self._render = render_frame
        self._clock = clock or _time.perf_counter
        self._duration = seconds_per_preset or cfg["seconds_per_preset"]
        self._presets = presets or cfg["presets"]

    def run(self) -> list[BenchmarkResult]:
        results = []
        base = SimulationParams()
        for name in self._presets:
            params = apply_preset(base, name)
            stats = _RunningStats()
            start = self._clock()
            while self._clock() - start < self._duration:
                t0 = self._clock()
                self._render(params)
                dt = self._clock() - t0
                if dt > 0:
                    stats.push(1.0 / dt)
            results.append(
                BenchmarkResult(
                    preset=name,
                    fps_avg=stats.mean,
                    fps_min=stats.min if stats.n else 0.0,
                    fps_max=stats.max,
                    fps_std=stats.std,
                    frames=stats.n,
                )
            )
        return results

    @staticmethod
    def recommend(results: list[BenchmarkResult]) -> str | None:
        """Highest preset meeting the 60 -> 35 -> 24 FPS tiers
        (benchmark.ts:298-336). Presets are ordered cheapest-first; prefer
        the most expensive preset that clears the highest tier."""
        tiers = PERFORMANCE_CONFIG["benchmark"]["recommend_fps_tiers"]
        for tier in tiers:
            passing = [r for r in results if r.fps_avg >= tier]
            if passing:
                return passing[-1].preset
        return results[0].preset if results else None
