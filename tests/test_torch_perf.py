"""The port's performance layer (``perf/``) against the JAX package's, on
the CPU: the ring buffer, the PID and hysteresis resolution controllers,
the monitor with its calibration, the preset benchmark and the feature
validator, each driven in both packages by the same scripted fake clock
and a fake render, with every result equal field for field; and the march
telemetry, with ``ks_hamiltonian``, on the same rays marched by both
packages."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu import perf as jperf
from blackhole_simulation_tpu.geometry.metrics import KS, Kerr as JKerr
from blackhole_simulation_tpu.ops.ks_kernel import (
    ks_hamiltonian as j_ks_hamiltonian,
)
from blackhole_simulation_tpu.perf import adaptive_resolution as jadapt
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu_torch import perf as tperf
from blackhole_simulation_tpu_torch.geometry.metrics import Kerr as TKerr
from blackhole_simulation_tpu_torch.ops.ks_kernel import ks_hamiltonian
from blackhole_simulation_tpu_torch.perf import adaptive_resolution as tadapt
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays
from blackhole_simulation_tpu_torch.render.march import MarchConfig, march

jmarch = importlib.import_module("blackhole_simulation_tpu.render.march")

torch.set_num_threads(1)


class FakeClock:
    """A clock that only moves when the fake render (or the test) moves
    it."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _frame_times(n, seed=0):
    return np.random.default_rng(seed).uniform(4e-3, 60e-3, n).tolist()


def test_ring_buffer_equal():
    def drive(mod):
        ring = mod.FrameRingBuffer(capacity=7)
        out = [(ring.mean(), ring.percentile(95), ring.minimum(),
                ring.maximum(), len(ring))]
        for v in _frame_times(20):
            ring.push(v)
            out.append((ring.mean(), ring.percentile(95), ring.minimum(),
                        ring.maximum(), len(ring), ring.values().tolist()))
        return out

    assert drive(tperf) == drive(jperf)


def test_pid_controller_equal():
    def drive(mod):
        pid = mod.PIDController()
        times = np.cumsum(np.full(60, 0.2)).tolist()
        return [pid.update(ms * 1e3, t)
                for ms, t in zip(_frame_times(60, 1), times)]

    t, j = drive(tperf), drive(jperf)
    assert t == j and len(set(t)) > 3


def _monitor_run(mod):
    clock = FakeClock()
    mon = mod.PerformanceMonitor(clock=clock)
    times = iter(_frame_times(2000, 2) * 2)

    def render_frame():
        clock.now += next(times) * 2.0   # slow: the calibration demotes

    quality = mon.calibrate(render_frame, quality="ultra",
                            frames_per_call=2)
    metrics = []
    for i, dt in enumerate(_frame_times(120, 3)):
        t0 = mon.begin_frame()
        clock.now += dt
        mon.end_frame(t0, n_rays=1000 * (i + 1),
                      device_ms=dt * 600.0 if i % 2 else None)
        metrics.append(mon.get_metrics())
    return quality, mon.calibrated_fps, mon.max_allowed_quality, metrics


def test_monitor_with_calibration_equal():
    t, j = _monitor_run(tperf), _monitor_run(jperf)
    assert t == j
    assert t[0] == "high" and t[3][-1]["warnings"]


def test_adaptive_resolution_equal():
    def drive(mod):
        ctl = mod.AdaptiveResolutionController()
        out = []
        now = 0.0
        fps_seq = [45.0] * 40 + [68.0] * 10 + [90.0] * 80 + [20.0] * 30
        for fps in fps_seq:
            now += 0.1
            out.append((ctl.update(fps, now), ctl.target_scale,
                        ctl.scaled_dims(1280, 720)))
        ctl.reset()
        out.append((ctl.scale, ctl.target_scale))
        kinds = [mod.recommended_initial_scale(k)
                 for k in (None, "", "cpu", "NVIDIA H100 80GB HBM3",
                           "TPU v5 lite")]
        return out, kinds

    t, j = drive(tadapt), drive(jadapt)
    assert t == j
    assert len({row[0] for row in t[0]}) > 5


def _bench_run(mod):
    clock = FakeClock()
    cost = {"low": 5e-3, "medium": 12e-3, "high": 25e-3, "ultra": 45e-3}

    def render_frame(params):
        clock.now += cost[params.quality] * params.render_scale

    ctl = mod.BenchmarkController(render_frame, clock=clock,
                                  seconds_per_preset=0.5)
    results = ctl.run()
    return ([dataclasses.asdict(r) for r in results],
            mod.BenchmarkController.recommend(results),
            mod.BenchmarkController.recommend([]))


def test_benchmark_controller_equal():
    t, j = _bench_run(tperf), _bench_run(jperf)
    assert t == j
    assert [r["preset"] for r in t[0]] == ["minimal", "balanced", "quality",
                                           "cinematic"]


def _validator_run(mod, tmp_path):
    clock = FakeClock()

    def render_frame(params):
        clock.now += (4e-3 + 3e-3 * params.enable_disk
                      + 1e-3 * params.enable_starfield
                      + 2e-3 * params.enable_photon_ring
                      + 9e-3 * params.enable_bloom)

    val = mod.PerformanceValidator(render_frame, clock=clock, warmup_s=0.1,
                                   measure_s=0.3)
    report = val.run()
    path = tmp_path / f"{mod.__name__}.json"
    mod.PerformanceValidator.export_json(report, str(path))
    return report, path.read_text()


def test_performance_validator_equal(tmp_path):
    t, j = _validator_run(tperf, tmp_path), _validator_run(jperf, tmp_path)
    assert t == j
    assert [f["feature"] for f in t[0]["features"]] == [
        "enable_disk", "enable_starfield", "enable_photon_ring",
        "enable_bloom"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ks_hamiltonian_matches_jax(dtype):
    rng = np.random.default_rng(4)
    y = rng.uniform(-1.0, 1.0, (500, 8)).astype(dtype)
    y[:, 1] = rng.uniform(1.2, 60.0, 500)
    y[:, 2] = rng.uniform(0.0, np.pi, 500)
    y[:5, 2] = [0.0, np.pi, 1e-7, np.pi / 2, 3.0]   # the poles' guard
    m, a = np.asarray(1.0, dtype), np.asarray(0.9, dtype)
    with jax.disable_jit():
        ref = np.asarray(j_ks_hamiltonian(jnp.asarray(m), jnp.asarray(a),
                                          jnp.asarray(y)))
    got = ks_hamiltonian(torch.from_numpy(m), torch.from_numpy(a),
                         torch.from_numpy(y)).numpy()
    assert got.dtype == ref.dtype == np.dtype(dtype)
    rtol = 1e-6 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_march_telemetry_matches_jax():
    """A 32x24, 64-step march of the same theta-form rays in both packages
    (JAX's jnp march op by op): step counts and hit fractions equal,
    |H| drift within 1e-6."""
    spin = float(np.float32(0.9))
    cam = Camera.create(r=30.0, theta=np.pi / 2 - 0.25, fov=0.5, width=32,
                        height=24)
    m, a = torch.tensor(1.0), torch.tensor(np.float32(spin))
    rays = camera_rays(cam, m, a)
    cfg = dict(max_steps=64, shadow_precull=False, far_step_cap_rate=0.4,
               far_boost_radius=20.0, midpoint_iters=1)
    res = march(rays, m, a, MarchConfig(**cfg))
    got = tperf.march_telemetry(res, TKerr(mass=1.0, spin=spin))
    jbh = JKerr(mass=jnp.float32(1.0), spin=jnp.float32(spin), chart=KS)
    with jax.disable_jit():
        jres = jmarch.march(jnp.asarray(rays.numpy()), jbh,
                            JMarchConfig(**cfg, remat_every=0))
        want = jperf.march_telemetry(jres, jbh)
    assert got.keys() == want.keys()
    for k in ("n_rays", "frac_escape", "frac_horizon", "steps_p50",
              "steps_p99", "steps_hist"):
        assert got[k] == want[k], k
    assert 0.0 < got["frac_escape"] < 1.0 and got["n_rays"] == 768
    for k in ("h_drift_median", "h_drift_p99", "disk_crossings_mean"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
