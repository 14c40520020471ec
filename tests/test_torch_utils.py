"""The port's host utilities (``utils/``) and the two constant configs
(``configs/{performance,physics}.py``) against the JAX package's, on the
CPU: the same inputs and one scripted fake clock drive both, and every
result is held equal."""

import dataclasses
import math
import time

import numpy as np
import pytest

from blackhole_simulation_tpu import configs as jconfigs
from blackhole_simulation_tpu import utils as jutils
from blackhole_simulation_tpu.utils import validate as jvalidate
from blackhole_simulation_tpu.utils import device as jdevice
from blackhole_simulation_tpu_torch import configs as tconfigs
from blackhole_simulation_tpu_torch import utils as tutils
from blackhole_simulation_tpu_torch.utils import validate as tvalidate
from blackhole_simulation_tpu_torch.utils import device as tdevice


class FakeClock:
    """A scripted clock: each call returns the next reading."""

    def __init__(self, readings):
        self.readings = list(readings)
        self.i = 0

    def __call__(self):
        v = self.readings[min(self.i, len(self.readings) - 1)]
        self.i += 1
        return v


def _readings():
    return np.cumsum(np.random.default_rng(3).uniform(0.0, 0.4, 200)).tolist()


def test_constant_configs_equal_jax():
    assert tconfigs.PERFORMANCE_CONFIG == jconfigs.PERFORMANCE_CONFIG
    assert tconfigs.PHYSICS_CONSTANTS == jconfigs.PHYSICS_CONSTANTS


VALUES = [0.5, -3.0, 7.0, float("nan"), float("inf"), -float("inf"), "2.5",
          "junk", None, 3, True, np.float32(1.25)]


@pytest.mark.parametrize("default", [None, 0.1])
def test_clamp_and_validate_equal(default):
    for v in VALUES:
        t = tvalidate.clamp_and_validate(v, -1.0, 2.0, default)
        j = jvalidate.clamp_and_validate(v, -1.0, 2.0, default)
        assert t == j and type(t) is type(j), v


def test_clamp_array_and_finite_state_equal():
    x = np.array([0.5, -3.0, 7.0, np.nan, np.inf, -np.inf, 1.0])
    t = tvalidate.clamp_array(x, -1.0, 2.0, 0.25)
    j = jvalidate.clamp_array(x, -1.0, 2.0, 0.25)
    np.testing.assert_array_equal(t, j)
    assert t.dtype == j.dtype
    for state in ([1.0, 2.0], [1.0, math.nan], [math.inf], []):
        assert (tvalidate.is_finite_state(state)
                == jvalidate.is_finite_state(state))


def test_error_tracker_equal(monkeypatch):
    def drive(mod):
        monkeypatch.setattr(time, "time", FakeClock(_readings()))
        tr = mod.ErrorTracker(capacity=5)
        for i in range(8):
            sev = ("info", "warning", "error")[i % 3]
            try:
                raise ValueError(f"bad {i}")
            except ValueError as exc:
                tr.record(sev, f"message {i}", context=f"ctx{i}",
                          exc=exc if i % 2 else None)
        # a trace names its package's file: compare its last line
        recs = [{**dataclasses.asdict(r),
                 "trace": r.trace.splitlines()[-1:]}
                for r in tr.recent(3) + tr.recent(10, "error")]
        counts = tr.counts()
        tr.clear()
        return recs, counts, tr.counts()

    t, j = drive(tutils), drive(jutils)
    assert t == j
    assert t[0][0]["trace"] == ["ValueError: bad 5"] and t[2] == {}


def test_physics_cache_equal():
    def drive(mod):
        cache = mod.PhysicsCache(capacity=3)
        calls = []

        def horizon(m, a=0.0):
            calls.append((m, a))
            return m + math.sqrt(max(m * m - a * a, 0.0))

        wrapped = cache.wrap(horizon)
        vals = [wrapped(1.0, a=0.9), wrapped(1.0, a=0.9), wrapped(2.0),
                cache.get_or_compute(horizon, 3.0, a=0.1), wrapped(4.0),
                wrapped(1.0, a=0.9), wrapped(np.float64(4.0))]
        out = (vals, calls, cache.hits, cache.misses, len(cache._store))
        cache.clear()
        return out + (len(cache._store),)

    assert drive(tutils) == drive(jutils)


def test_debouncer_and_idle_detector_equal():
    def drive(mod):
        clock = FakeClock(_readings())
        fired = []
        deb = mod.Debouncer(fired.append, delay_s=0.5, clock=clock)
        idle = mod.IdleDetector(threshold_s=1.0, clock=clock)
        log = []
        for i in range(60):
            if i % 9 == 0:
                deb.push(i)
            if i % 13 == 0:
                idle.activity()
            log.append((deb.poll(), idle.idle, idle.idle_seconds))
        return log, fired

    t, j = drive(tutils), drive(jutils)
    assert t == j
    assert t[1] and any(row[1] for row in t[0])


def test_detect_device_and_preset_on_cpu():
    """Platform, kind, tier and preset equal JAX's on the CPU. The counts
    differ by design: the test configuration gives JAX eight virtual CPU
    devices (tests/conftest.py); the port counts the CPU once."""
    t, j = tdevice.detect_device(), jdevice.detect_device()
    assert (t.platform, t.device_kind, t.tier) == (
        j.platform, j.device_kind, j.tier) == ("cpu", "cpu", "low")
    assert t.n_devices == 1
    assert tdevice.recommend_preset() == jdevice.recommend_preset()
    for tier in ("high", "medium", "low"):
        ti = tdevice.DeviceInfo("gpu", "card", 1, tier)
        ji = jdevice.DeviceInfo("gpu", "card", 1, tier)
        assert tdevice.recommend_preset(ti) == jdevice.recommend_preset(ji)
