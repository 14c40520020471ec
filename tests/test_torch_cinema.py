"""The port's camera rig and cinematic directors (``engine/cinema.py``)
against the JAX package's, on the CPU. Both are the same float64 host
arithmetic, so every value is held bit for bit."""

import math

import numpy as np
import pytest

from blackhole_simulation_tpu.engine import cinema as jcinema
from blackhole_simulation_tpu_torch.engine import cinema as tcinema


@pytest.mark.parametrize("name", ["grand_survey", "descent"])
@pytest.mark.parametrize("fps", [30.0, 7.5])
def test_director_track_bit_equal(name, fps):
    t = tcinema.director_track(name, 300, fps=fps)
    j = jcinema.director_track(name, 300, fps=fps)
    assert t.shape == (300, 3) and t.dtype == np.float64
    np.testing.assert_array_equal(t, j)


def test_director_keywords_and_recovery_bit_equal():
    """The dive's recovery act (past the fall, which lasts ~24 s from r0 =
    30) and a second memoised path."""
    for t in (0.0, 10.0, 23.9, 24.5, 26.0, 40.0):
        assert tcinema.descent(t) == jcinema.descent(t)
        assert (tcinema.descent(t, r0=20.0, l0=1.2)
                == jcinema.descent(t, r0=20.0, l0=1.2))
        assert (tcinema.grand_survey(t, duration=30.0, r_near=5.0)
                == jcinema.grand_survey(t, duration=30.0, r_near=5.0))
    assert tcinema.DIRECTORS.keys() == jcinema.DIRECTORS.keys()


def _drive(mod):
    rig = mod.CameraRig(auto_spin=True)
    out = []
    for i in range(40):
        rig.drag(3.0 * math.sin(0.3 * i), -2.0 + 0.1 * i)
        if i % 7 == 0:
            rig.zoom(0.93 if i % 2 else 1.08)
        if i == 17:
            rig.state.v_phi = float("nan")  # the rollback
        if i == 25:
            rig.zoom(1e6)                   # clamped to R_MAX
        s = rig.step(1.0 / 60.0 + 1e-3 * (i % 5))
        out.append((s.r, s.theta, s.phi, s.v_theta, s.v_phi))
    return out


def test_camera_rig_sequence_bit_equal():
    t, j = _drive(tcinema), _drive(jcinema)
    assert t == j
    # the NaN step rolled back to the last finite state
    assert all(math.isfinite(v) for row in t for v in row)
    assert t[17] == t[16]


@pytest.mark.parametrize("args", [(1.0, 0.9, 0.5), (2.5, 0.3, 1.2),
                                  (1.0, 0.0, 0.1, 0.6), (1.0, 0.9, 1e-9)])
def test_initial_zoom_exact(args):
    assert tcinema.initial_zoom(*args) == jcinema.initial_zoom(*args)
