"""``correct`` has to come out false: for the control (the reference in
bfloat16 in the program's place) and for each fault a cell's timed path can
have, planted underneath a run that skips the harness's look for a card:
a frame that returns the state it started from (the camera never
advances), half of the batch left out with the mean taken over the rest
(half the samples, or half the rows), and an answer altered where it is
produced. (The exchange between chips belongs to a four-card cell.)"""

from __future__ import annotations

import pytest

from benchmark import session
from benchmark.drivers import frames

FRAME_CELLS = ["flagship_1080p.live_1spp", "flagship_1080p.ss16_orbit"]


def _over(numbers, limits):
    return any(v > limits[k] for k, v in numbers.items() if k in limits)


@pytest.mark.parametrize("cell", FRAME_CELLS)
def test_frame_control_fails(spec_of, cell):
    spec = spec_of(cell, n_samples=2 if "ss16" in cell else 1)
    assert _over(frames.Frames(spec).control(), spec.limits)


def _frame_fault(kind):
    """A render() whose frame is broken underneath the driver."""
    from blackhole_simulation_tpu_torch.render import render

    first = []

    def broken(scene, n_samples=1, device=None):
        if kind == "unchanged":      # the camera never advances
            first.append(first[0] if first else scene)
            return render(first[-1], n_samples=n_samples, device=device)
        if kind == "half":           # half the samples, averaged
            return render(scene, n_samples=max(n_samples // 2, 1),
                          device=device) if n_samples > 1 else _half_rows(
                render(scene, n_samples=1, device=device))
        img = render(scene, n_samples=n_samples, device=device)
        return img * 0.9              # the answer altered
    return broken


def _half_rows(img):
    out = img.clone()
    out[1::2] = img[0::2][: out[1::2].shape[0]]
    return out


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", FRAME_CELLS)
def test_frame_faults_fail(spec_of, cell, kind):
    # a window of several frames: the camera's first pose is its own
    spec = spec_of(cell, n_samples=4 if "ss16" in cell else 1, seconds=2.0,
                   check_span=3)
    run = frames.Frames(spec)
    run.setup()
    run.render = _frame_fault(kind)
    out = session.run(spec, _Ready(run))
    assert not out["correct"], out["checks"]


class _Ready:
    """A driver object whose set-up has run (so a fault planted after it
    reaches the window)."""

    def __init__(self, obj):
        self.obj = obj

    def setup(self):
        pass

    def __getattr__(self, name):
        return getattr(self.obj, name)
