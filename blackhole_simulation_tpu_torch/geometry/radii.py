"""Free-function derived radii over the tensor ``KerrMetric``.

Counterpart of ``blackhole_simulation_tpu/geometry/radii.py``; mass and spin
are numbers or 0-d tensors (numbers become float64).
"""

from __future__ import annotations

import math

from blackhole_simulation_tpu_torch.geometry.metrics import KerrMetric


def _kerr(m, a) -> KerrMetric:
    return KerrMetric.create(m, a)


def event_horizon(m, a):
    return _kerr(m, a).event_horizon()


def cauchy_horizon(m, a):
    return _kerr(m, a).cauchy_horizon()


def photon_sphere(m, a, prograde: bool = True):
    return _kerr(m, a).photon_sphere(prograde)


def isco(m, a, prograde: bool = True):
    return _kerr(m, a).isco(prograde)


def ergosphere(m, a, theta):
    return _kerr(m, a).ergosphere(theta)


def frame_dragging(m, a, r, theta):
    return _kerr(m, a).frame_dragging(r, theta)


def keplerian_omega(m, a, r, prograde: bool = True):
    return _kerr(m, a).keplerian_omega(r, prograde)


def time_dilation(m, a, r, theta=math.pi / 2):
    return _kerr(m, a).time_dilation(r, theta)
