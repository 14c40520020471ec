"""The camera track of the frame cells: the port's ``grand_survey``
director (``engine/cinema.py``), its arithmetic frozen here: a 4-act orbit
over ``duration`` seconds, wide at r_far, spiralling in to r_near, a low
fast orbit, and out again, with a two-frequency wobble on theta."""

from __future__ import annotations

import math


def _smooth(u: float) -> float:
    return u * u * (3.0 - 2.0 * u)


def grand_survey(t: float, duration: float = 120.0, r_far: float = 60.0,
                 r_near: float = 8.0) -> tuple[float, float, float]:
    """(r, theta, phi) of the camera at time ``t``."""
    tau = min(max(t / duration, 0.0), 1.0)
    act = min(int(tau * 4), 3)
    u = tau * 4 - act
    if act == 0:
        r = r_far
    elif act == 1:
        r = r_far + (r_near - r_far) * _smooth(u)
    elif act == 2:
        r = r_near
    else:
        r = r_near + (r_far - r_near) * _smooth(u)

    def omega(radius: float) -> float:
        return 0.5 * math.pi / (duration / 4) * (radius / r_far) ** -1.5

    seg = duration / 4
    phi = 0.0
    for a in range(act + 1):
        ra = (r_far, 0.5 * (r_far + r_near), r_near,
              0.5 * (r_far + r_near))[a]
        phi += omega(ra) * seg * (u if a == act else 1.0)
    wobble = (0.01 * math.sin(2.0 * math.pi * 0.3 * t)
              + 0.004 * math.sin(2.0 * math.pi * 1.1 * t + 1.0))
    return r, math.pi / 2 - 0.25 + wobble, phi


def track(n: int, duration: float = 120.0) -> list[tuple[float, float, float]]:
    """``n`` poses evenly over one period."""
    return [grand_survey(k * duration / n, duration) for k in range(n)]
