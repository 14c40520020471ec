"""Camera rig physics and the cinematic directors.

Counterpart of ``blackhole_simulation_tpu/engine/cinema.py``, the same
float64 host arithmetic line for line, so its tracks are bit-equal to the
JAX package's:

 - ``CameraRig``: a spherical orbit camera with momentum and damping (drag
   imparts angular velocity, zoom is multiplicative, friction e^{-5 dt},
   optional auto-spin) and a rollback to the last finite state;
 - ``initial_zoom``: the camera radius at which the shadow spans a given
   share of the field of view;
 - ``grand_survey``: the four-act programmed orbit, Keplerian angular
   speed, with a handheld wobble;
 - ``descent``: the three-act dive (Newtonian infall conserving
   L = r^2 omega, then a quartic-ease recovery once r < 2), its path
   integrated once per (r0, mass, l0) and memoised;
 - ``DIRECTORS`` and ``director_track``, a director sampled into an
   (n_frames, 3) array of (r, theta, phi).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache as _lru_cache

import numpy as np


@dataclasses.dataclass
class RigState:
    r: float = 30.0
    theta: float = math.pi / 2 - 0.25
    phi: float = 0.0
    v_theta: float = 0.0   # rad/s momentum
    v_phi: float = 0.0


class CameraRig:
    """Momentum/damping orbit camera (useCamera physics loop).

    ``drag(dx, dy)`` adds angular velocity (mouse/touch), ``zoom(f)``
    multiplies the radius, ``step(dt)`` integrates with exponential friction
    (camera.rs friction e^{-5 dt}) and optional auto-spin 0.15 rad/s. Any
    non-finite update rolls back to the last good state.
    """

    FRICTION = 5.0        # e^{-5 dt} velocity decay (camera.rs:42-70)
    AUTO_SPIN = 0.15      # rad/s (gravitas-wasm lib.rs auto-spin)
    DRAG_GAIN = 0.005     # rad per pixel of drag
    THETA_MIN = 0.05
    THETA_MAX = math.pi - 0.05
    R_MIN = 2.0
    R_MAX = 500.0

    def __init__(self, state: RigState | None = None, auto_spin: bool = False):
        self.state = state or RigState()
        self.auto_spin = auto_spin
        self._last_good = dataclasses.replace(self.state)

    def drag(self, dx: float, dy: float) -> None:
        self.state.v_phi += dx * self.DRAG_GAIN
        self.state.v_theta += dy * self.DRAG_GAIN

    def zoom(self, factor: float) -> None:
        self.state.r = min(max(self.state.r * factor, self.R_MIN), self.R_MAX)

    def step(self, dt: float) -> RigState:
        s = self.state
        s.phi += s.v_phi * dt + (self.AUTO_SPIN * dt if self.auto_spin else 0.0)
        s.theta = min(max(s.theta + s.v_theta * dt, self.THETA_MIN), self.THETA_MAX)
        decay = math.exp(-self.FRICTION * dt)
        s.v_phi *= decay
        s.v_theta *= decay
        # NaN guard + rollback (camera.rs:36-38, lib.rs:339-343).
        vals = (s.r, s.theta, s.phi, s.v_theta, s.v_phi)
        if all(math.isfinite(v) for v in vals):
            self._last_good = dataclasses.replace(s)
        else:
            self.state = dataclasses.replace(self._last_good)
        return self.state


def initial_zoom(
    mass: float,
    spin: float,
    fov: float,
    coverage: float = 0.35,
) -> float:
    """Camera radius r such that the shadow diameter covers ``coverage`` of
    the vertical field of view (useCamera.ts:72-115 initial-zoom solver).

    Uses the Schwarzschild-limit shadow radius 3*sqrt(3)*M as the size proxy
    (shadow.rs:191-193) — spin changes it by <10 %, which the solver (like
    the reference's) ignores.
    """
    shadow_r = 3.0 * math.sqrt(3.0) * mass
    # small-angle: apparent half-angle ~ shadow_r / r = coverage * fov / 2
    return shadow_r / max(coverage * math.tan(fov / 2.0), 1e-6)


# ---------------------------------------------------------------------------
# Cinematic directors. Each maps elapsed time t (s) -> (r, theta, phi) and is
# a pure function so frames can be rendered out of order / sharded.
# ---------------------------------------------------------------------------

def _smooth(t: float) -> float:
    t = min(max(t, 0.0), 1.0)
    return t * t * (3.0 - 2.0 * t)


def grand_survey(
    t: float,
    duration: float = 120.0,
    r_far: float = 60.0,
    r_near: float = 8.0,
    mass: float = 1.0,
) -> tuple[float, float, float]:
    """The 4-act 'Grand Survey' orbit (useCamera.ts:271-401).

    Acts (equal quarters): 1) wide establishing orbit at r_far; 2) spiral in
    to r_near; 3) low fast orbit — angular speed scales Keplerian-style
    ~ r^{-3/2} (the reference's speed variation); 4) pull back out. A small
    two-frequency handheld wobble rides on theta throughout.
    """
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

    # Keplerian angular speed Omega ~ r^{-3/2} (sqrt(M) absorbed into the
    # normalization: the far orbit sweeps 90 deg per act). Integrate per act;
    # speed is constant within acts 0/2 and the transitions use their mean
    # radius, like the reference's eased sweep.
    def omega(radius: float) -> float:
        return 0.5 * math.pi / (duration / 4) * (radius / r_far) ** -1.5

    seg = duration / 4
    phi = 0.0
    for a in range(act + 1):
        if a == 0:
            ra = r_far
        elif a == 1:
            ra = 0.5 * (r_far + r_near)
        elif a == 2:
            ra = r_near
        else:
            ra = 0.5 * (r_far + r_near)
        frac = u if a == act else 1.0
        phi += omega(ra) * seg * frac

    wobble = 0.01 * math.sin(2.0 * math.pi * 0.3 * t) + 0.004 * math.sin(
        2.0 * math.pi * 1.1 * t + 1.0
    )
    theta = math.pi / 2 - 0.25 + wobble
    return r, theta, phi


@_lru_cache(maxsize=8)
def _descent_path(r0: float, mass: float, l0: float):
    """Integrate the Newtonian infall once per (r0, mass, l0): the dive is
    deterministic, so every frame indexes the same memoized path. Note the
    centrifugal barrier: reaching the r=2 trigger from rest at r0 requires
    l0^2 < 8 (M/2 - M/r0) (~1.93 for r0=30)."""
    dt = 1.0 / 240.0
    r, vr, phi, tt = r0, 0.0, 0.0, 0.0
    path = [(0.0, r0, 0.0)]
    while r > 2.0 and tt < 600.0:
        acc = -mass / (r * r) + (l0 * l0) / (r ** 3)
        vr += acc * dt
        r += vr * dt
        phi += (l0 / (r * r)) * dt
        tt += dt
        path.append((tt, r, phi))
    return tuple(path)


def descent(
    t: float,
    r0: float = 30.0,
    mass: float = 1.0,
    l0: float = 1.8,
    recovery_s: float = 3.5,
) -> tuple[float, float, float]:
    """The 3-act 'Descent' dive (useCamera.ts:402-507).

    Newtonian radial infall from rest at r0 with conserved angular momentum
    L = r^2 * dphi/dt (so the camera whips around as it falls); when the
    fall reaches r < 2 (the reference's horizon-crossing trigger) a
    ``recovery_s``-second quartic-ease recovery returns to r0.
    """
    dt = 1.0 / 240.0
    path = _descent_path(r0, mass, l0)
    t_fall = path[-1][0]

    if t <= t_fall:
        # Binary-search the precomputed path (uniform dt: direct index).
        i = min(int(t / dt), len(path) - 1)
        _, r_t, phi_t = path[i]
        theta = math.pi / 2 - 0.15
        return max(r_t, 2.0), theta, phi_t

    # Recovery: quartic ease from the trigger point back out to r0.
    u = min((t - t_fall) / recovery_s, 1.0)
    ease = 1.0 - (1.0 - u) ** 4
    _, r_end, phi_end = path[-1]
    return r_end + (r0 - r_end) * ease, math.pi / 2 - 0.15, phi_end


DIRECTORS = {"grand_survey": grand_survey, "descent": descent}


def director_track(
    name: str, n_frames: int, fps: float = 30.0, **kw
) -> np.ndarray:
    """Sample a director into an (n_frames, 3) array of (r, theta, phi) —
    the batch form multi-chip animation rendering shards over frames."""
    fn = DIRECTORS[name]
    return np.array([fn(i / fps, **kw) for i in range(n_frames)])
