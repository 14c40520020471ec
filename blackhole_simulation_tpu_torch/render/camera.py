"""Pinhole camera and the scalar prologue of per-pixel ray construction.

Counterpart of ``blackhole_simulation_tpu/render/camera.py``: ``Camera``
(:41), ``zamo_tetrad`` (:64), ``bl_to_ks_momentum`` (:89) and
``camera_scalars`` (:193). The camera sits at one point, so all of this is a
handful of float64 scalars computed on the host; the render kernel builds
each pixel's ray from them (``ops/render.py`` packs them into the parameter
row).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from blackhole_simulation_tpu_torch.geometry.metrics import (
    Kerr,
    kerr_cov_bl,
    kerr_delta,
    kerr_sigma,
)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera in Boyer-Lindquist coordinates, looking at the hole.

    ``fov`` is the full vertical field of view in radians; ``roll`` rotates
    the image plane; ``width`` and ``height`` are the frame size in pixels.
    """

    r: float
    theta: float
    phi: float
    fov: float
    roll: float
    width: int = 256
    height: int = 256

    @classmethod
    def create(cls, r=30.0, theta=math.pi / 2 - 0.3, phi=0.0, fov=0.35,
               roll=0.0, width=256, height=256):
        return cls(r=float(r), theta=float(theta), phi=float(phi),
                   fov=float(fov), roll=float(roll), width=int(width),
                   height=int(height))


def zamo_tetrad(m, a, r, theta):
    """ZAMO orthonormal tetrad (u, e_r, e_th, e_ph) in the BL coordinate
    basis, each a contravariant (4,) float64 vector."""
    s = np.sin(theta)
    s2 = max(s * s, 1e-12)
    sig = kerr_sigma(a, r, theta)
    delta = kerr_delta(m, a, r)
    r2a2 = r * r + a * a
    big_a = r2a2 * r2a2 - a * a * delta * s2
    alpha = np.sqrt(max(delta * sig / big_a, 1e-30))
    omega = 2.0 * m * a * r / big_a
    u = np.array([1.0 / alpha, 0.0, 0.0, omega / alpha])
    e_r = np.array([0.0, np.sqrt(max(delta / sig, 1e-30)), 0.0, 0.0])
    e_th = np.array([0.0, 0.0, 1.0 / np.sqrt(sig), 0.0])
    e_ph = np.array(
        [0.0, 0.0, 0.0, np.sqrt(max(sig / big_a, 1e-30)) / np.sqrt(s2)]
    )
    return u, e_r, e_th, e_ph


def bl_to_ks_momentum(m, a, r, p):
    """Covariant momentum BL -> ingoing KS:
    p_r += -(2Mr/Delta) p_t - (a/Delta) p_phi. ``p``: (4,) float64."""
    delta = kerr_delta(m, a, r)
    out = np.array(p, np.float64)
    out[1] += -(2.0 * m * r / delta) * p[0] - (a / delta) * p[3]
    return out


def camera_scalars(camera: Camera, bh: Kerr):
    """(c0, c_r, c_th, c_ph, k1, k2, roll_c, roll_s) in float64: the
    KS-lowered ZAMO tetrad coefficient 4-vectors and the NDC scale and
    rotation. A pixel's covariant momentum is
    c0 + n_r c_r + n_th c_th + n_ph c_ph for its unit direction n."""
    m, a = float(bh.mass), float(bh.spin)
    r0, th0 = camera.r, camera.theta
    aspect = camera.width / camera.height
    half = math.tan(camera.fov / 2.0)
    g_bl = kerr_cov_bl(m, a, r0, th0)
    coeffs = [
        bl_to_ks_momentum(m, a, r0, g_bl @ v)
        for v in zamo_tetrad(m, a, r0, th0)
    ]
    c0, c_r, c_th, c_ph = coeffs
    return (c0, c_r, c_th, c_ph, half * aspect, half,
            math.cos(camera.roll), math.sin(camera.roll))
