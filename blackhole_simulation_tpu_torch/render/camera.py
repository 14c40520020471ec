"""Pinhole camera and the scalar prologue of per-pixel ray construction.

Counterpart of ``blackhole_simulation_tpu/render/camera.py``: ``Camera``
(:41), ``zamo_tetrad`` (:64), ``bl_to_ks_momentum`` (:89), ``pixel_grid``
(:100), ``camera_rays_u`` (:134), ``camera_rays`` (:181, the theta-form
(N, 8) rows the staged shadow overlay reads), ``camera_scalars`` (:193) and
``_momenta_from_ndc`` (:215). The camera sits at one point, so its tetrad is
a handful of scalars:

* ``camera_scalars`` computes them on the host in float64 with numpy for the
  render kernel's parameter row (``ops/render.py``);
* ``camera_scalars_t`` computes them from 0-d tensors in float64 torch,
  differentiably in spin, mass and the camera's theta, and casts them to
  float32 once; ``camera_rays_u`` builds the staged path's and the training
  path's (8, N) rays from them with float32 per-pixel arithmetic in the JAX
  package's order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import const, div_c, sqrt

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
    c0 + n_r c_r + n_th c_th + n_ph c_ph for its unit direction n. k1 is
    the float32 product of float32 tan(fov/2) and the aspect ratio, as the
    JAX package forms it (the float64 product can differ in the last bit,
    which the start offset's hash would turn into another offset)."""
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
    k1 = float(np.float32(half) * np.float32(aspect))
    return (c0, c_r, c_th, c_ph, k1, half,
            math.cos(camera.roll), math.sin(camera.roll))


def _zamo_tetrad_t(m, a, r, theta):
    """zamo_tetrad on float64 0-d tensors: (u, e_r, e_th, e_ph) as lists of
    4 components (None for a structural zero)."""
    s = torch.sin(theta)
    s2 = torch.clamp(s * s, min=1e-12)
    c = torch.cos(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    r2a2 = r * r + a * a
    big_a = r2a2 * r2a2 - a * a * delta * s2
    alpha = torch.sqrt(torch.clamp(delta * sig / big_a, min=1e-30))
    omega = 2.0 * m * a * r / big_a
    u = [1.0 / alpha, None, None, omega / alpha]
    e_r = [None, torch.sqrt(torch.clamp(delta / sig, min=1e-30)), None, None]
    e_th = [None, None, 1.0 / torch.sqrt(sig), None]
    e_ph = [None, None, None,
            torch.sqrt(torch.clamp(sig / big_a, min=1e-30)) / torch.sqrt(s2)]
    return u, e_r, e_th, e_ph


def _lower_to_ks(m, a, r, theta, v):
    """g_BL v, then the BL -> KS covector shift of p_r, on float64 0-d
    tensors; ``v`` as from _zamo_tetrad_t."""
    s = torch.sin(theta)
    s2 = s * s
    c = torch.cos(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    two_mr = 2.0 * m * r
    g_tt = -(1.0 - two_mr / sig)
    g_tph = -two_mr * a * s2 / sig
    g_rr = sig / delta
    g_thth = sig
    g_phph = (r * r + a * a + two_mr * a * a * s2 / sig) * s2
    zero = torch.zeros((), dtype=torch.float64, device=m.device)
    vt, vr, vth, vph = (zero if x is None else x for x in v)
    p = [g_tt * vt + g_tph * vph, g_rr * vr, g_thth * vth,
         g_tph * vt + g_phph * vph]
    p[1] = p[1] + (-(2.0 * m * r / delta) * p[0] - (a / delta) * p[3])
    return p


def camera_scalars_t(camera: Camera, mass, spin, theta=None):
    """(c0, c_r, c_th, c_ph, k1, k2, roll_c, roll_s) as float32 tensors on
    ``mass``'s device: each c a (4,) tensor, the rest 0-d. ``theta``
    overrides ``camera.theta`` (a differentiable 0-d tensor in training).
    The tetrad scalars are computed in float64 and cast once; k1 is the
    float32 product of tan(fov/2) and the aspect ratio, as the JAX package
    forms it."""
    dev = torch.as_tensor(mass).device
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    m = f64(mass) if not torch.is_tensor(mass) else mass.double()
    a = f64(spin) if not torch.is_tensor(spin) else spin.double()
    th = (f64(camera.theta) if theta is None
          else (theta.double() if torch.is_tensor(theta) else f64(theta)))
    r0 = f64(camera.r)
    coeffs = [torch.stack(_lower_to_ks(m, a, r0, th, v)).float()
              for v in _zamo_tetrad_t(m, a, r0, th)]
    f32 = lambda x: torch.tensor(np.float32(x), device=dev)
    half = f32(math.tan(camera.fov / 2.0))
    k1 = half * f32(camera.width / camera.height)
    return (*coeffs, k1, half, f32(math.cos(camera.roll)),
            f32(math.sin(camera.roll)))


def pixel_grid(width: int, height: int, jitter=None, device=None):
    """Normalized pixel coordinates (ndc_x, ndc_y) in [-1, 1], y up, as
    (H, W) float32 tensors; ``jitter`` is a (2,) sub-pixel offset."""
    xs = div_c(torch.arange(width, dtype=torch.float32, device=device) + 0.5,
               float(width))
    ys = div_c(torch.arange(height, dtype=torch.float32, device=device) + 0.5,
               float(height))
    if jitter is not None:
        xs = xs + div_c(const(xs, float(np.float32(jitter[0]))), float(width))
        ys = ys + div_c(const(ys, float(np.float32(jitter[1]))), float(height))
    ndc_x = xs * 2.0 - 1.0
    ndc_y = 1.0 - ys * 2.0
    return torch.meshgrid(ndc_x, ndc_y, indexing="xy")


def _momenta_from_ndc(scalars, nx, ny):
    """Covariant KS momentum rows [p_t, p_r, p_th, p_ph] for NDC pixels."""
    c0, c_r, c_th, c_ph, k1, k2, roll_c, roll_s = scalars
    cx = nx * k1
    cy = ny * k2
    cx, cy = cx * roll_c - cy * roll_s, cx * roll_s + cy * roll_c
    inv_norm = 1.0 / sqrt(1.0 + cx * cx + cy * cy)
    n_r = -inv_norm
    n_th = -cy * inv_norm
    n_ph = -cx * inv_norm
    return [c0[j] + n_r * c_r[j] + n_th * c_th[j] + n_ph * c_ph[j]
            for j in range(4)]


def camera_rays_u(camera: Camera, mass, spin, pix_ids=None, jitter=None,
                  theta=None) -> torch.Tensor:
    """(8, N) float32 u-chart null-ray rows (t, r, u, phi, p_t, p_r, p_u,
    p_phi) normalized to p_t = -1, on ``mass``'s device: the whole frame in
    row-major order, or the flat row-major pixel ids ``pix_ids``.
    Differentiable in ``mass``, ``spin`` and ``theta`` (which overrides
    ``camera.theta``)."""
    dev = torch.as_tensor(mass).device
    scalars = camera_scalars_t(camera, mass, spin, theta)
    if pix_ids is None:
        nx, ny = pixel_grid(camera.width, camera.height, jitter, dev)
        nx, ny = nx.reshape(-1), ny.reshape(-1)
    else:
        pix_ids = torch.as_tensor(pix_ids, device=dev)
        ix = (pix_ids % camera.width).to(torch.float32)
        iy = (pix_ids // camera.width).to(torch.float32)
        jx = 0.0 if jitter is None else float(np.float32(jitter[0]))
        jy = 0.0 if jitter is None else float(np.float32(jitter[1]))
        nx = div_c(ix + 0.5 + jx, float(camera.width)) * 2.0 - 1.0
        ny = 1.0 - div_c(iy + 0.5 + jy, float(camera.height)) * 2.0
    p = _momenta_from_ndc(scalars, nx, ny)
    inv = 1.0 / (-p[0])
    th = (torch.as_tensor(camera.theta, dtype=torch.float64, device=dev)
          if theta is None else torch.as_tensor(theta).double())
    u0 = torch.cos(th).float()
    s0 = torch.sqrt(torch.clamp(1.0 - torch.cos(th) ** 2, min=1e-12)).float()
    zero = torch.zeros_like(nx)
    return torch.stack([
        zero,
        zero + float(np.float32(camera.r)),
        zero + u0,
        zero + float(np.float32(camera.phi)),
        zero - 1.0,
        p[1] * inv,
        -(p[2] * inv) / s0,
        p[3] * inv,
    ])


def camera_rays(camera: Camera, mass, spin, jitter=None) -> torch.Tensor:
    """(H*W, 8) float32 theta-chart null-ray states (t, r, theta, phi, p_t,
    p_r, p_theta, p_phi) in row-major pixel order, momenta not normalized,
    on ``mass``'s device: the JAX package's legacy layout, which the staged
    shadow overlay reads its conserved quantities from."""
    dev = torch.as_tensor(mass).device
    scalars = camera_scalars_t(camera, mass, spin)
    nx, ny = pixel_grid(camera.width, camera.height, jitter, dev)
    p = _momenta_from_ndc(scalars, nx.reshape(-1), ny.reshape(-1))
    zero = torch.zeros_like(p[0])
    return torch.stack([
        zero,
        zero + float(np.float32(camera.r)),
        zero + float(np.float32(camera.theta)),
        zero + float(np.float32(camera.phi)),
        p[0], p[1], p[2], p[3],
    ], dim=-1)
