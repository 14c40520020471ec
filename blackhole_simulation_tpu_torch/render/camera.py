"""Pinhole camera and the scalar prologue of per-pixel ray construction.

Counterpart of ``blackhole_simulation_tpu/render/camera.py``: ``Camera``
(:41), ``zamo_tetrad`` (:64) and ``bl_to_ks_momentum`` (:89) on tensors of
any shape (the camera's prologue takes them on 0-d tensors as
``_zamo_tetrad_t`` and ``_lower_to_ks``), ``pixel_grid`` (:100),
``camera_rays_indexed`` (:117), ``camera_rays_u`` (:134; on the card by
``ops/birth.py``'s kernels, ``camera_rays_u_plain`` elsewhere), ``camera_rays``
(:181, the theta-form (N, 8) rows the staged shadow overlay and the oracle
read), ``camera_scalars`` (:193), and
``_momenta_from_ndc`` (:215). The camera sits at one point, so its tetrad
is a handful of scalars: ``camera_scalars`` computes them from 0-d
tensors, differentiably in mass, spin and the camera's five fields,
rounding each operation in the dtype JAX's weak typing gives it, and casts
them to the rays' dtype once.

The camera's r, theta, phi, fov and roll are numbers or 0-d tensors (the
JAX ``Camera``'s data leaves, which ``jax.grad`` differentiates); a tensor
field may require grad, and every function that births rays then carries
its derivative. A tensor field gives the same rays, bit for bit, as the
number it holds:
the host functions of fov and roll (tan, cos, sin, in float64, rounded
once) keep their host values and take their derivatives from torch
(``_elementwise.attach``). ``Camera.host`` is the camera with number
fields, which the caches and the render kernel's parameter row read. The
render kernel's parameter row (``ops/render.py``) and the staged and
training paths' rays take the same scalars.

Every ray builder takes ``dtype``: float32 (the default, the render and
training paths) rounds as the JAX package's float32 route does; float64
(the oracle's route, JAX's ``camera_rays(cam, bh, dtype=float64)``) never
rounds through float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import (
    attach,
    const,
    cos,
    div_c,
    host,
    leaf,
    sin,
    sqrt,
)
from blackhole_simulation_tpu_torch.perf import spans


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera in Boyer-Lindquist coordinates, looking at the hole.

    ``fov`` is the full vertical field of view in radians; ``roll`` rotates
    the image plane; ``width`` and ``height`` are the frame size in pixels.
    r, theta, phi, fov and roll are numbers or 0-d tensors (see the module
    docstring); a tensor field hashes by identity, so caches take
    ``host()``.
    """

    r: float | torch.Tensor
    theta: float | torch.Tensor
    phi: float | torch.Tensor
    fov: float | torch.Tensor
    roll: float | torch.Tensor
    width: int = 256
    height: int = 256

    @classmethod
    def create(cls, r=30.0, theta=math.pi / 2 - 0.3, phi=0.0, fov=0.35,
               roll=0.0, width=256, height=256):
        f = lambda v: v if isinstance(v, torch.Tensor) else float(v)
        return cls(r=f(r), theta=f(theta), phi=f(phi), fov=f(fov),
                   roll=f(roll), width=int(width), height=int(height))

    def host(self) -> "Camera":
        """This camera with each field's value as a number."""
        fields = ("r", "theta", "phi", "fov", "roll")
        if not any(isinstance(getattr(self, k), torch.Tensor) for k in fields):
            return self
        return dataclasses.replace(
            self, **{k: host(getattr(self, k)) for k in fields})


def _zamo_tetrad_t(m, a, r, theta):
    """zamo_tetrad on 0-d tensors: (u, e_r, e_th, e_ph) as lists of 4
    components (None for a structural zero), in the inputs' dtype."""
    s = sin(theta)
    s2 = torch.clamp(s * s, min=1e-12)
    c = cos(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    r2a2 = r * r + a * a
    big_a = r2a2 * r2a2 - a * a * delta * s2
    alpha = sqrt(torch.clamp(delta * sig / big_a, min=1e-30))
    omega = 2.0 * m * a * r / big_a
    u = [1.0 / alpha, None, None, omega / alpha]
    e_r = [None, sqrt(torch.clamp(delta / sig, min=1e-30)), None, None]
    e_th = [None, None, 1.0 / sqrt(sig), None]
    e_ph = [None, None, None,
            sqrt(torch.clamp(sig / big_a, min=1e-30)) / sqrt(s2)]
    return u, e_r, e_th, e_ph


def zamo_tetrad(m, a, r, theta):
    """ZAMO orthonormal tetrad in the Boyer-Lindquist coordinate basis:
    (u, e_r, e_th, e_ph), each a (..., 4) contravariant vector over the
    broadcast shape of the tensor arguments. u = (d_t + omega d_phi) /
    alpha with lapse alpha = sqrt(Delta Sigma / A), omega = 2 M a r / A,
    A = (r^2 + a^2)^2 - a^2 Delta sin^2 theta."""
    m, a, r, theta = torch.broadcast_tensors(*(
        torch.as_tensor(x) for x in (m, a, r, theta)))
    z = torch.zeros_like(r)
    return tuple(torch.stack([z if c is None else c for c in v], dim=-1)
                 for v in _zamo_tetrad_t(m, a, r, theta))


def bl_to_ks_momentum(m, a, r, p: torch.Tensor) -> torch.Tensor:
    """Covariant momentum (..., 4) from Boyer-Lindquist to ingoing
    Kerr-Schild: p_r += -(2 M r / Delta) p_t - (a / Delta) p_phi."""
    delta = r * r - 2.0 * m * r + a * a
    shift = -(2.0 * m * r / delta) * p[..., 0] - (a / delta) * p[..., 3]
    return torch.cat([p[..., :1], p[..., 1:2] + shift[..., None], p[..., 2:]],
                     dim=-1)


def _lower_to_ks(m, a, r, theta, v):
    """g_BL v, then the BL -> KS covector shift of p_r, on 0-d tensors;
    ``v`` as from _zamo_tetrad_t."""
    s = sin(theta)
    s2 = s * s
    c = cos(theta)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    two_mr = 2.0 * m * r
    g_tt = -(1.0 - two_mr / sig)
    g_tph = -two_mr * a * s2 / sig
    g_rr = sig / delta
    g_thth = sig
    g_phph = (r * r + a * a + two_mr * a * a * s2 / sig) * s2
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    vt, vr, vth, vph = (zero if x is None else x for x in v)
    p = [g_tt * vt + g_tph * vph, g_rr * vr, g_thth * vth,
         g_tph * vt + g_phph * vph]
    p[1] = p[1] + (-(2.0 * m * r / delta) * p[0] - (a / delta) * p[3])
    return p


def camera_scalars(camera: Camera, mass, spin, theta=None,
                   dtype=torch.float32):
    """(c0, c_r, c_th, c_ph, k1, k2, roll_c, roll_s) as ``dtype`` tensors on
    ``mass``'s device: each c a (4,) tensor, the rest 0-d. ``theta``
    overrides ``camera.theta`` (a differentiable 0-d tensor in training).
    The tetrad is computed in the dtype of the tensors among mass, spin and
    ``theta`` (float64 if none is one); numbers and the camera's fields
    take that dtype, as JAX's weakly typed Python scalars do. So the render
    and training paths, whose mass and spin are float32, round the tetrad
    in float32 where the JAX package does, and the oracle's float64 route
    never rounds through float32. The scalars are cast to ``dtype`` once;
    k1 is the product of tan(fov/2) and the aspect ratio in ``dtype``, as
    the JAX package forms it."""
    dev = torch.as_tensor(mass).device
    tensors = [x for x in (mass, spin, theta) if torch.is_tensor(x)]
    ct = torch.float64
    if tensors:
        ct = tensors[0].dtype
        for x in tensors[1:]:
            ct = torch.promote_types(ct, x.dtype)
    weak = lambda x: (x.to(ct) if torch.is_tensor(x)
                      else torch.as_tensor(x, dtype=ct, device=dev))
    m, a = weak(mass), weak(spin)
    th = weak(camera.theta if theta is None else theta)
    r0 = weak(camera.r)
    coeffs = [torch.stack(_lower_to_ks(m, a, r0, th, v)).to(dtype)
              for v in _zamo_tetrad_t(m, a, r0, th)]
    rounded = lambda x: torch.tensor(x, dtype=torch.float64,
                                     device=dev).to(dtype)
    half = _field_fn(camera.fov, lambda v: math.tan(v / 2.0),
                     lambda v: torch.tan(v / 2.0), dtype, dev)
    k1 = half * rounded(camera.width / camera.height)
    if spans.on and dev.type == "cuda":
        # Each number made a tensor on the card is a blocking copy: the
        # numbers among mass, spin, theta and r, the fov's and roll's
        # three host values and the aspect ratio.
        numbers = (mass, spin, camera.theta if theta is None else theta,
                   camera.r)
        spans.count("stream_syncs",
                    4 + sum(not torch.is_tensor(x) for x in numbers))
    return (*coeffs, k1, half,
            _field_fn(camera.roll, math.cos, torch.cos, dtype, dev),
            _field_fn(camera.roll, math.sin, torch.sin, dtype, dev))


def _field_fn(x, host_fn, torch_fn, dtype, dev):
    """host_fn of a camera field in float64, rounded once to ``dtype``; for
    a tensor field with the derivative of ``torch_fn`` of its float64
    value (the value stays the host's, bit for bit)."""
    value = torch.tensor(host_fn(host(x)), dtype=torch.float64,
                         device=dev).to(dtype)
    if isinstance(x, torch.Tensor):
        value = attach(value, torch_fn(leaf(x, torch.float64, dev)).to(dtype))
    return value


def _jitter_values(jitter, dtype):
    """The (2,) sub-pixel offset as numbers rounded to ``dtype``."""
    if jitter is None:
        return 0.0, 0.0
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return float(np_dtype(jitter[0])), float(np_dtype(jitter[1]))


def pixel_grid(width: int, height: int, jitter=None, device=None,
               dtype=torch.float32):
    """Normalized pixel coordinates (ndc_x, ndc_y) in [-1, 1], y up, as
    (H, W) ``dtype`` tensors; ``jitter`` is a (2,) sub-pixel offset."""
    xs = div_c(torch.arange(width, dtype=dtype, device=device) + 0.5,
               float(width))
    ys = div_c(torch.arange(height, dtype=dtype, device=device) + 0.5,
               float(height))
    if jitter is not None:
        jx, jy = _jitter_values(jitter, dtype)
        xs = xs + div_c(const(xs, jx), float(width))
        ys = ys + div_c(const(ys, jy), float(height))
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


def _ndc_of_ids(camera: Camera, pix_ids, jitter, dtype, device):
    """NDC coordinates of flat row-major pixel ids."""
    pix_ids = torch.as_tensor(pix_ids, device=device)
    ix = (pix_ids % camera.width).to(dtype)
    iy = (pix_ids // camera.width).to(dtype)
    jx, jy = _jitter_values(jitter, dtype)
    nx = div_c(ix + 0.5 + jx, float(camera.width)) * 2.0 - 1.0
    ny = 1.0 - div_c(iy + 0.5 + jy, float(camera.height)) * 2.0
    return nx, ny


def _ndc(camera: Camera, pix_ids, jitter, dtype, device):
    """NDC coordinates of the whole frame (row-major) or of ``pix_ids``."""
    if pix_ids is not None:
        return _ndc_of_ids(camera, pix_ids, jitter, dtype, device)
    nx, ny = pixel_grid(camera.width, camera.height, jitter, device, dtype)
    return nx.reshape(-1), ny.reshape(-1)


def _camera_value(x, dtype, device=None):
    """A camera field rounded to ``dtype``: a number as a number, a tensor
    as a 0-d ``dtype`` tensor on ``device`` (keeping its graph)."""
    if isinstance(x, torch.Tensor):
        return leaf(x, dtype, device)
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def camera_rays_u(camera: Camera, mass, spin, pix_ids=None, jitter=None,
                  theta=None, dtype=torch.float32) -> torch.Tensor:
    """(8, N) u-chart null-ray rows (t, r, u, phi, p_t, p_r, p_u, p_phi)
    normalized to p_t = -1, in ``dtype`` on ``mass``'s device: the whole
    frame in row-major order, or the flat row-major pixel ids ``pix_ids``.
    Differentiable in ``mass``, ``spin``, the camera's tensor fields and
    ``theta`` (which overrides ``camera.theta``). For a CUDA ``mass`` the
    birth kernel (``ops/birth.py::birth_rows``: the same rows bit for bit,
    with its VJP kernel under autograd; ValueError for what it does not
    take), elsewhere ``camera_rays_u_plain``."""
    if torch.is_tensor(mass) and mass.is_cuda:
        from blackhole_simulation_tpu_torch.ops.birth import birth_rows

        return birth_rows(camera, mass, spin, pix_ids, jitter, theta, dtype)
    return camera_rays_u_plain(camera, mass, spin, pix_ids, jitter, theta,
                               dtype)


def camera_rays_u_plain(camera: Camera, mass, spin, pix_ids=None,
                        jitter=None, theta=None,
                        dtype=torch.float32) -> torch.Tensor:
    """``camera_rays_u`` in plain PyTorch, differentiable by autograd: the
    CPU's path, and the reference the birth kernel is held to on the
    card."""
    dev = torch.as_tensor(mass).device
    scalars = camera_scalars(camera, mass, spin, theta, dtype)
    nx, ny = _ndc(camera, pix_ids, jitter, dtype, dev)
    p = _momenta_from_ndc(scalars, nx, ny)
    inv = 1.0 / (-p[0])
    th = (leaf(camera.theta, torch.float64, dev)
          if theta is None else torch.as_tensor(theta))
    c0 = cos(th)
    u0 = c0.to(dtype)
    s0 = sqrt(torch.clamp(1.0 - c0 * c0, min=1e-12)).to(dtype)
    zero = torch.zeros_like(nx)
    return torch.stack([
        zero,
        zero + _camera_value(camera.r, dtype, dev),
        zero + u0,
        zero + _camera_value(camera.phi, dtype, dev),
        zero - 1.0,
        p[1] * inv,
        -(p[2] * inv) / s0,
        p[3] * inv,
    ])


def _theta_rays(camera: Camera, mass, spin, pix_ids, jitter, dtype):
    """(N, 8) theta-chart states of the frame or of ``pix_ids``."""
    dev = torch.as_tensor(mass).device
    scalars = camera_scalars(camera, mass, spin, dtype=dtype)
    nx, ny = _ndc(camera, pix_ids, jitter, dtype, dev)
    p = _momenta_from_ndc(scalars, nx, ny)
    zero = torch.zeros_like(p[0])
    return torch.stack([
        zero,
        zero + _camera_value(camera.r, dtype, dev),
        zero + _camera_value(camera.theta, dtype, dev),
        zero + _camera_value(camera.phi, dtype, dev),
        p[0], p[1], p[2], p[3],
    ], dim=-1)


def camera_rays(camera: Camera, mass, spin, jitter=None,
                dtype=torch.float32) -> torch.Tensor:
    """(H*W, 8) theta-chart null-ray states (t, r, theta, phi, p_t, p_r,
    p_theta, p_phi) in row-major pixel order, momenta not normalized, in
    ``dtype`` on ``mass``'s device: the JAX package's legacy layout, which
    the staged shadow overlay and the oracle read."""
    return _theta_rays(camera, mass, spin, None, jitter, dtype)


def camera_rays_indexed(camera: Camera, mass, spin, pix_ids, jitter=None,
                        dtype=torch.float32) -> torch.Tensor:
    """(len(pix_ids), 8) theta-chart states of the flat row-major pixel ids
    ``pix_ids`` (iy * width + ix)."""
    return _theta_rays(camera, mass, spin, pix_ids, jitter, dtype)
