"""Temporal accumulation (TAA) of rendered frames.

Counterpart of ``blackhole_simulation_tpu/render/accumulate.py``:
``rgb_to_ycocg`` (:33) / ``ycocg_to_rgb`` (:42); ``_neighborhood_stats``
(:51), the 3x3 mean and standard deviation with edge-replicated borders;
``taa_resolve`` (:70), which clamps the history to the current frame's
mu +- k sigma YCoCg box and blends it with a feedback weight that falls
with the local luma sigma; the flat-space reprojection ``_cam_basis``
(:101), ``reproject_uv`` (:116), ``_bilinear`` (:186) and
``taa_resolve_reprojected`` (:203), which warps the history through the
camera's motion at a heuristic depth instead of discarding it; and the
host-side ``TemporalAccumulator`` (:235-296) with its feedback ramp, its
reset on a shape change, its sample-count decay under motion and
``prev_camera``.

Frames are (H, W, 3) tensors; the history stays a tensor on the frame's
device and every resolve runs there in plain PyTorch (elementwise work and
a box filter: no kernel of the JAX package's is on this path). The
camera's sines, cosines and tangents and the ray norm's square root go
through float64 and round once, as XLA's float32 ones do on these inputs
(PyTorch's float32 cos and CPU sqrt are off by an ulp on some), and the
projections onto the previous camera's axes are XLA's multiply-add chain
(``_dot3``), so the reprojected coordinates are bit-equal to the JAX
package's, and the same on the card as on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from blackhole_simulation_tpu_torch._elementwise import (
    clip,
    cos,
    div_c,
    sin,
    sqrt,
    tan,
)


def rgb_to_ycocg(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB -> YCoCg."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.25 * r + 0.5 * g + 0.25 * b
    co = 0.5 * r - 0.5 * b
    cg = -0.25 * r + 0.5 * g - 0.25 * b
    return torch.stack([y, co, cg], dim=-1)


def ycocg_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """YCoCg -> linear RGB."""
    y, co, cg = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    return torch.stack([y + co - cg, y + cg, y - co - cg], dim=-1)


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H + 2, W + 2, C), the border rows and columns
    repeated (``jnp.pad(mode="edge")``)."""
    h, w = x.shape[:2]
    rows = torch.clamp(torch.arange(-1, h + 1, device=x.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-1, w + 1, device=x.device), 0, w - 1)
    return x[rows][:, cols]


def _box9(x: torch.Tensor) -> torch.Tensor:
    """3x3 window sums, rows first, then columns."""
    p = _edge_pad(x)
    rows = p[:-2] + p[1:-1] + p[2:]
    return rows[:, :-2] + rows[:, 1:-1] + rows[:, 2:]


def _neighborhood_stats(img: torch.Tensor):
    """Per-pixel 3x3 neighbourhood mean and standard deviation of an
    (H, W, C) image, edge-replicated."""
    mean = div_c(_box9(img), 9.0)
    mean2 = div_c(_box9(img * img), 9.0)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return mean, sqrt(var)


def _blend(hist_y, cur_y, base_feedback, clamp_k, valid=None):
    """Clamp the history to the current frame's mu +- k sigma box and blend
    with the variance-guided feedback weight (1.0 at sigma 0 down to 0.45
    at luma sigma >= 1, times ``base_feedback``; zero where ``valid`` is
    false). Returns RGB."""
    mean, sigma = _neighborhood_stats(cur_y)
    hist_clamped = clip(hist_y, mean - clamp_k * sigma, mean + clamp_k * sigma)
    luma_sigma = clip(sigma[..., 0:1], 0.0, 1.0)
    feedback = base_feedback * (1.0 - 0.55 * luma_sigma)
    if valid is not None:
        feedback = feedback * valid[..., None].to(feedback.dtype)
    blended = feedback * hist_clamped + (1.0 - feedback) * cur_y
    return ycocg_to_rgb(blended)


def taa_resolve(history: torch.Tensor, current: torch.Tensor, moving,
                base_feedback=0.7, clamp_k: float = 1.5) -> torch.Tensor:
    """One TAA resolve: (H, W, 3) history x current -> new history. A true
    ``moving`` (a bool or a 0-d tensor) resets the history to the current
    frame."""
    out = _blend(rgb_to_ycocg(history), rgb_to_ycocg(current), base_feedback,
                 clamp_k)
    moving = torch.as_tensor(moving, device=current.device)
    return torch.where(moving, current, out)


def _cam_basis(r, theta, phi):
    """Flat-space camera position and its orthonormal spherical basis
    (e_r, e_theta, e_phi), Cartesian (3,) tensors."""
    st, ct = sin(theta), cos(theta)
    sp, cp = sin(phi), cos(phi)
    e_r = torch.stack([st * cp, st * sp, ct])
    e_th = torch.stack([ct * cp, ct * sp, -st])
    e_ph = torch.stack([-sp, cp, torch.zeros_like(r)])
    return r * e_r, e_r, e_th, e_ph


def _dot3(e: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_i e[i] v[i] over a (3,) and a (3, H, W) tensor as XLA's float32
    dot computes it, a chain of fused multiply-adds in i order: each step
    exact in float64 (the products of float32 numbers are) and rounded
    once to the inputs' dtype. The same bits on every device."""
    acc = None
    for i in range(3):
        prod = e[i].double() * v[i].double()
        acc = (prod if acc is None else prod + acc.double()).to(v.dtype)
    return acc


def _cam_values(cam, dtype, device):
    """(r, theta, phi, fov, roll) as five 0-d tensors."""
    cam = torch.as_tensor(cam, dtype=dtype, device=device)
    return [cam[i] for i in range(5)]


def reproject_uv(cam_prev, cam_curr, height: int, width: int, depth=None,
                 dtype=torch.float32, device=None):
    """Previous-frame pixel coordinates of every current pixel:
    (prev_y, prev_x, valid), (H, W) each. ``cam_prev`` / ``cam_curr``:
    (r, theta, phi, fov, roll). Each current pixel's view ray is taken to
    ``depth`` (the current camera's r by default) and projected through the
    previous camera; ``valid`` marks points in front of it and inside its
    frame (half a pixel of slack). The pixel directions follow
    ``render/camera.py``: image x -> -e_phi, image y -> -e_theta, forward
    -e_r, vertical fov, roll about the forward axis."""
    if device is None and isinstance(cam_curr, torch.Tensor):
        device = cam_curr.device
    r0, th0, ph0, fov0, roll0 = _cam_values(cam_curr, dtype, device)
    r1, th1, ph1, fov1, roll1 = _cam_values(cam_prev, dtype, device)
    depth = r0 if depth is None else torch.as_tensor(depth, dtype=dtype,
                                                     device=device)
    pos0, er0, eth0, eph0 = _cam_basis(r0, th0, ph0)
    pos1, er1, eth1, eph1 = _cam_basis(r1, th1, ph1)

    ys = div_c(torch.arange(height, dtype=dtype, device=device) + 0.5,
               float(height))
    xs = div_c(torch.arange(width, dtype=dtype, device=device) + 0.5,
               float(width))
    ny, nx = torch.meshgrid(1.0 - ys * 2.0, xs * 2.0 - 1.0, indexing="ij")

    aspect = torch.tensor(width / height, dtype=dtype, device=device)
    k1_0 = tan(div_c(fov0, 2.0)) * aspect
    k2_0 = tan(div_c(fov0, 2.0))
    cx = nx * k1_0
    cy = ny * k2_0
    rc, rs = cos(roll0), sin(roll0)
    cx, cy = cx * rc - cy * rs, cx * rs + cy * rc

    inv_n = 1.0 / sqrt(1.0 + cx * cx + cy * cy)
    d = (-er0[:, None, None] - cx[None] * eph0[:, None, None]
         - cy[None] * eth0[:, None, None]) * inv_n[None]
    wpos = pos0[:, None, None] + depth * d

    v = wpos - pos1[:, None, None]
    a_r, a_th, a_ph = (_dot3(e, v) for e in (er1, eth1, eph1))
    in_front = a_r < -1e-6
    safe = torch.where(in_front, a_r, -1.0)
    pcx = a_ph / safe
    pcy = a_th / safe
    rc1, rs1 = cos(roll1), sin(roll1)
    pcx, pcy = pcx * rc1 + pcy * rs1, -pcx * rs1 + pcy * rc1
    k1_1 = tan(div_c(fov1, 2.0)) * aspect
    k2_1 = tan(div_c(fov1, 2.0))
    px = (pcx / k1_1 + 1.0) * 0.5 * width - 0.5
    py = (1.0 - pcy / k2_1) * 0.5 * height - 0.5
    valid = (in_front & (px >= -0.5) & (px <= width - 0.5)
             & (py >= -0.5) & (py <= height - 0.5))
    return py, px, valid


def _bilinear(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor):
    """Bilinear sample of an (H, W, C) image at float pixel coordinates,
    clamped to the frame."""
    h, w = img.shape[:2]
    py = clip(py, 0.0, h - 1.0)
    px = clip(px, 0.0, w - 1.0)
    y0 = torch.floor(py).long()
    x0 = torch.floor(px).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = (py - y0.to(img.dtype))[..., None]
    fx = (px - x0.to(img.dtype))[..., None]
    top = img[y0, x0] * (1.0 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1.0 - fx) + img[y1, x1] * fx
    return top * (1.0 - fy) + bot * fy


def taa_resolve_reprojected(history: torch.Tensor, current: torch.Tensor,
                            cam_prev, cam_curr, base_feedback=0.7,
                            clamp_k: float = 1.5) -> torch.Tensor:
    """Motion-aware resolve: the history warped through the camera's motion
    (``reproject_uv``, bilinear), clamped to the current frame's YCoCg box
    and blended; disoccluded and off-screen pixels take the current frame.
    ``cam_prev`` / ``cam_curr``: (5,) (r, theta, phi, fov, roll)."""
    h, w = current.shape[:2]
    py, px, valid = reproject_uv(cam_prev, cam_curr, h, w,
                                 dtype=current.dtype, device=current.device)
    warped = _bilinear(history, py, px)
    return _blend(rgb_to_ycocg(warped), rgb_to_ycocg(current), base_feedback,
                  clamp_k, valid)


@dataclasses.dataclass
class TemporalAccumulator:
    """The frame loop's history. ``resolve(frame, moving=..., camera=...)``
    once per rendered frame returns the accumulated frame and keeps it as
    the history. ``jitter_index`` is the frame count, the index into the
    Halton jitters (``render/pipeline.halton_jitters``) of the next frame's
    camera, so that accumulation converges to the supersampled image."""

    feedback: float = 0.7
    clamp_k: float = 1.5
    history: torch.Tensor | None = None
    frame_count: int = 0
    # (r, theta, phi, fov, roll) of the history's camera, when the frames
    # came with one: a moving camera then reprojects instead of resetting.
    prev_camera: tuple | None = None

    @property
    def jitter_index(self) -> int:
        return self.frame_count

    def reset(self) -> None:
        self.history = None
        self.frame_count = 0
        self.prev_camera = None

    def resolve(self, frame: torch.Tensor, moving: bool = False,
                camera: tuple | None = None) -> torch.Tensor:
        """Accumulate one (H, W, 3) frame. ``camera``: the frame's
        (r, theta, phi, fov, roll); with a previous one and ``moving`` the
        history is reprojected through the motion (and its sample count
        decays by a quarter) instead of being reset."""
        if self.history is None or self.history.shape != frame.shape:
            self.history = frame
            self.frame_count = 1
            self.prev_camera = camera
            return frame
        # Early frames converge faster than the steady-state feedback.
        eff = min(self.feedback, 1.0 - 1.0 / (self.frame_count + 1))
        if moving and camera is not None and self.prev_camera is not None:
            self.history = taa_resolve_reprojected(
                self.history, frame, self.prev_camera, camera, eff,
                self.clamp_k)
            self.frame_count = max(int(self.frame_count * 0.75), 1) + 1
        else:
            self.history = taa_resolve(self.history, frame, moving, eff,
                                       self.clamp_k)
            self.frame_count = 1 if moving else self.frame_count + 1
        self.prev_camera = camera
        return self.history
