"""Frames of the reference: the supersampled, tone-mapped image of a band
of rows (``render()``'s arithmetic: Halton-jittered samples, their mean,
exposure, bloom, ACES, gamma, frozen from the port's
``render/pipeline.py`` and ``render/post.py``), and each ray's step
count."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import camera, geodesic, shading
from benchmark.reference.numerics import (
    clip,
    event_horizon,
    isco,
    maximum,
    photon_sphere,
)

CHUNK = 1 << 21
# Two passes of a radius-4 blur along each axis: the rows a band's inner
# rows depend on through the bloom.
BLOOM_MARGIN = 8
_GAUSS9 = (0.0162162162, 0.0540540541, 0.1216216216, 0.1945945946,
           0.2270270270, 0.1945945946, 0.1216216216, 0.0540540541,
           0.0162162162)
_LUMA = (0.2126, 0.7152, 0.0722)


def halton_jitters(n: int) -> np.ndarray:
    """n Halton(2, 3) sub-pixel offsets in [-0.5, 0.5]^2, float32."""
    def h(i, base):
        f, r = 1.0, 0.0
        while i > 0:
            f /= base
            r += f * (i % base)
            i //= base
        return r
    return np.array([[h(i + 1, 2) - 0.5, h(i + 1, 3) - 0.5]
                     for i in range(n)], np.float32).reshape(n, 2)


@dataclasses.dataclass(frozen=True)
class Scene:
    """A configuration's scene in the reference's terms, in one dtype."""

    mass: float
    spin: float
    cam: dict
    cfg: geodesic.March
    disk: shading.Disk
    stars: shading.Stars
    features: dict
    post: dict
    dtype: torch.dtype
    device: str

    @classmethod
    def of(cls, config: dict, dtype, device, **camera_pose):
        cam = dict(config["camera"], width=config["width"],
                   height=config["height"], **camera_pose)
        return cls(mass=config["mass"], spin=config["spin"], cam=cam,
                   cfg=geodesic.March.of(config["march"]),
                   disk=shading.Disk(**config.get("disk", {})),
                   stars=shading.Stars(**config.get("stars", {})),
                   features=config["features"], post=config.get("post", {}),
                   dtype=dtype, device=device)

    def scalars(self):
        t = lambda v: torch.tensor(v, dtype=self.dtype, device=self.device)
        m, a = t(self.mass), t(self.spin)
        r_h = event_horizon(m, a)
        thr = self.cfg.horizon_factor * r_h
        stop = torch.maximum(torch.clamp(isco(m, a),
                                         min=self.cfg.record_r_min), thr)
        return m, a, r_h, photon_sphere(m, a), isco(m, a), thr, stop


def _rays(scene: Scene, ids, jitter, m, a):
    theta = torch.tensor(scene.cam["theta"], dtype=torch.float64,
                         device=scene.device)
    return camera.rays(m, a, theta, scene.cam, ids, jitter)


def _march(scene: Scene, rows, scalars):
    m, a, r_h, r_ph, r_in, thr, stop = scalars
    c = geodesic.march(m, a, r_h, r_ph, thr, stop,
                       tuple(rows[[0, 1, 2, 3, 5, 6, 7]]), scene.cfg)
    steps = torch.where(c.hit == geodesic.HORIZON, c.steps_out, c.steps)
    return c, steps


def trace(scene: Scene, pix_ids, jitter, tables):
    """(N, 3) radiance of the pixels' rays at one sub-pixel ``jitter``."""
    scalars = scene.scalars()
    m, a, r_h, r_ph, r_in, thr, stop = scalars
    out = []
    for lo in range(0, pix_ids.numel(), CHUNK):
        rows = _rays(scene, pix_ids[lo:lo + CHUNK], jitter, m, a)
        c, _ = _march(scene, rows, scalars)
        rgb = shading.composite(c, rows[7], camera.conserved_lam(rows), m, a,
                                r_in, r_ph, scene.disk, scene.stars,
                                scene.features, tables)
        out.append(torch.stack(rgb, dim=-1))
    return torch.cat(out)


def _blur(img, axis):
    out = _GAUSS9[4] * img
    for k in range(1, 5):
        out = (out + _GAUSS9[4 - k] * torch.roll(img, k, dims=axis)
               + _GAUSS9[4 + k] * torch.roll(img, -k, dims=axis))
    return out


def tonemap(img: torch.Tensor, post: dict) -> torch.Tensor:
    """(H, W, 3) radiance -> exposure, bloom, ACES, gamma."""
    img = img * post.get("exposure", 1.0)
    if post.get("bloom_enabled", True):
        luma = img[..., 0] * _LUMA[0] + img[..., 1] * _LUMA[1] + img[..., 2] * _LUMA[2]
        bright = img * maximum(luma - post.get("bloom_threshold", 0.85),
                               0.0)[..., None]
        for _ in range(post.get("bloom_passes", 2)):
            bright = _blur(_blur(bright, 0), 1)
        img = img + post.get("bloom_strength", 0.55) * bright
    x = img
    x = clip((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)
    return torch.pow(clip(x, 0.0, 1.0), 1.0 / post.get("gamma", 2.2))


def band(scene: Scene, y0: int, y1: int, n_samples: int, tables):
    """Rows [y0, y1) of the tone-mapped frame, (y1 - y0, W, 3): the mean of
    ``n_samples`` jittered samples over the band and BLOOM_MARGIN rows on
    each side (rows wrap, as the bloom's do), then the tone map."""
    h, w = scene.cam["height"], scene.cam["width"]
    rows = torch.arange(y0 - BLOOM_MARGIN, y1 + BLOOM_MARGIN,
                        device=scene.device) % h
    ids = (rows[:, None] * w + torch.arange(w, device=scene.device)).reshape(-1)
    tab = shading.tables_on(tables, scene.dtype, scene.device)
    jitters = ([None] if n_samples == 1 else halton_jitters(n_samples))
    acc = None
    for jit in jitters:
        rgb = trace(scene, ids, (0.0, 0.0) if jit is None else jit, tab)
        acc = rgb if acc is None else acc + rgb
    if n_samples > 1:
        acc = acc / n_samples
    img = tonemap(acc.reshape(rows.numel(), w, 3), scene.post)
    return img[BLOOM_MARGIN:BLOOM_MARGIN + (y1 - y0)]


def mean_steps(scenes: list, samples: list) -> list[float]:
    """Mean least steps per ray of each scene (one per camera pose, all of
    one mass, spin and march) over its ``samples`` entry: (pixel ids,
    (N,) jitter x, (N,) jitter y). One march for all of them."""
    scalars = scenes[0].scalars()
    m, a = scalars[:2]
    rows = torch.cat([_rays(sc, ids, (jx, jy), m, a)
                      for sc, (ids, jx, jy) in zip(scenes, samples)], dim=1)
    steps = torch.cat([_march(scenes[0], rows[:, lo:lo + CHUNK], scalars)[1]
                       for lo in range(0, rows.shape[1], CHUNK)])
    sizes = [ids.numel() for ids, _, _ in samples]
    return [float(x.double().mean()) for x in torch.split(steps, sizes)]
