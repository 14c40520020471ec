"""Screen-tile scheduler for progressive rendering.

Counterpart of ``blackhole_simulation_tpu/render/tiles.py``: ``TileGrid``
(:29) splits the frame into fixed tiles, ``TileManager`` (:59) hands them
out center first and requeues the highest-variance ones, and
``ProgressiveRenderer`` (:102) renders a batch of ``batch_tiles`` tiles at
a time as one (batch_tiles tile^2,) ray batch (``camera_rays_indexed``,
``march``, ``shade_sample``) into an accumulation image. The scheduler is
host numpy, as in the JAX package, and gives its order, ties included.

One difference from the JAX package: it turns ``use_pallas`` off off the
TPU (tiles.py:127-129); the port keeps the scene's ``use_pallas``, so on
``cuda`` every batch is one launch of the march kernel (``csrc/march.cu``,
through ``render/march.py::march``, which applies no pixel-block reorder:
a batch's rays are marched in the order given), and on the CPU the plain
march runs. Mass and spin enter as float64 0-d tensors, as the JAX
package's tile renderer passes its float64 ``Kerr``: the camera's tetrad
is float64 arithmetic, and the shading rounds its float64 radii to the
float32 rows. The image lives on the render's device; the per-tile luma
variance that ``TileManager.report`` reads is computed from the batch's
radiance on the host in numpy, as the JAX package computes it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blackhole_simulation_tpu_torch.render.pipeline import (
    Scene,
    resolve_device,
    shade_sample,
)

_LUMA = np.array([0.25, 0.5, 0.25])


@dataclasses.dataclass(frozen=True)
class TileGrid:
    width: int
    height: int
    tile: int = 64

    @property
    def nx(self) -> int:
        return -(-self.width // self.tile)

    @property
    def ny(self) -> int:
        return -(-self.height // self.tile)

    @property
    def n_tiles(self) -> int:
        return self.nx * self.ny

    def pixel_ids(self, tile_ids: np.ndarray) -> np.ndarray:
        """Flat row-major pixel ids of a batch of tiles, (B, tile^2). Edge
        tiles repeat their last in-frame row and column in place of the
        pixels outside the frame, so every tile has tile^2 rays."""
        ty, tx = np.divmod(np.asarray(tile_ids, np.int64), self.nx)
        dy, dx = np.meshgrid(np.arange(self.tile), np.arange(self.tile),
                             indexing="ij")
        py = np.minimum(ty[:, None, None] * self.tile + dy, self.height - 1)
        px = np.minimum(tx[:, None, None] * self.tile + dx, self.width - 1)
        return (py * self.width + px).reshape(len(ty), -1)


class TileManager:
    """Priority tile queue: center-weighted first (the hole sits at the
    frame's center); ``report`` records each tile's luma variance, and
    ``refine_queue`` requeues the highest-variance tiles."""

    def __init__(self, grid: TileGrid):
        self.grid = grid
        ty, tx = np.divmod(np.arange(grid.n_tiles), grid.nx)
        cy, cx = (grid.ny - 1) / 2.0, (grid.nx - 1) / 2.0
        self._priority = -np.hypot(ty - cy, tx - cx)
        self._pending = list(np.argsort(-self._priority))
        self._seen_variance = np.zeros(grid.n_tiles)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def next_batch(self, size: int) -> np.ndarray:
        """Pop up to ``size`` tiles, padded to ``size`` by repeating the
        last one; empty when nothing is pending."""
        if not self._pending:
            return np.empty(0, dtype=np.int64)
        take = self._pending[:size]
        self._pending = self._pending[size:]
        if len(take) < size:
            take = take + [take[-1]] * (size - len(take))
        return np.asarray(take, dtype=np.int64)

    def report(self, tile_ids: np.ndarray, variance: np.ndarray) -> None:
        """Record measured per-tile variance."""
        self._seen_variance[np.asarray(tile_ids)] = np.asarray(variance)

    def refine_queue(self, frac: float = 0.25) -> None:
        """Requeue the top ``frac`` of tiles by variance."""
        n = max(1, int(self.grid.n_tiles * frac))
        self._pending = list(np.argsort(-self._seen_variance)[:n])


class ProgressiveRenderer:
    """Render a scene batch by batch of tiles into an accumulation image
    ((H, W, 3) float32 on ``device``: ``cuda`` unless the caller passes
    ``"cpu"``). Each ``step()`` marches batch_tiles tile^2 rays. On covered
    pixels the image is the staged render's radiance up to the chaotic
    photon-ring pixels: the same march and shading, but rays born in theta
    form from a float64 tetrad, as the JAX package's tiles are."""

    def __init__(self, scene: Scene, tile: int = 64, batch_tiles: int = 8,
                 device=None):
        cam = scene.camera
        self.scene = scene
        self.device = resolve_device(device)
        self.grid = TileGrid(cam.width, cam.height, tile)
        self.manager = TileManager(self.grid)
        self.batch_tiles = batch_tiles
        self.image = torch.zeros((cam.height, cam.width, 3),
                                 dtype=torch.float32, device=self.device)
        self.covered = np.zeros(cam.height * cam.width, bool)

    def _render_ids(self, pix_ids: torch.Tensor) -> torch.Tensor:
        """(N, 3) float32 radiance of the flat pixel ids."""
        from blackhole_simulation_tpu_torch.render.camera import (
            camera_rays_indexed,
        )
        from blackhole_simulation_tpu_torch.render.march import march

        f64 = dict(dtype=torch.float64, device=self.device)
        m = torch.tensor(float(self.scene.bh.mass), **f64)
        a = torch.tensor(float(self.scene.bh.spin), **f64)
        rays = camera_rays_indexed(self.scene.camera, m, a, pix_ids)
        result = march(rays, m, a, self.scene.march_cfg)
        return shade_sample(result, m, a, self.scene, rays)

    def step(self) -> bool:
        """Render one batch of tiles; False when nothing is pending."""
        ids = self.manager.next_batch(self.batch_tiles)
        if ids.size == 0:
            return False
        pix = self.grid.pixel_ids(ids)
        flat_ids = torch.from_numpy(pix.reshape(-1)).to(self.device)
        with torch.no_grad():
            rgb = self._render_ids(flat_ids)
        self.image.view(-1, 3)[flat_ids] = rgb
        self.covered[pix.reshape(-1)] = True
        rgb_host = rgb.cpu().numpy().reshape(len(ids), -1, 3)
        var = np.array([float(np.var(t @ _LUMA)) for t in rgb_host])
        self.manager.report(ids, var)
        return True

    def render_all(self) -> torch.Tensor:
        while self.step():
            pass
        return self.image
