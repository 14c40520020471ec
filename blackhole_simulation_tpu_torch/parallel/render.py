"""The sharded render: rays data-parallel over the device mesh.

Counterpart of ``blackhole_simulation_tpu/parallel/render.py``:
``shard_rays_spec`` (:35), ``_pad_to`` (:40), ``render_sharded`` (:44) and
``gather_image`` (:133); ``single_device_twin`` names the single-device
scene whose ``render()`` equals the sharded image.

Each rank builds the frame's rays (every rank builds all of them, so they
are identical), takes its contiguous shard, marches it with ``march_rows``
(the march kernel, ``csrc/march.cu``, for CUDA rays) and shades it with
``shade_march_rows``; the shards' radiance is all-gathered, so every rank
holds the whole tone-mapped image, as JAX's replicated output. With
``use_pallas`` the rays are put in pixel-block order over the whole frame
first and padded so that every shard owns whole kernel tiles (n_dev x
``TILE``); otherwise they are padded to a multiple of n_dev. Padding rays
are zeros (r = 0): they die at step 0 and are cropped.

As in the JAX package, the sharded render takes neither the fused branch
nor the refinement pass (``refine_band`` is ignored, ADVICE item 3), draws
no shadow overlay, runs no NRS skip, and marches jets scenes without the
jets' emission (``march_rows`` is called without ``jets``) on row-major
rays, with the precull off; with no jets in the call, the march keeps the
scene's kernel route (``approx_recip`` under ``use_pallas``), as JAX's
takes its Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blackhole_simulation_tpu_torch.parallel.mesh import Mesh, all_gather


@dataclasses.dataclass(frozen=True)
class RaySharding:
    """Rays split along N into ``n_shards`` equal contiguous shards over
    every mesh axis, shard ``index`` on this rank: the port's stand-in for
    the JAX package's ``NamedSharding(mesh, P(mesh.axis_names, None))``."""

    n_shards: int
    index: int

    def bounds(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's shard of n entries (n a multiple of the
        shard count)."""
        if n % self.n_shards:
            raise ValueError(f"{n} entries do not split into {self.n_shards} "
                             "equal shards")
        k = n // self.n_shards
        return self.index * k, (self.index + 1) * k

    def shard(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's shard of ``x`` along ``dim`` (a view)."""
        lo, hi = self.bounds(x.shape[dim])
        return x.narrow(dim, lo, hi - lo)


def shard_rays_spec(mesh: Mesh) -> RaySharding:
    """Rays shard along N over every mesh axis."""
    return RaySharding(mesh.size, mesh.rank)


def _pad_to(n: int, multiple: int) -> int:
    return (n + multiple - 1) // multiple * multiple


def render_sharded(scene, mesh: Mesh, n_samples: int = 1,
                   dtype=torch.float32) -> torch.Tensor:
    """Render ``scene`` with its rays sharded over ``mesh``: the tone-mapped
    (H, W, 3) image on every rank (on ``mesh.device``). ``n_samples``
    Halton-jittered samples are accumulated in the JAX package's order
    (from zeros, then divided). Every rank of the mesh must call it."""
    from blackhole_simulation_tpu_torch.ops.pallas_march import (
        TILE,
        from_block_order,
        to_block_order,
    )
    from blackhole_simulation_tpu_torch.render.camera import camera_rays_u
    from blackhole_simulation_tpu_torch.render.march import march_rows
    from blackhole_simulation_tpu_torch.render.pipeline import (
        conserved_lam,
        halton_jitters,
        scene_luts,
        shade_march_rows,
    )
    from blackhole_simulation_tpu_torch.render.post import tonemap

    cam = scene.camera
    h, w = cam.height, cam.width
    n_pix = h * w
    n_dev = mesh.size
    device = mesh.device
    cfg = scene.march_cfg
    if cfg.shadow_precull:
        cfg = dataclasses.replace(cfg, shadow_precull=not scene.features.jets,
                                  precull_keep_disk=scene.features.disk)
    use_pallas = cfg.use_pallas and not scene.features.jets
    pad_unit = n_dev * TILE if use_pallas else n_dev
    spec = shard_rays_spec(mesh)
    m = torch.tensor(float(scene.bh.mass), dtype=dtype, device=device)
    a = torch.tensor(float(scene.bh.spin), dtype=dtype, device=device)
    luts = scene_luts(scene, device)

    def one_sample(jitter):
        rays = camera_rays_u(cam, m, a, jitter=jitter, dtype=dtype)
        if use_pallas:
            rays = to_block_order(rays.T, h, w).T
        n = rays.shape[1]
        rays = torch.nn.functional.pad(rays, (0, _pad_to(n, pad_unit) - n))
        mine = spec.shard(rays).contiguous()
        rows = march_rows(mine, m, a, cfg)
        rgb = torch.stack(shade_march_rows(rows, m, a, scene,
                                           conserved_lam(mine), luts=luts),
                          dim=-1)
        rgb = all_gather(mesh, rgb)[:n]
        return from_block_order(rgb, h, w) if use_pallas else rgb

    with torch.no_grad():
        if n_samples == 1:
            acc = one_sample(None)
        else:
            acc = torch.zeros((n_pix, 3), dtype=dtype, device=device)
            for jit in halton_jitters(n_samples).astype(np.float32):
                acc = acc + one_sample(jit)
            acc = acc / n_samples
        return tonemap(acc.reshape(h, w, 3), scene.post)


def single_device_twin(scene):
    """The scene whose single-device ``render()`` computes what
    ``render_sharded(scene, mesh)`` does, ray for ray: the staged branch
    (fused off), no refinement, no overlay, no NRS skip; a jets scene also
    without its jets and without the precull (its march keeps the kernel
    route, as the sharded one does). ``render()`` orders such a scene's
    rays in blocks where the sharded render orders them by row, which
    changes no ray's result."""
    cfg = dataclasses.replace(scene.march_cfg, fused=False, refine_band=0.0)
    feats = dataclasses.replace(scene.features, shadow_overlay=False,
                                nrs_far_field=False)
    if scene.features.jets:
        cfg = dataclasses.replace(cfg, shadow_precull=False)
        feats = dataclasses.replace(feats, jets=False)
    return dataclasses.replace(scene, march_cfg=cfg, features=feats)


def gather_image(img: torch.Tensor) -> torch.Tensor:
    """The full image on this rank: the identity, since ``render_sharded``
    already returns the whole image on every rank (JAX gathers its
    addressable shards across hosts here; the all-gather is inside the
    render in the port)."""
    return img
