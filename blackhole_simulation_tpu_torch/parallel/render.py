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

The sharded render is differentiable, as JAX's ``shard_map`` under
``jax.grad`` is: the scene's tensor leaves (mass, spin, the camera's r,
theta, phi, fov and roll) enter through ``mesh.replicate``, each rank's
shard is marched by ``march_rows`` (under autograd the march kernel
forward, the gradient kernel backward), and the gathered image's
cotangent reaches each rank's shard through ``all_gather``'s backward.
``replicate``'s backward sums the shards' leaf gradients over the mesh in
one all-reduce, so every rank's leaves get the whole gradient, the same
on every rank. Every rank runs the backward. ``dtype`` float64 renders
in float64 on the float64 march kernel; with ``use_pallas`` and no jets
it raises TypeError, as the JAX package's Pallas march does, and under
autograd with ``use_pallas`` NotImplementedError, as ``jax.grad``
raises; both before any collective.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blackhole_simulation_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    replicate,
)


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


def _replicated_scene(scene, mesh: Mesh):
    """``scene`` with its tensor leaves (mass, spin and the camera's five)
    passed through ``replicate``: the same values, whose gradients the
    backward sums over the mesh."""
    cam = scene.camera
    fields = ("r", "theta", "phi", "fov", "roll")
    leaves = [scene.bh.mass, scene.bh.spin] + [getattr(cam, k)
                                               for k in fields]
    at = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    for i, x in zip(at, replicate(mesh, [leaves[i] for i in at])):
        leaves[i] = x
    bh = dataclasses.replace(scene.bh, mass=leaves[0], spin=leaves[1])
    cam = dataclasses.replace(cam, **dict(zip(fields, leaves[2:])))
    return dataclasses.replace(scene, bh=bh, camera=cam)


def render_sharded(scene, mesh: Mesh, n_samples: int = 1,
                   dtype=torch.float32) -> torch.Tensor:
    """Render ``scene`` with its rays sharded over ``mesh``: the tone-mapped
    (H, W, 3) image in ``dtype`` on every rank (on ``mesh.device``).
    ``n_samples`` Halton-jittered samples (jitters in ``dtype``) are
    accumulated in the JAX package's order (from zeros, then divided).
    Differentiable in the scene's tensor leaves (see the module
    docstring). Every rank of the mesh must call it, with the same scene,
    and, under autograd, run the backward."""
    from blackhole_simulation_tpu_torch._elementwise import grad_wanted
    from blackhole_simulation_tpu_torch.ops.pallas_march import (
        TILE,
        from_block_order,
        to_block_order,
    )
    from blackhole_simulation_tpu_torch.render.camera import camera_rays_u
    from blackhole_simulation_tpu_torch.render.march import march_rows
    from blackhole_simulation_tpu_torch.render.pipeline import (
        _mass_spin,
        check_render_dtype,
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
    # Every refusal before the first collective, the same on every rank.
    check_render_dtype(dtype)
    if cfg.use_pallas and dtype == torch.float64:
        raise TypeError(
            "render_sharded: float64 rays on the Pallas march route, where "
            "the JAX package's pallas_march_u fails to trace (TypeError: "
            "while_loop body function carry input and carry output must "
            "have equal types); take use_pallas=False")
    if cfg.use_pallas and grad_wanted(*scene.leaves()):
        raise NotImplementedError(
            "render_sharded: use_pallas marches on the march kernel forward "
            "only, as the JAX package's pallas_march_u has no VJP (jax.grad "
            "raises); take use_pallas=False")
    pad_unit = n_dev * TILE if use_pallas else n_dev
    spec = shard_rays_spec(mesh)
    scene = _replicated_scene(scene, mesh)
    cam = scene.camera
    m, a = _mass_spin(scene, device, dtype)
    luts = scene_luts(scene, device, dtype)

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

    if n_samples == 1:
        acc = one_sample(None)
    else:
        acc = torch.zeros((n_pix, 3), dtype=dtype, device=device)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        for jit in halton_jitters(n_samples, np_dtype):
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
