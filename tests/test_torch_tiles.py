"""The tile scheduler and the progressive renderer on the port against the
JAX package's, on the CPU.

``TileGrid`` and ``TileManager`` give JAX's tile ids, pixel ids and order,
ties included, over a whole run (batches to exhaustion, seeded variances,
a refinement queue, batches again). ``ProgressiveRenderer`` at 64x64,
tile 32, batch 2, 48 steps against JAX's run op by op (jitted XLA
contracts the float32 step's and the lattice hash's multiply-adds), for
the default MarchConfig and the flagship's (``use_pallas``, shadow
precull; the plain march on the CPU, as JAX runs its jnp march off the
TPU): the short-horizon bar p99 < 1e-4 (measured: p99 4.3e-7 default,
5.7e-5 flagship), every pixel covered; each tile's recorded variance is
``np.var`` of its luma (rgb @ (0.25, 0.5, 0.25)), exactly, and within
rel 1e-2 of JAX's (measured 6.8e-4, the images' difference). Then
tests/test_tiles.py's ``test_matches_full_render`` bar on the port: the
tiles against the port's own ``render_radiance``.
"""

import dataclasses as dc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render import tiles as jtiles
from blackhole_simulation_tpu_torch.render import tiles as ttiles
from blackhole_simulation_tpu_torch.render.pipeline import (
    render_radiance,
    scene_from_numpy,
)

torch.set_num_threads(1)

THETA = math.pi / 2 - 0.3
CFGS = {
    "default": dict(max_steps=48),
    "flagship": dict(max_steps=48, use_pallas=True, shadow_precull=True,
                     step_rate=0.2, far_step_cap_rate=0.4,
                     far_boost_radius=20.0, midpoint_iters=1),
}


@pytest.mark.parametrize("shape", [(100, 70, 16), (64, 64, 32), (40, 40, 32),
                                   (1920, 1080, 64)])
def test_grid_and_manager_match_jax(shape):
    width, height, tile = shape
    jg, tg = jtiles.TileGrid(width, height, tile), ttiles.TileGrid(
        width, height, tile)
    assert (tg.nx, tg.ny, tg.n_tiles) == (jg.nx, jg.ny, jg.n_tiles)
    jm, tm = jtiles.TileManager(jg), ttiles.TileManager(tg)
    rng = np.random.default_rng(width)
    batches = 0
    for rnd in range(2):
        while True:
            jb, tb = jm.next_batch(5), tm.next_batch(5)
            np.testing.assert_array_equal(tb, jb)
            assert tm.pending == jm.pending
            if tb.size == 0:
                break
            batches += 1
            np.testing.assert_array_equal(tg.pixel_ids(tb), jg.pixel_ids(jb))
            # Ties: half the tiles report the same variance.
            var = np.where(rng.random(len(tb)) < 0.5, 0.25, rng.random(len(tb)))
            jm.report(jb, var)
            tm.report(tb, var)
        jm.refine_queue(0.3)
        tm.refine_queue(0.3)
    assert batches >= 2


def _scenes(cfg):
    jcam = JCamera.create(r=25.0, theta=jnp.pi / 2 - 0.3, fov=0.6, width=64,
                          height=64)
    jscene = JScene.create(mass=1.0, spin=0.9, camera=jcam,
                           march_cfg=JMarchConfig(**cfg))
    tscene = scene_from_numpy(
        mass=1.0, spin=0.9,
        camera=dict(r=25.0, theta=THETA, phi=0.0, fov=0.6, roll=0.0,
                    width=64, height=64),
        march_cfg=dc.asdict(jscene.march_cfg),
        features=dc.asdict(jscene.features), disk=dc.asdict(jscene.disk),
        stars=dc.asdict(jscene.stars), post=dc.asdict(jscene.post))
    return jscene, tscene


@pytest.mark.parametrize("cfg", sorted(CFGS))
def test_progressive_matches_jax(cfg):
    jscene, tscene = _scenes(CFGS[cfg])
    jprog = jtiles.ProgressiveRenderer(jscene, tile=32, batch_tiles=2)
    tprog = ttiles.ProgressiveRenderer(tscene, tile=32, batch_tiles=2,
                                       device="cpu")
    with jax.disable_jit():
        ref = np.asarray(jprog.render_all())
    img = tprog.render_all()
    assert img.dtype == torch.float32 and img.shape == (64, 64, 3)
    assert tprog.covered.all() and jprog.covered.all()
    d = np.abs(img.numpy() - ref)
    assert np.quantile(d, 0.99) < 1e-4, (np.quantile(d, 0.99), d.max())
    flat = img.numpy().reshape(-1, 3)
    grid = tprog.grid
    own = [np.var(flat[ids] @ np.array([0.25, 0.5, 0.25]))
           for ids in grid.pixel_ids(np.arange(grid.n_tiles))]
    np.testing.assert_array_equal(tprog.manager._seen_variance, own)
    np.testing.assert_allclose(tprog.manager._seen_variance,
                               jprog.manager._seen_variance, rtol=1e-2)


def test_matches_full_render():
    _, scene = _scenes(CFGS["default"])
    prog = ttiles.ProgressiveRenderer(scene, tile=32, batch_tiles=2,
                                      device="cpu")
    img = prog.render_all().numpy()
    assert prog.covered.all()
    ref = render_radiance(scene, device="cpu").numpy()
    diff = np.abs(img - ref).max(axis=2)
    assert (diff < 1e-3).mean() > 0.998
    assert diff.max() < 5e-2


def test_progressive_renderer_resolves_the_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, scene = _scenes(CFGS["default"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttiles.ProgressiveRenderer(scene)
