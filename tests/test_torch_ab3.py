"""The port's AB3 march (``MarchConfig.multistep``) against the JAX
package's, on the CPU.

``ops/march.py::march_tile_ab3`` (the plain version of ``csrc/march.cu``'s
and ``csrc/render.cu``'s AB3 instantiation) is held against the JAX
package's ``ops/pallas_march.py::march_tile_ab3`` called directly on (N,)
rows (it is plain jnp outside the Pallas call), run op by op
(``jax.disable_jit``), in four renormalization regimes at two spins, in
float32 and in float64: identical hit, steps and crossing counts, and
|d| < 1e-4 on states, records and r_min in float32 (tests/test_pallas.py:
81-98's bar), 1e-12 in float64. Then the render paths: ``multistep``
without ``use_pallas`` is the midpoint march (the JAX package's jnp march
ignores the flag), the fused and staged AB3 renders agree, the AB3 render
stays within tests/test_ab3.py:48-62's structural bars of the midpoint
render, and ``march_rows_ad`` refuses the AB3 march where it would run it.
"""

import dataclasses as dc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render import render_radiance as j_render_radiance
from blackhole_simulation_tpu_torch.ops.march import (
    ab3_renorm_plan,
    march_tile_ab3,
)
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays_u
from blackhole_simulation_tpu_torch.render.march import (
    MarchConfig,
    _march_inputs,
    march_rows_ad,
)
from blackhole_simulation_tpu_torch.render.pipeline import (
    render_radiance,
    scene_from_numpy,
)

jpm = importlib.import_module("blackhole_simulation_tpu.ops.pallas_march")

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)

# (max_steps, renormalize_every, exit_check_every): the default cadence; a
# budget below the exit cadence (the block is then the whole budget, so a
# renormalize_every that is no multiple of it never fires); 12/8, where
# the JAX package never renormalizes AB3; and 60 steps at 16/8, whose last
# renormalization (at 64) lies past the last step.
REGIMES = {
    "default-16-8": (48, 16, 8),
    "steps-below-exit": (40, 20, 64),
    "no-renorm-12-8": (48, 12, 8),
    "tail-60-16-8": (60, 16, 8),
}


def test_renorm_plans():
    plan = lambda s, r, e: ab3_renorm_plan(MarchConfig(
        max_steps=s, renormalize_every=r, exit_check_every=e))
    assert plan(*REGIMES["default-16-8"]) == (16, False)
    assert plan(*REGIMES["steps-below-exit"]) == (0, False)
    assert plan(*REGIMES["no-renorm-12-8"]) == (0, False)
    assert plan(*REGIMES["tail-60-16-8"]) == (16, True)
    assert plan(40, 40, 64) == (40, False)   # the boundary is the last step
    assert plan(36, 16, 8) == (16, False)    # the last boundary, 40, not due
    assert plan(44, 16, 8) == (16, True)     # the last boundary, 48, due


def _rows(spin, cfg, width=32, height=24, dtype=torch.float32):
    cam = Camera.create(r=30.0, theta=THETA, fov=0.5, width=width,
                        height=height)
    m = torch.tensor(1.0, dtype=dtype)
    a = torch.tensor(np.float32(spin) if dtype == torch.float32 else spin,
                     dtype=dtype)
    with torch.no_grad():
        yt0, thr, m, a, r_h, r_ph = _march_inputs(
            camera_rays_u(cam, m, a, dtype=dtype), m, a, cfg, None)
    rows = tuple(yt0[i] for i in (0, 1, 2, 3, 5, 6, 7))
    return (m, a, r_h, r_ph, thr), rows


# Each regime at both spins in float32 and in float64 (the march kernel's
# float64 AB3 instantiation has this plain version as its reference).
# Float64's bar: the same integers, and |d| <= 1e-12 on the rest (the two
# agree to ~3e-13, 0 where no renormalization fires).
CASES = {f"{name}-a{spin}{tag}": (spin, REGIMES[name], dtype)
         for name in sorted(REGIMES) for spin in (0.9, 0.999)
         for tag, dtype in (("", torch.float32), ("-f64", torch.float64))}
# (atol, rtol): float32's is tests/test_pallas.py's (numpy's default rtol)
TOL = {torch.float32: (1e-4, 1e-7), torch.float64: (1e-12, 0.0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_march_tile_ab3_matches_jax(case):
    spin, (steps, renorm, exit_every), dtype = CASES[case]
    kw = dict(max_steps=steps, renormalize_every=renorm,
              exit_check_every=exit_every, shadow_precull=True,
              far_step_cap_rate=0.4, far_boost_radius=20.0,
              midpoint_iters=1, step_rate=0.2, multistep=True)
    cfg = MarchConfig(**kw)
    scal, rows = _rows(spin, cfg, dtype=dtype)
    with torch.no_grad():
        out = march_tile_ab3(*scal, rows, cfg)
    j = lambda x: jnp.asarray(x.numpy())
    with jax.disable_jit():
        ref = jpm.march_tile_ab3(*(j(x) for x in scal),
                                 tuple(j(x) for x in rows),
                                 JMarchConfig(**kw))[:13]
    assert all(np.asarray(ref[i]).dtype == out[i].numpy().dtype
               for i in range(13))
    for i in (6, 7, 11):   # hit, steps, crossing count
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref[i]), i)
    atol, rtol = TOL[dtype]
    for i in (0, 1, 2, 3, 4, 5, 8, 9, 10, 12):
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]),
                                   atol=atol, rtol=rtol, err_msg=str(i))
    assert (out[11].numpy() > 0).any() and (out[6].numpy() == 2).any()


# The render tests' scene: test_fused.py's short-horizon MarchConfig.
BASE = dict(max_steps=48, shadow_precull=True, far_step_cap_rate=0.4,
            far_boost_radius=20.0, midpoint_iters=1, remat_every=0)


def _scene(width, height, spin=0.9, **cfg):
    return scene_from_numpy(
        mass=1.0, spin=spin,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=width, height=height),
        march_cfg={**BASE, **cfg})


def test_multistep_without_use_pallas_is_the_midpoint_march():
    cfg = {**BASE, "multistep": True}
    jcam = JCamera.create(r=30.0, theta=THETA, fov=0.5, width=48, height=32)
    js = JScene.create(mass=1.0, spin=0.9, camera=jcam,
                       march_cfg=JMarchConfig(**cfg))
    with jax.disable_jit():
        ref = np.asarray(j_render_radiance(js, dtype=jnp.float32))
    out = render_radiance(_scene(48, 32, multistep=True), device="cpu")
    d = np.abs(out.numpy() - ref)
    assert np.percentile(d, 99) < 1e-4 and d.mean() < 1e-5, d.mean()
    mid = render_radiance(_scene(48, 32), device="cpu")
    assert torch.equal(out, mid)


def test_fused_ab3_matches_staged_ab3():
    fused = render_radiance(_scene(96, 54, multistep=True, use_pallas=True,
                                   fused=True), device="cpu")
    staged = render_radiance(_scene(96, 54, multistep=True, use_pallas=True),
                             device="cpu")
    d = (fused - staged).abs()
    assert bool(torch.isfinite(fused).all())
    assert float(torch.quantile(d.flatten(), 0.99)) < 1e-4
    assert float(d.mean()) < 1e-5


def test_ab3_render_structurally_close_to_midpoint():
    kw = dict(max_steps=96, use_pallas=True, fused=True)
    ab3 = render_radiance(_scene(64, 32, multistep=True, **kw), device="cpu")
    mid = render_radiance(_scene(64, 32, **kw), device="cpu")
    assert bool(torch.isfinite(ab3).all())
    d = (ab3 - mid).abs()
    assert float(d.median()) < 5e-3
    assert float((d < 0.3).float().mean()) > 0.95
    assert float(d.max()) > 0.0   # the two marches differ


def _spin_grad(cfg):
    cam = Camera.create(r=30.0, theta=THETA, fov=0.5, width=12, height=8)
    m = torch.tensor(1.0)
    a = torch.tensor(0.7, requires_grad=True)
    rows = march_rows_ad(camera_rays_u(cam, m, a), m, a, cfg)
    loss = rows.state_u[1].mean() + 0.1 * rows.cross_r.mean()
    return torch.autograd.grad(loss, a)[0]


def test_march_rows_ad_refuses_the_ab3_march():
    cfg = MarchConfig(max_steps=24, shadow_precull=False, multistep=True)
    with pytest.raises(NotImplementedError):
        _spin_grad(dc.replace(cfg, use_pallas=True))
    # Without use_pallas the flag is dropped: the midpoint march's gradient.
    g = _spin_grad(cfg)
    assert torch.isfinite(g) and torch.equal(
        g, _spin_grad(dc.replace(cfg, multistep=False)))
