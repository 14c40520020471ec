"""The float64 differentiable render against the JAX package's, on the CPU.

* The port's twin of the JAX package's differentiability contract,
  tests/test_render.py:187-198 (``test_gradient_wrt_spin``): the gradient
  of the mean ``render_radiance(scene, dtype=float64)`` in spin at a = 0.6
  (12x12, fov 0.6, no starfield, no glow, the default MarchConfig),
  ``torch.autograd`` against ``jax.grad`` (rel 1e-9; the two agree to
  ~2e-13) and against JAX's central difference at eps 1e-5 (the JAX
  test's own bar: rtol 5e-2, atol 1e-7).
* All seven leaves (mass, spin, the camera's r, theta, phi, fov, roll) of
  tests/test_torch_render_ad.py's analytic and jets scenes (12x8, 48
  steps, spin 0.7) rendered in float64, against ``jax.grad`` of the same
  in float64: rel 1e-7 per leaf, 1e-12 absolute (the float32 tests' bar
  is 5e-3).

The JAX references run jitted in a child process without fused
multiply-adds (tests/test_torch_render_ad.py's ``JaxChild``). About 110 s
on one worker (170 s under the suite's six), nearly all of it the child's
compiles.
"""

import dataclasses as dc
import json
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render import render_radiance as j_render_radiance
from blackhole_simulation_tpu.render.pipeline import Features as JFeatures
from blackhole_simulation_tpu_torch.render.camera import Camera
from blackhole_simulation_tpu_torch.render.pipeline import (
    Features,
    Scene,
    render_radiance,
)
from test_torch_render_ad import LEAVES, JaxChild, _j_leaves, scenes

torch.set_num_threads(1)

F64 = torch.float64
SPIN0 = 0.6
EPS = 1e-5
SCENE_NAMES = ("analytic", "jets")


def _jax_spin_loss(a):
    cam = JCamera.create(width=12, height=12, fov=0.6)
    scene = JScene.create(mass=1.0, spin=a, camera=cam,
                          features=JFeatures(starfield=False,
                                             photon_ring_glow=False))
    return jnp.mean(j_render_radiance(scene, dtype=jnp.float64))


def _port_spin_loss(a):
    cam = Camera.create(width=12, height=12, fov=0.6)
    scene = Scene.create(mass=1.0, spin=a, camera=cam,
                         features=Features(starfield=False,
                                           photon_ring_glow=False))
    return render_radiance(scene, device="cpu", dtype=F64).mean()


def child_main(names):
    g = jax.grad(_jax_spin_loss)(jnp.asarray(SPIN0, jnp.float64))
    fd = (_jax_spin_loss(jnp.asarray(SPIN0 + EPS))
          - _jax_spin_loss(jnp.asarray(SPIN0 - EPS))) / (2 * EPS)
    out = {"spin_grad": float(g), "spin_fd": float(fd)}
    for name in names:
        js, _, _ = scenes(name)
        loss = lambda s: jnp.mean(j_render_radiance(s, dtype=jnp.float64))
        out[name] = _j_leaves(jax.jit(jax.grad(loss))(js))
    return out


@pytest.fixture(scope="module")
def jax_refs():
    child = JaxChild(__file__, *SCENE_NAMES)
    try:
        return child.result()
    finally:
        child.close()


def test_gradient_wrt_spin(jax_refs):
    a = torch.tensor(SPIN0, dtype=F64, requires_grad=True)
    g = float(torch.autograd.grad(_port_spin_loss(a), a)[0])
    assert abs(g - jax_refs["spin_grad"]) <= 1e-9 * abs(jax_refs["spin_grad"])
    fd = jax_refs["spin_fd"]
    assert abs(g - fd) <= 1e-7 + 5e-2 * abs(fd), (g, fd)


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_every_leaf_matches_jax_in_float64(jax_refs, name):
    _, ts, _ = scenes(name)
    t = lambda v: torch.tensor(float(v), dtype=F64, requires_grad=True)
    cam = ts.camera
    leaves = [t(ts.bh.mass), t(ts.bh.spin)] + [t(getattr(cam, k))
                                               for k in LEAVES[2:]]
    sc = dc.replace(
        ts, bh=dc.replace(ts.bh, mass=leaves[0], spin=leaves[1]),
        camera=dc.replace(cam, **dict(zip(LEAVES[2:], leaves[2:]))))
    img = render_radiance(sc, device="cpu", dtype=F64)
    assert img.dtype == F64
    got = [float(g) for g in torch.autograd.grad(img.mean(), leaves)]
    want = jax_refs[name]
    bad = [(k, g, w) for k, g, w in zip(LEAVES, got, want)
           if not abs(g - w) <= 1e-7 * abs(w) + 1e-12]
    assert not bad, bad


if __name__ == "__main__":
    # The child process of the jax_refs fixture: one JSON line.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(child_main(sys.argv[1:])))
