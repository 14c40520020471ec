"""The differentiable tone-mapped render against the JAX package's, on the
CPU: the shadow overlay through ``render``, ``render(n_samples=2)`` and the
per-step cotangent clip (tests/test_torch_render_ad.py's scenes, bars and
child-process references; about 150 s on one worker).

The overlay: the JAX package's ``jax.grad`` of the overlay is NaN in mass,
spin and the camera's theta (its ``bardeen_shadow``:
``sqrt(maximum(beta_sq, 0))`` has an infinite derivative at the curve's
end points, where beta^2 = 0, and at its points with beta^2 < 0 the VJP
multiplies that by the zero of ``maximum``'s mask, even where
``_polyline_distance_sq`` masks the point out). The port's curve takes the
derivative of the points it uses, which is finite. So the overlay scene
holds r, phi, fov and roll to JAX and asserts JAX's NaN in the other
three, and the overlay alone is held in those three to central
differences of JAX's overlay in float64.
"""

import dataclasses as dc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geometry.metrics import KS, Kerr as JKerr
from blackhole_simulation_tpu.render.camera import camera_rays as j_camera_rays
from blackhole_simulation_tpu.render.overlay import (
    shadow_overlay as j_shadow_overlay,
)
from blackhole_simulation_tpu_torch.render.camera import camera_rays
from blackhole_simulation_tpu_torch.render.overlay import shadow_overlay
from test_torch_render_ad import (
    SPIN,
    check_leaves,
    jax_grads_jitted,
    port_grads,
    scenes,
)

torch.set_num_threads(1)

NAMES = ("overlay", "samples", "clip")


@pytest.fixture(scope="module")
def jax_refs():
    return jax_grads_jitted(NAMES)


def test_overlay_render_gradients_match_jax(jax_refs):
    got, img = port_grads("overlay")
    want = jax_refs["overlay"]
    assert bool(torch.isfinite(img).all())
    # mass, spin, theta: NaN in the JAX package (module docstring)
    assert all(math.isnan(want[i]) for i in (0, 1, 3))
    check_leaves(got, want, skip=(0, 1, 3))


@pytest.mark.parametrize("name", ["samples", "clip"])
def test_render_gradients_match_jax(jax_refs, name):
    got, img = port_grads(name)
    assert bool(torch.isfinite(img).all())
    check_leaves(got, jax_refs[name])
    assert max(abs(g) for g in got) > 1e-3


def test_clip_binds():
    """The summed loss makes the clip bind: without it the gradient moves."""
    _, ts, _ = scenes("clip")
    clipped, _ = port_grads("clip")
    free, _ = port_grads("clip", dc.replace(ts, march_cfg=dc.replace(
        ts.march_cfg, cotangent_clip=0.0)))
    assert abs(clipped[0] - free[0]) > 1e-2 * abs(free[0])


def test_overlay_gradients_match_jax_central_differences():
    """shadow_overlay alone, differentiated in mass, spin, the observer's
    theta and the line width, against central differences of JAX's
    overlay in float64 (its jax.grad is NaN in the first three: the
    curve's end points, where beta^2 = 0, give sqrt an infinite
    derivative): rel 5e-3."""
    js, ts, _ = scenes("overlay")
    w = np.random.default_rng(3).uniform(0.5, 1.5, (96, 3))
    th0 = float(ts.camera.theta)

    def j_value(m, a, th, lw):
        bh = JKerr(mass=jnp.float64(m), spin=jnp.float64(a), chart=KS)
        rays = j_camera_rays(js.camera, bh, dtype=jnp.float64)
        out = j_shadow_overlay(jnp.zeros((96, 3), jnp.float64), rays, bh,
                               jnp.float64(th), dtype=jnp.float64,
                               line_width=jnp.float64(lw))
        return float(jnp.sum(out * w))

    p0 = [1.0, SPIN, th0, 0.4]
    want = []
    with jax.disable_jit():
        for i, eps in enumerate((1e-5, 1e-5, 1e-6, 1e-5)):
            hi, lo = list(p0), list(p0)
            hi[i] += eps
            lo[i] -= eps
            want.append((j_value(*hi) - j_value(*lo)) / (2 * eps))
    leaves = [torch.tensor(1.0, requires_grad=True),
              torch.tensor(SPIN, requires_grad=True),
              torch.tensor(th0, dtype=torch.float64, requires_grad=True),
              torch.tensor(0.4, requires_grad=True)]
    m, a, th, lw = leaves
    out = shadow_overlay(torch.zeros(96, 3), camera_rays(ts.camera, m, a),
                         m, a, th, line_width=lw)
    got = torch.autograd.grad(
        (out * torch.from_numpy(w.astype(np.float32))).sum(), leaves)
    for g, x in zip(got, want):
        assert math.isfinite(float(g))
        assert float(g) == pytest.approx(x, rel=5e-3, abs=1e-4)
    assert max(abs(x) for x in want) > 1e-1
