"""The port's float64 oracle against the JAX package's, on the CPU.

``oracle_march`` / ``oracle_render`` at 12x8, a = 0.999, disk on, against
the JAX oracle (JAX's ``oracle_render`` body, pipeline.py:620-626, its
march jitted, its shading op by op): hit codes identical on >= 99% of rays
and the image p99 |d| < 1e-6, the max and any differing rays in the
message. The exit test after each block of trials gives what a
test after every trial gives. ``shade_sample`` in float64 on a seeded
``MarchResult`` against JAX op by op at rel 1e-12 (analytic and spectral).
``render_sample_scaled`` against JAX's at the port's staged bars (p99 |d|
< 1e-4, mean < 1e-5, JAX op by op), and its autograd gradient in the two
scales against ``jax.grad`` of JAX's (jitted) at rel 5e-3, the gradient
kernel's bar (tests/test_grad_kernel.py). One test needs a CUDA device
and skips without one.
"""

import dataclasses as dc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geodesic.oracle import oracle_march as j_oracle_march
from blackhole_simulation_tpu.geometry.metrics import KS, Kerr as JKerr
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import Features as JFeatures
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render import StarfieldParams as JStarfieldParams
from blackhole_simulation_tpu.render.camera import camera_rays as j_camera_rays
from blackhole_simulation_tpu.render.march import MarchResult as JMarchResult
from blackhole_simulation_tpu.render.pipeline import (
    render_sample_scaled as j_render_sample_scaled,
)
from blackhole_simulation_tpu.render.pipeline import shade_sample as j_shade_sample
from blackhole_simulation_tpu_torch.geodesic.oracle import oracle_march
from blackhole_simulation_tpu_torch.render.camera import camera_rays
from blackhole_simulation_tpu_torch.render.march import MarchResult
from blackhole_simulation_tpu_torch.render.pipeline import (
    oracle_render,
    render_sample_scaled,
    scene_from_numpy,
    shade_sample,
)

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)
F64 = torch.float64


def _scenes(width, height, spin, features=None, **cfg):
    """The oracle gate's scene (tests/test_oracle_gate.py::_gate_scene) for
    both packages: no star spots (density 0), whose exp(-40 d^2) shading
    turns the last digits of an escape direction into radiance."""
    jcam = JCamera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5,
                          width=width, height=height)
    jcfg = JMarchConfig(**{"max_steps": 256, **cfg})
    js = JScene.create(mass=1.0, spin=spin, camera=jcam,
                       features=features or JFeatures(), march_cfg=jcfg,
                       stars=JStarfieldParams(density=0.0))
    ts = scene_from_numpy(
        mass=1.0, spin=spin,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=width, height=height),
        march_cfg=dc.asdict(jcfg), features=dc.asdict(js.features),
        disk=dc.asdict(js.disk), stars=dc.asdict(js.stars),
        post=dc.asdict(js.post),
    )
    return js, ts


def _j_oracle(scene):
    """JAX's oracle_render (pipeline.py:620-626) with its march jitted and
    its shading run op by op (jitted XLA contracts the float32 lattice
    hash's multiply-adds, which moves the disk's turbulence past the
    bar), returning the march's hit codes too."""
    bh = JKerr(mass=scene.bh.mass.astype(jnp.float64),
               spin=scene.bh.spin.astype(jnp.float64), chart=KS)
    rays = j_camera_rays(scene.camera, bh, dtype=jnp.float64)
    res = jax.jit(lambda y: j_oracle_march(y, bh, scene.march_cfg))(rays)
    with jax.disable_jit():
        img = j_shade_sample(res, bh, scene, jnp.float64, rays)
    return res.hit, img.reshape(scene.camera.height, scene.camera.width, 3)


@pytest.fixture(scope="module")
def oracle_scenes():
    return _scenes(12, 8, 0.999)


def _m_a(ts, device="cpu"):
    f = lambda v: torch.tensor(float(v), dtype=F64, device=device)
    return f(ts.bh.mass), f(ts.bh.spin)


def test_oracle_matches_jax(oracle_scenes):
    js, ts = oracle_scenes
    hit_ref, img_ref = (np.asarray(x) for x in _j_oracle(js))
    m, a = _m_a(ts)
    rays = camera_rays(ts.camera, m, a, dtype=F64)
    hit = oracle_march(rays, m, a, ts.march_cfg).hit.numpy()
    differ = np.flatnonzero(hit != hit_ref)
    img = oracle_render(ts, device="cpu").numpy()
    assert img.dtype == np.float64 and img.shape == (8, 12, 3)
    d = np.abs(img - img_ref).max(axis=2)
    msg = (f"max |d| {d.max():.3e}, p99 {np.percentile(d, 99):.3e}; rays "
           f"with another hit: "
           f"{[(int(i), int(hit[i]), int(hit_ref[i])) for i in differ]}")
    assert (hit == hit_ref).mean() >= 0.99, msg
    assert np.percentile(d, 99) < 1e-6, msg
    assert np.isfinite(img).all()


def test_oracle_exit_test_every_block_is_every_trial(oracle_scenes):
    _, ts = oracle_scenes
    m, a = _m_a(ts)
    rays = camera_rays(ts.camera, m, a, dtype=F64)[::3]
    one = oracle_march(rays, m, a, ts.march_cfg, exit_every=1)
    block = oracle_march(rays, m, a, ts.march_cfg, exit_every=32)
    for f in dc.fields(MarchResult):
        assert torch.equal(getattr(one, f.name), getattr(block, f.name)), f.name


def _seeded_result(n, k=4, seed=0):
    """A seeded theta-form MarchResult: escaped and captured rays, 0-4
    crossings in and out of the disk, photon-ring minima."""
    rng = np.random.default_rng(seed)
    state = np.stack([
        rng.uniform(0, 200, n), rng.uniform(100, 130, n),
        rng.uniform(0.05, math.pi - 0.05, n), rng.uniform(-8, 8, n),
        -np.ones(n), rng.uniform(0.5, 1.5, n), rng.normal(size=n) * 3,
        rng.normal(size=n) * 4], axis=1)
    nc = rng.integers(0, k + 1, n)
    cr = np.where(np.arange(k)[None] < nc[:, None],
                  rng.uniform(0.5, 22.0, (n, k)), 0.0)
    cp = rng.uniform(-20, 20, (n, k)) * (cr > 0)
    ct = rng.uniform(0, 150, (n, k)) * (cr > 0)
    return dict(state=state, hit=rng.integers(1, 3, n).astype(np.int32),
                steps=rng.integers(0, 500, n).astype(np.int32), cross_r=cr,
                cross_phi=cp, cross_t=ct, n_crossings=nc.astype(np.int32),
                jet_radiance=np.zeros((n, 3)),
                r_min_ph=rng.uniform(0.0, 3.0, n))


def _shade_both(js, ts, fields):
    bh = JKerr(mass=jnp.float64(1.0), spin=jnp.float64(0.9), chart=KS)
    y0 = np.asarray(j_camera_rays(js.camera, bh, dtype=jnp.float64))
    with jax.disable_jit():
        want = np.asarray(j_shade_sample(
            JMarchResult(**{k: jnp.asarray(v) for k, v in fields.items()}),
            bh, js, jnp.float64, jnp.asarray(y0), 0.8, 1.3))
    m, a = _m_a(ts)
    got = shade_sample(
        MarchResult(**{k: torch.from_numpy(v) for k, v in fields.items()}),
        m, a, ts, torch.from_numpy(y0.copy()), 0.8, 1.3)
    assert got.dtype == F64
    return got.numpy(), want


def _rel_check(got, want, rel):
    bad = np.abs(got - want) > rel * np.maximum(np.abs(want), 1e-3)
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("spectral", [False, True])
def test_shade_sample_float64_matches_jax(spectral):
    """rel 1e-12 on the oracle gate's scene (disk, nebula, glow); the star
    spots' colours come from the float32 blackbody ramp of float32 lattice
    hashes in both packages, whose float32 pow rounds differently in XLA
    and PyTorch by an ulp: rel 1e-6 for them."""
    js, ts = _scenes(16, 8, 0.9, JFeatures(spectral_lut=spectral))
    fields = _seeded_result(128)
    got, want = _shade_both(js, ts, fields)
    _rel_check(got, want, 1e-12)
    assert want.max() > 0.1  # the disk reached
    stars = lambda sc: dc.replace(sc, stars=dc.replace(sc.stars, density=0.05))
    got, want = _shade_both(stars(js), stars(ts), fields)
    _rel_check(got, want, 1e-6)


SCALED_CFG = dict(max_steps=48, step_rate=0.12, midpoint_iters=2,
                  remat_every=0)


def test_render_sample_scaled_matches_jax():
    js, ts = _scenes(24, 16, 0.9, **SCALED_CFG)
    with jax.disable_jit():
        want = np.asarray(j_render_sample_scaled(
            js, density_scale=jnp.float32(0.6),
            intensity_scale=jnp.float32(1.7)))
    got = render_sample_scaled(ts, density_scale=0.6, intensity_scale=1.7,
                               device="cpu").numpy()
    assert got.shape == (24 * 16, 3)
    d = np.abs(got - want)
    assert np.percentile(d, 99) < 1e-4, np.percentile(d, 99)
    assert d.mean() < 1e-5, d.mean()


def test_render_sample_scaled_gradient_matches_jax():
    js, ts = _scenes(24, 16, 0.9, **SCALED_CFG)
    w = np.random.default_rng(0).uniform(0.5, 1.5, (24 * 16, 3)).astype(
        np.float32)

    def j_loss(ds, its):
        return jnp.sum(j_render_sample_scaled(js, density_scale=ds,
                                              intensity_scale=its) * w)

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.float32(0.6),
                                                    jnp.float32(1.7))
    ds = torch.tensor(0.6, requires_grad=True)
    its = torch.tensor(1.7, requires_grad=True)
    loss = torch.sum(render_sample_scaled(ts, density_scale=ds,
                                          intensity_scale=its, device="cpu")
                     * torch.from_numpy(w))
    got = torch.autograd.grad(loss, (ds, its))
    for g, g_ref in zip(got, want):
        assert float(g) == pytest.approx(float(g_ref), rel=5e-3)
        assert abs(float(g)) > 1e-3


def test_render_sample_scaled_refuses_start_jitter():
    """It refused start_jitter while the offset had no gradient path; it
    takes it now, as JAX's does (tests/test_torch_ad_jitter.py holds
    it to JAX's), and refuses only what JAX's refuses: a derivative of the
    march with use_pallas."""
    _, ts = _scenes(8, 4, 0.9, start_jitter=0.5)
    ds = torch.tensor(0.6, requires_grad=True)
    out = render_sample_scaled(ts, density_scale=ds, device="cpu")
    assert bool(torch.isfinite(out).all())
    assert math.isfinite(float(torch.autograd.grad(out.sum(), ds)[0]))
    a = torch.tensor(0.9, requires_grad=True)
    pallas = dc.replace(ts, bh=dc.replace(ts.bh, spin=a),
                        march_cfg=dc.replace(ts.march_cfg, use_pallas=True))
    with pytest.raises(NotImplementedError):
        render_sample_scaled(pallas, device="cpu")


@pytest.mark.gpu
def test_oracle_on_the_card_matches_the_cpu():
    """The oracle on the card against the same oracle on the CPU (the card
    test of ``chip_smoke.py`` phase 14(a), smaller)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, ts = _scenes(12, 8, 0.999)
    card = oracle_render(ts, device="cuda").cpu().numpy()
    cpu = oracle_render(ts, device="cpu").numpy()
    d = np.abs(card - cpu).max(axis=2)
    assert np.percentile(d, 99) < 1e-6, d.max()
