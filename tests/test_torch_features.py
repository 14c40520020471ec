"""The full-featured render on the CPU: jets, the start offset, the NRS far
field and the shadow overlay, each module against its JAX twin and the
render on both branches against the JAX package's staged render.

The references run op by op (``jax.disable_jit``), as in
test_torch_render.py. Inputs come from numpy seeds; NRS weights are the JAX
package's ``nrs_init(0)``, carried over by ``nrs_params_from_numpy``. Bars:
row functions rel < 1e-5; the shadow curve in float64 < 1e-12; the overlay
< 1e-6; renders tests/test_fused.py's p99 |d| < 1e-4 (and < 1e-3 between a
fused and a staged refined render).

The JAX package's two render branches differ in four ways, and the port
reproduces each (one test apiece): the fused kernel runs the NRS skip with
jets on; its NRS background is born from the start-offset u and phi but
the camera's r; the overlay is in the fused ``render_radiance`` only; and
refined pixels lose the fused overlay.
"""

import dataclasses as dc
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geometry.metrics import KS, Kerr
from blackhole_simulation_tpu.models import nrs as jnrs
from blackhole_simulation_tpu.physics import shadow as jshadow
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render import render as j_render
from blackhole_simulation_tpu.render import (
    render_radiance as j_render_radiance,
)
from blackhole_simulation_tpu.render import camera as jcamera
from blackhole_simulation_tpu.render import overlay as joverlay
from blackhole_simulation_tpu.render import shading as jshading
from blackhole_simulation_tpu.render.pipeline import Features as JFeatures
from blackhole_simulation_tpu_torch.models import nrs as tnrs
from blackhole_simulation_tpu_torch.ops.march import start_offset_rows
from blackhole_simulation_tpu_torch.ops.render import render_planes
from blackhole_simulation_tpu_torch.physics import shadow as tshadow
from blackhole_simulation_tpu_torch.render.camera import (
    Camera,
    camera_rays,
    camera_rays_u,
)
from blackhole_simulation_tpu_torch.render.march import (
    MarchConfig,
    _march_inputs,
    march_rows,
)
from blackhole_simulation_tpu_torch.render.overlay import shadow_overlay
from blackhole_simulation_tpu_torch.render.pipeline import (
    kernel_inputs,
    render,
    render_radiance,
    scene_from_numpy,
    select_band,
)
from blackhole_simulation_tpu_torch.render.shading import (
    JetParams,
    jet_emission_step,
)

jpm = importlib.import_module("blackhole_simulation_tpu.ops.pallas_march")
jks = importlib.import_module("blackhole_simulation_tpu.ops.ks_kernel")
jmarch = importlib.import_module("blackhole_simulation_tpu.render.march")

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)
W, H = 48, 24
# test_fused.py's short-horizon config; remat_every=0 runs the JAX march as
# one loop (its forward values do not depend on it).
BASE = dict(max_steps=48, shadow_precull=True, far_step_cap_rate=0.4,
            far_boost_radius=20.0, midpoint_iters=1, remat_every=0)
B_MIN = 18.0 * 1.2   # the default disk's far-field threshold
P99 = 1e-4


def _jbh(spin=0.9):
    return Kerr(mass=jnp.float32(1.0), spin=jnp.float32(spin), chart=KS)


@functools.cache
def _j_nrs():
    return jnrs.nrs_init(0)


def _np_nrs():
    return [(np.asarray(w), np.asarray(b)) for w, b in _j_nrs()]


def _jscene(feats, fov, spin=0.9, **cfg):
    cam = JCamera.create(r=30.0, theta=THETA, fov=fov, width=W, height=H)
    js = JScene.create(mass=1.0, spin=spin, camera=cam,
                       march_cfg=JMarchConfig(**{**BASE, **cfg}),
                       features=JFeatures(**feats))
    if feats.get("nrs_far_field"):
        js = dc.replace(js, nrs_params=_j_nrs())
    return js


def _tscene(feats, fov, fused, spin=0.9, **cfg):
    return scene_from_numpy(
        mass=1.0, spin=spin,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=fov, roll=0.0,
                    width=W, height=H),
        march_cfg={**BASE, "use_pallas": fused, "fused": fused, **cfg},
        features=feats,
        nrs_params=_np_nrs() if feats.get("nrs_far_field") else None,
        device="cpu",
    )


# name: (features, MarchConfig overrides, fov, through render())
CASES = {
    "jets": (dict(jets=True), {}, 0.5, False),
    "start_jitter": ({}, dict(start_jitter=0.5), 0.5, False),
    "nrs": (dict(nrs_far_field=True), {}, 1.0, False),
    "overlay": (dict(shadow_overlay=True), {}, 0.5, True),
    # All four at once. At fov 0.5 no ray of this frame is beyond b_min, so
    # the NRS skip (which the fused kernel runs with jets, and the staged
    # path does not) changes no pixel; test_fused_nrs_skip_runs_with_jets
    # holds the fused kernel's far rays.
    "all": (dict(jets=True, shadow_overlay=True, nrs_far_field=True),
            dict(start_jitter=0.5), 0.5, True),
}


def _case(name, fov=None):
    feats, cfg, fov0, tonemapped = CASES[name]
    return feats, cfg, fov0 if fov is None else fov, tonemapped


@functools.cache
def _jax_ref(name, fov=None):
    feats, cfg, fov, tonemapped = _case(name, fov)
    js = _jscene(feats, fov, **cfg)
    with jax.disable_jit():
        if tonemapped:
            return np.asarray(j_render(js, n_samples=1, dtype=jnp.float32))
        return np.asarray(j_render_radiance(js, dtype=jnp.float32))


@functools.cache
def _port(name, fused, fov=None):
    feats, cfg, fov, tonemapped = _case(name, fov)
    ts = _tscene(feats, fov, fused, **cfg)
    fn = render if tonemapped else render_radiance
    return fn(ts, device="cpu").numpy()


def _check(out, ref):
    assert out.shape == ref.shape == (H, W, 3)
    assert np.isfinite(out).all()
    d = np.abs(out - ref)
    assert np.percentile(d, 99) < P99, np.percentile(d, 99)


# ---------------------------------------------------------------------------
# Row functions
# ---------------------------------------------------------------------------

def test_jet_emission_step_matches_jax():
    rng = np.random.default_rng(11)
    n = 4096
    u = np.concatenate([rng.uniform(-1.0, 1.0, n // 2),
                        np.sign(rng.normal(size=n // 2))
                        * rng.uniform(0.9, 1.0, n // 2)])
    rows = dict(
        r=rng.uniform(1.5, 30.0, n), st=np.sqrt(np.maximum(1 - u * u, 1e-6)),
        ct=u, ph=rng.uniform(-20.0, 20.0, n), dr=rng.normal(size=n),
        dth=rng.normal(size=n) * 0.1, dph=rng.normal(size=n) * 0.1,
        dlam=rng.uniform(0.01, 2.0, n))
    f32 = {k: v.astype(np.float32) for k, v in rows.items()}
    jets = JetParams()
    out = jet_emission_step(jets, *(torch.from_numpy(v) for v in f32.values()))
    with jax.disable_jit():
        ref = jshading.jet_emission_step(
            jshading.JetParams(), *(jnp.asarray(v) for v in f32.values()),
            jnp.float32)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert (r > 0).mean() > 0.05   # the cones are sampled
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-12)


def _camera_rows(spin, width=W, height=H, fov=0.5, **cfg):
    cam = Camera.create(r=30.0, theta=THETA, fov=fov, width=width,
                        height=height)
    m, a = torch.tensor(1.0), torch.tensor(np.float32(spin))
    mc = MarchConfig(**{**BASE, **cfg})
    with torch.no_grad():
        return _march_inputs(camera_rays_u(cam, m, a), m, a, mc, None), mc


def test_start_offset_rows_matches_jax():
    (yt0, _, m, a, r_h, r_ph), cfg = _camera_rows(0.9, start_jitter=0.5)
    rows = tuple(yt0[i] for i in (0, 1, 2, 3, 5, 6, 7))
    out = start_offset_rows(m, a, r_h, r_ph, cfg, rows)
    j = lambda x: jnp.asarray(x.numpy())
    with jax.disable_jit():
        ref = jpm.start_offset_rows(
            j(m), j(a), j(r_h), j(r_ph),
            JMarchConfig(**{**BASE, "start_jitter": 0.5}), False,
            tuple(j(x) for x in rows))
    for k, (o, r) in enumerate(zip(out, ref)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6, err_msg=str(k))
    assert float((out[0] - rows[0]).abs().max()) > 0.1   # rays moved


@pytest.mark.parametrize("a, theta", [(0.0, THETA), (0.6, THETA),
                                      (0.999, THETA), (0.9, 0.02)],
                         ids=["a0", "a0.6", "a0.999", "on-axis"])
def test_bardeen_shadow_matches_jax(a, theta):
    out = tshadow.bardeen_shadow(1.0, a, theta, n=32)
    with jax.disable_jit():
        ref = [np.asarray(x) for x in jshadow.bardeen_shadow(
            jnp.float64(1.0), jnp.float64(a), theta_obs=theta, n=32)]
    assert out[0].dtype == np.float64 and out[0].shape == (64,)
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(out[2], ref[2])
    if a == 0.0 or theta < 0.05:   # the two circles: every point valid
        assert out[2].all()


def test_shadow_critical_params_and_lensing_match_jax():
    rng = np.random.default_rng(5)
    r = rng.uniform(1.2, 4.0, 64)
    u = rng.uniform(0.05, 3.0, 64)
    d = rng.uniform(1.0, 10.0, 64)
    with jax.disable_jit():
        ref = [jshadow.shadow_critical_params(1.0, 0.7, jnp.asarray(r)),
               jshadow.magnification(jnp.asarray(u), jnp.asarray(d)),
               jshadow.magnification_point_lens(jnp.asarray(u)),
               jshadow.einstein_angle(1.0, jnp.asarray(d),
                                      2.0 * jnp.asarray(d)),
               jshadow.schwarzschild_shadow_radius(2.0)]
    out = [tshadow.shadow_critical_params(1.0, 0.7, r),
           tshadow.magnification(u, d), tshadow.magnification_point_lens(u),
           tshadow.einstein_angle(1.0, d, 2.0 * d),
           tshadow.schwarzschild_shadow_radius(2.0)]
    for o, rf in zip(out, ref):
        np.testing.assert_allclose(np.asarray(o), np.asarray(rf), rtol=1e-12)


def test_camera_rays_match_jax():
    cam = Camera.create(r=30.0, theta=THETA, fov=0.5, width=W, height=H)
    jcam = JCamera.create(r=30.0, theta=THETA, fov=0.5, width=W, height=H)
    out = camera_rays(cam, torch.tensor(1.0), torch.tensor(np.float32(0.9)))
    with jax.disable_jit():
        ref = np.asarray(jcamera.camera_rays(jcam, _jbh(), dtype=jnp.float32))
    assert out.shape == ref.shape == (W * H, 8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_shadow_overlay_matches_jax():
    jcam = JCamera.create(r=30.0, theta=THETA, fov=0.5, width=W, height=H)
    with jax.disable_jit():
        y0 = np.asarray(jcamera.camera_rays(jcam, _jbh(), dtype=jnp.float32))
        rad = np.random.default_rng(2).uniform(0, 1, (W * H, 3)).astype(
            np.float32)
        ref = np.asarray(joverlay.shadow_overlay(
            jnp.asarray(rad), jnp.asarray(y0), _jbh(), jcam.theta,
            jnp.float32, line_width=jnp.float32(0.3)))
    out = shadow_overlay(torch.from_numpy(rad), torch.tensor(y0),
                         torch.tensor(1.0), torch.tensor(np.float32(0.9)),
                         THETA, line_width=torch.tensor(0.3))
    d = np.abs(out.numpy() - ref)
    assert d.max() < 1e-6, d.max()
    assert (ref - rad).max() > 0.1   # the line is in the frame


def test_nrs_apply_matches_jax():
    x = np.random.default_rng(4).uniform(-1, 1, (512, 3)).astype(np.float32)
    params = tnrs.nrs_params_from_numpy(_np_nrs(), "cpu")
    out = tnrs.nrs_apply(params, torch.from_numpy(x)).numpy()
    with jax.disable_jit():
        ref = np.asarray(jnrs.nrs_apply(_j_nrs(), jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_nrs_far_field_rows_matches_jax():
    cam = Camera.create(r=30.0, theta=THETA, fov=1.0, width=W, height=H)
    jcam = JCamera.create(r=30.0, theta=THETA, fov=1.0, width=W, height=H)
    m, a = torch.tensor(1.0), torch.tensor(np.float32(0.9))
    far, dirs = tnrs.nrs_far_field_rows(
        tnrs.nrs_params_from_numpy(_np_nrs(), "cpu"), camera_rays_u(cam, m, a), m, a,
        b_min=B_MIN)
    with jax.disable_jit():
        rays = jcamera.camera_rays_u(jcam, _jbh(), dtype=jnp.float32)
        jfar, jdirs = jnrs.nrs_far_field_rows(_j_nrs(), rays, _jbh(),
                                              b_min=B_MIN)
    np.testing.assert_array_equal(far.numpy(), np.asarray(jfar))
    assert 0 < int(far.sum()) < far.numel()
    for o, r in zip(dirs, jdirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)


def test_nrs_weights_round_trip():
    flat = jnrs.nrs_flat_weights(_j_nrs())
    params = tnrs.nrs_params_from_numpy(_np_nrs(), "cpu")
    assert flat.shape == (659,)
    np.testing.assert_array_equal(tnrs.nrs_flat_weights(params), flat)
    back = tnrs.nrs_from_flat(flat)
    for (w, b), (w2, b2) in zip(params, back):
        assert torch.equal(w, w2) and torch.equal(b, b2)
    # The port's own init: seeded, the JAX shapes, zero biases.
    p0, p1 = tnrs.nrs_init(0, "cpu"), tnrs.nrs_init(0, "cpu")
    assert [tuple(w.shape) for w, _ in p0] == [(3, 16), (16, 16), (16, 16),
                                               (16, 3)]
    assert all(torch.equal(w, w2) for (w, _), (w2, _) in zip(p0, p1))
    assert not torch.equal(p0[0][0], tnrs.nrs_init(1, "cpu")[0][0])
    assert all(float(b.abs().max()) == 0.0 for _, b in p0)


def test_march_with_jets_matches_jax():
    cfg = MarchConfig(**{**BASE, "shadow_precull": False})
    rays_cam = camera_rays_u(Camera.create(r=30.0, theta=THETA, fov=0.5,
                                           width=W, height=H),
                             torch.tensor(1.0), torch.tensor(np.float32(0.9)))
    out = march_rows(rays_cam, torch.tensor(1.0),
                     torch.tensor(np.float32(0.9)), cfg, jets=JetParams())
    with jax.disable_jit():
        ref = jmarch.march_rows(jnp.asarray(rays_cam.numpy()), _jbh(),
                                JMarchConfig(**{**BASE, "shadow_precull": False}),
                                jets=jshading.JetParams())
    for f in ("hit", "steps", "n_crossings"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(out.state_u.numpy(), np.asarray(ref.state_u),
                               atol=1e-4)
    jet = np.asarray(ref.jet_radiance)
    assert jet.max() > 1e-3
    np.testing.assert_allclose(out.jet_radiance.numpy(), jet, rtol=1e-5,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# The render, both branches, against the JAX package's staged render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_render_matches_jax_staged(name):
    _check(_port(name, True), _jax_ref(name))


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_render_matches_jax_staged(name):
    _check(_port(name, False), _jax_ref(name))


def test_overlay_line_draws():
    """render() draws the line on both branches (> 0.1 in the tone-mapped
    image)."""
    for fused in (True, False):
        base = render(_tscene({}, 0.5, fused), device="cpu").numpy()
        line = _port("overlay", fused)
        assert np.abs(line - base).max() > 0.1


# The budget covers the frame, so the JAX refinement march runs at the
# frame's ray count and reuses the op-by-op reference's compiled shapes.
REFINED = dict(refine_band=0.5, refine_budget=W * H, refine_step_rate=0.08,
               refine_max_steps=64)


def test_refined_render_with_jets_matches_jax():
    feats = dict(jets=True)
    js = _jscene(feats, 0.5, spin=0.97, **REFINED)
    with jax.disable_jit():
        ref = np.asarray(j_render_radiance(js, dtype=jnp.float32))
    staged = render_radiance(_tscene(feats, 0.5, False, 0.97, **REFINED),
                             device="cpu").numpy()
    fused = render_radiance(_tscene(feats, 0.5, True, 0.97, **REFINED),
                            device="cpu").numpy()
    _check(staged, ref)
    assert np.percentile(np.abs(fused - staged), 99) < 1e-3
    coarse = render_radiance(_tscene(feats, 0.5, False, 0.97), device="cpu")
    assert np.abs(staged - coarse.numpy()).max() > 1e-3   # the pass ran


# ---------------------------------------------------------------------------
# The reference's fused/staged differences, reproduced
# ---------------------------------------------------------------------------

def _j_nrs_background(u, ph, pr, pu, pph, b, theta_in):
    """The fused kernel's NRS background (pallas_render.py:338-395) from
    JAX functions: birth rows at the camera's r, the MLP at
    (b / 40, theta_in / pi, a), the Rodrigues rotation, the starfield."""
    bh = _jbh()
    n = u.shape[0]
    r0 = jnp.float32(30.0)
    birth = (jnp.zeros(n, jnp.float32), jnp.full(n, r0), u, ph,
             jnp.full(n, -1.0, jnp.float32), pr, pu, pph)
    vx, vy, vz = jshading.escape_direction_u_rows(birth, bh)
    s0 = jnp.float32(np.sqrt(max(1.0 - np.cos(THETA) ** 2, 1e-12)))
    u0 = jnp.float32(np.cos(THETA))
    px, py, pz = r0 * s0 * jnp.cos(ph), r0 * s0 * jnp.sin(ph), r0 * u0 + 0 * u
    x = jnp.stack([b * jnp.float32(1.0 / 40.0),
                   jnp.full(n, jnp.float32(theta_in / np.pi)),
                   jnp.full(n, bh.spin)], axis=-1)
    alpha = jnrs.nrs_apply(_j_nrs(), x)[:, 0]
    nx, ny, nz = py * vz - pz * vy, pz * vx - px * vz, px * vy - py * vx
    inv = 1.0 / jnp.sqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-20))
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    ca, sa = jnp.cos(alpha), jnp.sin(alpha)
    cx, cy, cz = ny * vz - nz * vy, nz * vx - nx * vz, nx * vy - ny * vx
    return np.stack([np.asarray(c) for c in jshading.starfield_rows(
        vx * ca + cx * sa, vy * ca + cy * sa, vz * ca + cz * sa)], axis=-1)


def _j_birth(start_jitter):
    """The fused kernel's birth rows: camera rays, null projection and,
    with ``start_jitter``, the start offset (JAX functions)."""
    bh = _jbh()
    jcam = JCamera.create(r=30.0, theta=THETA, fov=1.0, width=W, height=H)
    rays = jcamera.camera_rays_u(jcam, bh, dtype=jnp.float32)
    rays = jks.ks_renormalize_u(bh.mass, bh.spin, rays)
    rows = (rays[0], rays[1], rays[2], rays[3], rays[5], rays[6], rays[7])
    if start_jitter:
        rows = jpm.start_offset_rows(
            bh.mass, bh.spin, bh.event_horizon(), bh.photon_sphere(),
            JMarchConfig(**{**BASE, "start_jitter": start_jitter}), False,
            rows)
    t, r, u, ph, pr, pu, pph = rows
    w0 = 1.0 - u * u
    eta = pu * pu * w0 + u * u * (pph * pph / jnp.maximum(w0, 1e-12)
                                  - bh.spin * bh.spin)
    b = jnp.sqrt(jnp.maximum(eta + pph * pph, 1e-12))
    return u, ph, pr, pu, pph, b


def test_fused_nrs_skip_runs_with_jets():
    """pallas_render.py:595 runs the skip with jets on; pipeline.py:467-471
    does not. The port's fused far rays carry the NRS background, its
    other rays (and every staged ray) the JAX staged jets render."""
    feats = dict(jets=True, nrs_far_field=True)
    fused = render_radiance(_tscene(feats, 1.0, True), device="cpu").numpy()
    staged = render_radiance(_tscene(feats, 1.0, False), device="cpu").numpy()
    js = _jscene(feats, 1.0)
    with jax.disable_jit():
        ref = np.asarray(j_render_radiance(js, dtype=jnp.float32))
        u, ph, pr, pu, pph, b = _j_birth(0.0)
        far = np.asarray(b > B_MIN).reshape(H, W)
        bg = _j_nrs_background(u, ph, pr, pu, pph, b, THETA).reshape(H, W, 3)
    assert 0 < far.sum() < far.size
    _check(staged, ref)
    assert np.percentile(np.abs(fused - ref)[~far], 99) < P99
    assert np.percentile(np.abs(fused - bg)[far], 99) < P99
    assert np.abs(fused - staged)[far].max() > 1e-2


def test_fused_nrs_background_reads_offset_rows():
    """With start_jitter the fused NRS background is born from the offset
    u and phi with the camera's r (pallas_render.py:346-347); the staged
    one from the camera rays."""
    feats, cfg = dict(nrs_far_field=True), dict(start_jitter=0.5)
    fused = render_radiance(_tscene(feats, 1.0, True, **cfg),
                            device="cpu").numpy()
    with jax.disable_jit():
        ref = np.asarray(j_render_radiance(_jscene(feats, 1.0, **cfg),
                                           dtype=jnp.float32))
        u, ph, pr, pu, pph, b = _j_birth(0.5)
        far = np.asarray(b > B_MIN).reshape(H, W)
        bg = _j_nrs_background(u, ph, pr, pu, pph, b, THETA).reshape(H, W, 3)
    assert 0 < far.sum() < far.size
    assert np.percentile(np.abs(fused - ref)[~far], 99) < P99
    assert np.percentile(np.abs(fused - bg)[far], 99) < P99
    assert np.abs(fused - ref)[far].max() > 1e-2


def test_overlay_only_in_fused_radiance():
    """The fused kernel draws the line into render_radiance; the staged
    render_radiance has none (JAX draws it in render() only)."""
    feats = dict(shadow_overlay=True)
    with_line = render_radiance(_tscene(feats, 0.5, True), device="cpu")
    without = render_radiance(_tscene({}, 0.5, True), device="cpu")
    jcam = JCamera.create(r=30.0, theta=THETA, fov=0.5, width=W, height=H)
    with jax.disable_jit():
        y0 = jcamera.camera_rays(jcam, _jbh(), dtype=jnp.float32)
        width = jnp.maximum(0.06 * jnp.float32(1.0),
                            1.5 * jnp.float32(0.5 / H * 30.0))
        line = np.asarray(joverlay.shadow_overlay(
            jnp.zeros((W * H, 3), jnp.float32), y0, _jbh(), jcam.theta,
            jnp.float32, line_width=width)).reshape(H, W, 3)
    d = (with_line - without).numpy()
    assert line.max() > 0.1
    assert np.abs(d - line).max() < 1e-5
    staged = render_radiance(_tscene(feats, 0.5, False), device="cpu")
    assert torch.equal(
        staged, render_radiance(_tscene({}, 0.5, False), device="cpu"))


def test_refined_pixels_lose_fused_overlay():
    """Reference fault 2: the refinement pass overwrites its pixels with
    the staged composite, which has no overlay (pipeline.py:403)."""
    feats = dict(shadow_overlay=True)
    both = _tscene(feats, 0.5, True, 0.97, **REFINED)
    a = render_radiance(both, device="cpu").numpy().reshape(-1, 3)
    b = render_radiance(_tscene({}, 0.5, True, 0.97, **REFINED),
                        device="cpu").numpy().reshape(-1, 3)
    line = (render_radiance(_tscene(feats, 0.5, True, 0.97), device="cpu")
            - render_radiance(_tscene({}, 0.5, True, 0.97), device="cpu")
            ).numpy().reshape(-1, 3)
    row, st = kernel_inputs(both, None, "cpu")
    band = render_planes(row, st)[3].reshape(-1)
    sel = select_band(band, H, W, REFINED["refine_budget"],
                      REFINED["refine_band"]).numpy()
    sel = sel[sel < H * W]
    rest = np.setdiff1d(np.arange(H * W), sel)
    assert len(sel) > 0
    assert np.array_equal(a[sel], b[sel])              # no line there
    assert line[sel].max() > 1e-3                      # where it would be
    np.testing.assert_allclose(a[rest] - b[rest], line[rest], atol=1e-6)


def test_nrs_radius_threshold():
    """b_min is 1.2 disk radii, at least 12 (pipeline.py:480-483)."""
    from blackhole_simulation_tpu_torch.ops.render import nrs_b_min

    ts = _tscene(dict(nrs_far_field=True), 1.0, True)
    assert nrs_b_min(ts) == pytest.approx(B_MIN)
    assert nrs_b_min(dc.replace(ts, features=dc.replace(
        ts.features, disk=False))) == 12.0
    assert math.isclose(nrs_b_min(dc.replace(ts, disk=dc.replace(
        ts.disk, outer_radius=5.0))), 12.0)
