"""The port's staged march path against the JAX package's, on the CPU.

Camera rays, the capture mask, the pixel-block order, the row-native march
and the staged render, each from the same inputs on both sides. Forward
values are held against JAX run op by op (``jax.disable_jit``), whose
operations each round once as the port's plain versions do; the JAX march
reference is its jnp path (``use_pallas=False``). Bars: rays rtol 1e-6;
mask and block-order ids identical; the march at 48 steps with identical
hit, steps and crossing counts and atol 1e-4 on states and records
(tests/test_pallas.py:81-98); the staged image at tests/test_fused.py's
bars (analytic p99 < 1e-4, mean < 1e-5; spectral p99 < 2e-2, mean < 1e-3).
"""

import dataclasses as dc
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geometry.metrics import KS, Kerr
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render import render_radiance as j_render_radiance
from blackhole_simulation_tpu.render.camera import camera_rays_u as j_rays
from blackhole_simulation_tpu.render.pipeline import Features as JFeatures
from blackhole_simulation_tpu.render.precull import capture_mask_u as j_mask
from blackhole_simulation_tpu_torch.geometry.metrics import (
    Kerr as TKerr,
    event_horizon_t,
    isco_t,
    photon_sphere_t,
)
from blackhole_simulation_tpu_torch.ops import pallas_march as tpm
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays_u
from blackhole_simulation_tpu_torch.render.march import MarchConfig, march_rows
from blackhole_simulation_tpu_torch.render.pipeline import (
    render_radiance,
    scene_from_numpy,
)
from blackhole_simulation_tpu_torch.render.precull import capture_mask_u

jpm = importlib.import_module("blackhole_simulation_tpu.ops.pallas_march")
jmarch = importlib.import_module("blackhole_simulation_tpu.render.march")

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)


def _cams(width, height, theta=THETA):
    return (JCamera.create(r=30.0, theta=theta, fov=0.5, width=width,
                           height=height),
            Camera.create(r=30.0, theta=theta, fov=0.5, width=width,
                          height=height))


def _bh(spin):
    return (Kerr(mass=jnp.float32(1.0), spin=jnp.float32(spin), chart=KS),
            torch.tensor(1.0), torch.tensor(np.float32(spin)))


@pytest.mark.parametrize("spin", [0.3, 0.9, 0.999])
def test_radii_match_jax(spin):
    jbh, m, a = _bh(spin)
    for t_fn, j_fn in ((event_horizon_t, jbh.event_horizon),
                       (photon_sphere_t, jbh.photon_sphere),
                       (isco_t, jbh.isco)):
        with jax.disable_jit():
            ref = np.float32(j_fn())
        assert np.float32(t_fn(m, a).item()) == ref
    host = TKerr(mass=1.0, spin=float(np.float32(spin)))
    assert float(isco_t(m, a.double())) == pytest.approx(host.isco(), rel=1e-12)


RAY_CASES = {
    "grid": dict(pix=False, jitter=None),
    "grid-jitter": dict(pix=False, jitter=(0.25, -0.125)),
    "pix-ids-jitter": dict(pix=True, jitter=(0.25, -0.125)),
    "pix-ids-polar": dict(pix=True, jitter=None, theta=0.05),
}


@pytest.mark.parametrize("case", sorted(RAY_CASES))
def test_camera_rays_u_matches_jax(case):
    spec = RAY_CASES[case]
    jcam, tcam = _cams(50, 21, spec.get("theta", THETA))
    jbh, m, a = _bh(0.9)
    ids = None
    if spec["pix"]:
        ids = np.random.default_rng(0).integers(0, 50 * 21, 300)
    jitter = spec["jitter"]
    with jax.disable_jit():
        ref = np.asarray(j_rays(
            jcam, jbh, pix_ids=None if ids is None else jnp.asarray(ids),
            jitter=None if jitter is None else jnp.asarray(jitter, jnp.float32),
            dtype=jnp.float32))
    out = camera_rays_u(tcam, m, a,
                        pix_ids=None if ids is None else torch.from_numpy(ids),
                        jitter=jitter)
    assert out.shape == ref.shape and out.dtype == torch.float32
    for row in range(8):
        scale = float(np.abs(ref[row]).max())
        np.testing.assert_allclose(out.numpy()[row], ref[row], rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=str(row))


@pytest.mark.parametrize("spin", [0.5, 0.999, -0.7])
def test_capture_mask_u_equal(spin):
    jcam, tcam = _cams(96, 54)
    jbh, m, a = _bh(spin)
    rays = camera_rays_u(tcam, m, a)
    with jax.disable_jit():
        ref = np.asarray(j_mask(jnp.float32(1.0), jnp.float32(spin),
                                jnp.asarray(rays.numpy())))
    out = capture_mask_u(m, a, rays).numpy()
    assert ref.any() and not ref.all()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("hw", [(1080, 1920), (54, 96), (21, 50)])
def test_block_order_ids_match_jax(hw):
    h, w = hw
    ids = np.arange(h * w, dtype=np.int32)
    ref = np.asarray(jpm.to_block_order(jnp.asarray(ids), h, w))
    out = tpm.to_block_order(torch.from_numpy(ids), h, w).numpy()
    np.testing.assert_array_equal(out, ref)
    assert tpm._padded_dims(h, w) == jpm._padded_dims(h, w)
    back = tpm.from_block_order(torch.from_numpy(out), h, w).numpy()
    np.testing.assert_array_equal(back, ids)
    rgb = np.random.default_rng(1).normal(size=(out.shape[0], 3))
    np.testing.assert_array_equal(
        tpm.from_block_order(torch.from_numpy(rgb), h, w).numpy(),
        np.asarray(jpm.from_block_order(jnp.asarray(rgb), h, w)))


MARCH_CASES = {
    f"a{spin}-{'precull' if pc else 'plain'}": (spin, pc)
    for spin in (0.9, 0.999) for pc in (False, True)
}


@pytest.mark.parametrize("case", sorted(MARCH_CASES))
def test_march_rows_matches_jax(case):
    spin, precull = MARCH_CASES[case]
    jcam, tcam = _cams(48, 32)
    jbh, m, a = _bh(spin)
    kw = dict(max_steps=48, shadow_precull=precull, remat_every=0)
    rays = camera_rays_u(tcam, m, a)
    with jax.disable_jit():
        ref = jmarch.march_rows(jnp.asarray(rays.numpy()), jbh,
                                JMarchConfig(**kw))
    out = march_rows(rays, m, a, MarchConfig(**kw))
    for name in ("hit", "steps", "n_crossings"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("state_u", "cross_r", "cross_phi", "cross_t", "r_min_ph"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-4,
                                   err_msg=name)
    assert (out.n_crossings.numpy() > 0).any()


def _staged_scenes(spectral, use_pallas):
    cfg = JMarchConfig(max_steps=48, shadow_precull=True,
                       far_step_cap_rate=0.4, far_boost_radius=20.0,
                       midpoint_iters=1, remat_every=0)
    jcam, _ = _cams(96, 54)
    feats = JFeatures(spectral_lut=spectral)
    js = JScene.create(mass=1.0, spin=0.9, camera=jcam, march_cfg=cfg,
                       features=feats)
    ts = scene_from_numpy(
        mass=1.0, spin=0.9,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=96, height=54),
        march_cfg=dc.asdict(dc.replace(cfg, use_pallas=use_pallas)),
        features=dc.asdict(feats), disk=dc.asdict(js.disk),
        stars=dc.asdict(js.stars), post=dc.asdict(js.post),
        spectral_coeffs=js.spectral_coeffs,
    )
    return js, ts


@pytest.fixture(scope="module")
def jax_staged():
    out = {}
    for spectral in (False, True):
        js, _ = _staged_scenes(spectral, False)
        with jax.disable_jit():
            out[spectral] = np.asarray(j_render_radiance(js, dtype=jnp.float32))
    return out


@pytest.mark.parametrize("order", ["block", "row-major"])
@pytest.mark.parametrize("disk", ["analytic", "spectral"])
def test_staged_render_matches_jax(jax_staged, disk, order):
    spectral = disk == "spectral"
    _, ts = _staged_scenes(spectral, order == "block")
    assert not ts.march_cfg.fused
    out = render_radiance(ts, device="cpu").numpy()
    ref = jax_staged[spectral]
    assert out.shape == ref.shape == (54, 96, 3) and np.isfinite(out).all()
    d = np.abs(out - ref)
    p99, mean = (2e-2, 1e-3) if spectral else (1e-4, 1e-5)
    assert np.percentile(d, 99) < p99, np.percentile(d, 99)
    assert d.mean() < mean, d.mean()
