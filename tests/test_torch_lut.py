"""The staged spectral render on the LUT route, against the JAX package's,
on the CPU.

A staged spectral scene built without Chebyshev tables shades its disk from
the float64-built LUTs in both packages (JAX ``render/shading.py:726-748``,
``disk_emission_lut_rows`` :472-560; the port's ``shade_crossings_rows``
and ``disk_emission_lut_rows``). The JAX references run op by op
(``jax.disable_jit``). Bars: the slot shading atol 1e-6; the staged render
at the analytic disk's bars (p99 |d| < 1e-4, mean < 1e-5), on
tests/test_torch_march.py's 96x54 scene.
"""

import dataclasses as dc

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
from blackhole_simulation_tpu.render.pipeline import Features as JFeatures
from blackhole_simulation_tpu.render.shading import (
    DiskParams as JDiskParams,
    build_disk_luts as j_build_disk_luts,
    disk_emission_lut_rows as j_lut_rows,
    spectral_kernel_tables,
)
from blackhole_simulation_tpu_torch.geometry.metrics import isco_t
from blackhole_simulation_tpu_torch.render import pipeline, shading
from blackhole_simulation_tpu_torch.render.march import MarchConfig
from blackhole_simulation_tpu_torch.render.pipeline import (
    Features,
    Scene,
    render_radiance,
    scene_from_numpy,
)
from blackhole_simulation_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)
# tests/test_torch_march.py's staged configuration.
CFG = dict(max_steps=48, shadow_precull=True, far_step_cap_rate=0.4,
           far_boost_radius=20.0, midpoint_iters=1, remat_every=0)


def _crossings(n, seed, r_in, r_out):
    """Seeded crossing records: radii from inside the ISCO to past the
    disk's edge, phases, times and impact parameters."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: x.astype(np.float32)
    return (f32(rng.uniform(0.9 * r_in, 1.05 * r_out, n)),
            f32(rng.uniform(-12.0, 12.0, n)),
            f32(rng.uniform(0.0, 300.0, n)),
            f32(rng.uniform(-5.0, 5.0, n)))


@pytest.mark.parametrize("octaves", [3, 1], ids=["slot0", "higher_slot"])
@pytest.mark.parametrize("spin", [0.3, 0.9])
def test_lut_rows_match_jax(spin, octaves):
    disk = JDiskParams()
    jbh = Kerr(mass=jnp.float64(1.0), spin=jnp.float64(spin), chart=KS)
    m = torch.tensor(1.0)
    a = torch.tensor(np.float32(spin))
    r_in = isco_t(m, a)
    rows = _crossings(4096, int(spin * 10) + octaves, float(r_in),
                      disk.outer_radius)
    with jax.disable_jit():
        jluts = j_build_disk_luts(jbh, disk, jnp.float32)
        ref_rgb, ref_alpha, ref_valid = j_lut_rows(
            disk, jbh, jluts, *(jnp.asarray(x) for x in rows),
            dtype=jnp.float32, octaves=octaves)
    luts = tuple(torch.as_tensor(x) for x in shading.disk_luts(1.0, spin,
                                                                disk))
    for got, want in zip(luts, jluts):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rgb, alpha, valid = shading.disk_emission_lut_rows(
        disk, m, a, r_in, luts, *(torch.as_tensor(x) for x in rows),
        octaves=octaves)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref_alpha),
                               rtol=0, atol=1e-6)
    for c in range(3):
        assert np.isfinite(rgb[c].numpy()).all()
        np.testing.assert_allclose(rgb[c].numpy(), np.asarray(ref_rgb[c]),
                                   rtol=0, atol=1e-6)


def test_lut_rows_differentiable():
    disk = JDiskParams()
    m, a = torch.tensor(1.0), torch.tensor(np.float32(0.9))
    r_in = isco_t(m, a)
    rows = [torch.as_tensor(x) for x in _crossings(256, 7, float(r_in),
                                                   disk.outer_radius)]
    rows[0].requires_grad_()
    luts = tuple(torch.as_tensor(x) for x in shading.disk_luts(1.0, 0.9, disk))
    rgb, alpha, _ = shading.disk_emission_lut_rows(disk, m, a, r_in, luts,
                                                   *rows)
    (g,) = torch.autograd.grad(sum(c.sum() for c in rgb) + alpha.sum(),
                               rows[0])
    assert torch.isfinite(g).all() and (g != 0).any()


def _staged_scenes(cfg_over=None):
    cfg = JMarchConfig(**CFG)
    jcam = JCamera.create(r=30.0, theta=THETA, fov=0.5, width=96, height=54)
    feats = JFeatures(spectral_lut=True)
    js = JScene.create(mass=1.0, spin=0.9, camera=jcam, march_cfg=cfg,
                       features=feats)
    ts = scene_from_numpy(
        mass=1.0, spin=0.9,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=96, height=54),
        march_cfg=dc.asdict(dc.replace(cfg, **(cfg_over or {}))),
        features=dc.asdict(feats), disk=dc.asdict(js.disk),
        stars=dc.asdict(js.stars), post=dc.asdict(js.post),
        spectral_coeffs=js.spectral_coeffs,
    )
    return js, ts


@pytest.fixture(scope="module")
def jax_lut_render():
    js, _ = _staged_scenes()
    assert js.spectral_coeffs is None   # JAX's staged scene takes the LUTs
    with jax.disable_jit():
        return np.asarray(j_render_radiance(js, dtype=jnp.float32))


@pytest.mark.parametrize("order", ["block", "row-major"])
def test_staged_spectral_render_matches_jax_lut(jax_lut_render, order):
    _, ts = _staged_scenes(dict(use_pallas=order == "block"))
    assert not ts.march_cfg.fused and ts.spectral_coeffs is None
    out = render_radiance(ts, device="cpu").numpy()
    ref = jax_lut_render
    assert out.shape == ref.shape == (54, 96, 3) and np.isfinite(out).all()
    d = np.abs(out - ref)
    assert np.percentile(d, 99) < 1e-4, np.percentile(d, 99)
    assert d.mean() < 1e-5, d.mean()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_spectral_coefficients_follow_jax(fused):
    """Scene.create and scene_from_numpy give a fused spectral scene the
    Chebyshev tables and a staged one none, as JAX's Scene.create does."""
    jcfg = JMarchConfig(use_pallas=fused, fused=fused)
    feats = JFeatures(spectral_lut=True)
    js = JScene.create(mass=1.0, spin=0.9, march_cfg=jcfg, features=feats)
    cfg = MarchConfig(use_pallas=fused, fused=fused)
    ts = Scene.create(mass=1.0, spin=0.9, march_cfg=cfg,
                      features=Features(spectral_lut=True))
    tn = scene_from_numpy(
        mass=1.0, spin=0.9,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=32, height=16),
        march_cfg=dc.asdict(cfg), features=dc.asdict(feats))
    assert (js.spectral_coeffs is not None) == fused
    assert (ts.spectral_coeffs is not None) == fused
    assert (tn.spectral_coeffs is not None) == fused
    if fused:
        for got, want in zip(ts.spectral_coeffs, js.spectral_coeffs):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=1e-6)


def test_replaced_staged_scene_keeps_chebyshev(monkeypatch):
    """A staged scene made by dataclasses.replace of a fused one keeps its
    coefficients and shades through the Chebyshev fit (JAX
    shading.py:726: use_cheb = spectral and spectral_coeffs is not None)."""
    cam = Camera.create(r=30.0, theta=THETA, fov=0.5, width=24, height=16)
    cfg = MarchConfig(max_steps=24, use_pallas=True, fused=True)
    fused = Scene.create(mass=1.0, spin=0.9, camera=cam, march_cfg=cfg,
                         features=Features(spectral_lut=True))
    staged = dc.replace(fused, march_cfg=dc.replace(cfg, fused=False))
    assert staged.spectral_coeffs is not None
    calls = {"cheb": 0, "lut": 0}
    cheb, lut = shading.disk_emission_cheb_rows, shading.disk_emission_lut_rows

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(shading, "disk_emission_cheb_rows",
                        count("cheb", cheb))
    monkeypatch.setattr(shading, "disk_emission_lut_rows", count("lut", lut))
    img = render_radiance(staged, device="cpu")
    assert torch.isfinite(img).all()
    assert calls["cheb"] > 0 and calls["lut"] == 0
    no_coeffs = dc.replace(staged, spectral_coeffs=None)
    render_radiance(no_coeffs, device="cpu")
    assert calls["lut"] > 0
    # and a staged spectral scene built with the tables matches JAX's
    # Chebyshev twin's tables
    np.testing.assert_allclose(staged.spectral_coeffs[0],
                               spectral_kernel_tables(1.0, 0.9,
                                                      JDiskParams())[0],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("spin", [0.9, 0.999])
def test_scene_luts_are_the_marched_spins_tables(spin):
    """The render paths' tables (pipeline.scene_luts: the scene's mass and
    spin rounded to float32, cached per device) are the very tables
    shade_crossings_rows looks up from the marched 0-dim m and a, so a
    frame's composite is the same either way; a scene whose disk shades
    without them (fused with coefficients, analytic, or a replaced staged
    scene that keeps its coefficients) gets none."""
    cam = Camera.create(r=30.0, theta=THETA, fov=0.5, width=24, height=16)
    cfg = MarchConfig(max_steps=24, use_pallas=True, fused=False)
    staged = Scene.create(mass=1.0, spin=spin, camera=cam, march_cfg=cfg,
                          features=Features(spectral_lut=True))
    luts = pipeline.scene_luts(staged, "cpu")
    m, a = pipeline._mass_spin(staged, "cpu")
    assert luts is shading.disk_luts(float(m), float(a), staged.disk,
                                     torch.device("cpu"))
    assert pipeline.scene_luts(staged, "cpu") is luts
    r_c, phi_c, t_c, lam = (torch.from_numpy(x).reshape(1, -1) for x in
                            _crossings(64, 5, 1.0, 20.0))
    args = (m, a, isco_t(m, a), staged.disk, r_c, phi_c, t_c,
            torch.ones(64, dtype=torch.int32), lam[0])
    given = shading.shade_crossings_rows(*args, spectral=True, luts=luts)
    looked_up = shading.shade_crossings_rows(*args, spectral=True)
    for g, w in zip((*given[0], given[1]), (*looked_up[0], looked_up[1])):
        assert torch.equal(g, w)
    fused = Scene.create(mass=1.0, spin=spin, camera=cam,
                         march_cfg=dc.replace(cfg, fused=True),
                         features=Features(spectral_lut=True))
    analytic = dc.replace(staged, features=Features())
    replaced = dc.replace(fused, march_cfg=cfg)
    for scene in (fused, analytic, replaced):
        assert pipeline.scene_luts(scene, "cpu") is None
