"""The port's certified render (the critical-band refinement pass) against
the JAX package's, on the CPU.

The band metric (``render/precull.py``) and its plane in the render kernel's
plain version (``ops/render.py::render_planes``), the selection of
``refine_critical_band`` (single ``top_k`` and the two-stage 4x4-block form,
ties at the cutoff included), and the staged refined render, each held
against the JAX package run op by op (``jax.disable_jit``). Bars:
tests/test_fused.py:158-233's (band plane within 1e-3 of the metric, a thin
band; the fused and staged refined renders p99 < 1e-3; pixels outside the
band untouched, p99.9 < 1e-5) and the staged parity bars (p99 < 1e-4,
mean < 1e-5). The JAX selection is read off which pixels its pass writes
over an all-NaN image.
"""

import dataclasses as dc
import functools
import importlib

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
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays_u
from blackhole_simulation_tpu_torch.render.pipeline import (
    kernel_inputs,
    refine_critical_band,
    render_radiance,
    scene_from_numpy,
    select_band,
)
from blackhole_simulation_tpu_torch.render import precull as tpre
from blackhole_simulation_tpu_torch.ops.render import render_planes

jpre = importlib.import_module("blackhole_simulation_tpu.render.precull")
jpipe = importlib.import_module("blackhole_simulation_tpu.render.pipeline")

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)


def _jbh(spin):
    return Kerr(mass=jnp.float32(1.0), spin=jnp.float32(spin), chart=KS)


def _tms(spin):
    return torch.tensor(1.0), torch.tensor(np.float32(spin))


def test_band_functions_match_jax():
    rng = np.random.default_rng(3)
    n = 4096
    lam = rng.uniform(-8.0, 4.0, n).astype(np.float32)
    eta = rng.uniform(-2.0, 30.0, n).astype(np.float32)
    crit = rng.uniform(0.0, 28.0, n).astype(np.float32)
    m, a = np.float32(1.3), np.float32(-0.8)
    t = lambda x: torch.from_numpy(np.asarray(x))
    with jax.disable_jit():
        ref_d = jpre.band_metric_values(jnp.float32(m), eta, crit, lam,
                                        jnp.float32(-6.9), jnp.float32(2.1))
        ref_w = jpre.pole_w_min_values(jnp.float32(m), jnp.float32(a), lam,
                                       eta)
        ref_f = jpre.fold_pole_metric(ref_d, ref_w, 0.6, 0.05)
    out_d = tpre.band_metric_values(t(m), t(eta), t(crit), t(lam),
                                    t(np.float32(-6.9)), t(np.float32(2.1)))
    out_w = tpre.pole_w_min_values(t(m), t(a), t(lam), t(eta))
    out_f = tpre.fold_pole_metric(out_d, out_w, 0.6, 0.05)
    for out, ref in ((out_d, ref_d), (out_w, ref_w), (out_f, ref_f)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    assert torch.equal(tpre.fold_pole_metric(out_d, out_w, 0.6, 0.0), out_d)


METRIC_CASES = {f"a{spin}-pole{pole}": (spin, pole)
                for spin in (0.9, 0.999, -0.7) for pole in (0.0, 0.05)}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_critical_band_metric_u_matches_jax(case):
    spin, pole = METRIC_CASES[case]
    cam = Camera.create(r=30.0, theta=THETA, fov=0.5, width=48, height=32)
    m, a = _tms(spin)
    rays = camera_rays_u(cam, m, a)
    with jax.disable_jit():
        ref = np.asarray(jpre.critical_band_metric_u(
            jnp.float32(1.0), jnp.float32(spin), jnp.asarray(rays.numpy()),
            refine_band=0.6, refine_pole_w=pole))
    out = tpre.critical_band_metric_u(m, a, rays, 0.6, pole).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert 0.0 < (ref < 0.6).mean() < 0.5


# test_fused.py's short-horizon MarchConfig (BASE) with its refinement.
BASE = dict(max_steps=48, shadow_precull=True, far_step_cap_rate=0.4,
            far_boost_radius=20.0, midpoint_iters=1, remat_every=0,
            step_rate=0.2)


def _scene(width, height, spin, **cfg):
    return scene_from_numpy(
        mass=1.0, spin=spin,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=width, height=height),
        march_cfg={**BASE, **cfg})


def test_band_plane_matches_jax_metric():
    scene = _scene(96, 48, 0.999, use_pallas=True, fused=True,
                   refine_band=0.6, refine_budget=512)
    planes = render_planes(*kernel_inputs(scene, None, "cpu"))
    assert planes.shape == (4, 48, 96)
    jcam = JCamera.create(r=30.0, theta=THETA, fov=0.5, width=96, height=48)
    bh = _jbh(0.999)
    with jax.disable_jit():
        ref = np.asarray(jpre.critical_band_metric_u(
            bh.mass, bh.spin, j_rays(jcam, bh, dtype=jnp.float32)))
    band = planes[3].reshape(-1).numpy()
    assert np.abs(band - ref).max() < 1e-3
    assert 0.0 < (band < 0.6).mean() < 0.05


def _band(kind, n):
    rng = np.random.default_rng(7)
    if kind == "uniform":
        return rng.uniform(0.0, 10.0, n).astype(np.float32)
    # Values on a 0.1 grid: the band overflows the budget and ties sit at
    # the cutoff (the k-th pixel, or the kb-th block minimum).
    return np.round(rng.uniform(0.0, 4.0, n), 1).astype(np.float32)


SELECT_CASES = {
    # (width, height, budget, refine_band, band kind)
    "single": (96, 48, 256, 0.5, "uniform"),
    "single-ties": (96, 48, 256, 1.0, "ties"),
    "two-stage": (128, 64, 2048, 0.5, "uniform"),
    "two-stage-ties": (128, 64, 2048, 1.0, "ties"),
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_selection_matches_jax(case, monkeypatch):
    width, height, budget, width_band, kind = SELECT_CASES[case]
    n = width * height
    band = _band(kind, n)
    cfg = dict(BASE, refine_band=width_band, refine_budget=budget,
               refine_max_steps=4)
    # JAX: the pixels its pass writes over an all-NaN image. Its re-march
    # and composite are stubbed out here (zeros), so only the selection and
    # the scatter run.
    monkeypatch.setattr(jpipe, "march_rows", lambda *args, **kw: None)
    monkeypatch.setattr(jpipe, "shade_march_rows",
                        lambda rows, bh, scene, dtype, lam:
                        (jnp.zeros_like(lam),) * 3)
    jcam = JCamera.create(r=30.0, theta=THETA, fov=0.5, width=width,
                          height=height)
    jcfg = JMarchConfig(**cfg)
    js = JScene.create(mass=1.0, spin=0.9, camera=jcam, march_cfg=jcfg)
    with jax.disable_jit():
        out = jpipe.refine_critical_band(
            js, jcfg, _jbh(0.9), jnp.float32, None,
            jnp.full((n, 3), jnp.nan, jnp.float32), jnp.asarray(band))
    ref = np.flatnonzero(np.isfinite(np.asarray(out)).all(axis=1))
    sel = select_band(torch.from_numpy(band), height, width, budget,
                      width_band).numpy()
    assert sel.shape == (min(budget, n),)
    np.testing.assert_array_equal(np.sort(sel[sel < n]), ref)
    in_band = int((band < width_band).sum())
    assert 0 < ref.size <= min(budget, in_band)
    if case == "single-ties":
        assert ref.size == budget < in_band       # the band overflows
    if case == "two-stage-ties":
        # The block stage leaves band pixels coarse though the budget has
        # room (reference fault 1, reproduced).
        assert ref.size < in_band < budget
    # The port's pass writes exactly those pixels.
    scene = _scene(width, height, 0.9, **cfg)
    rgb = refine_critical_band(scene, scene.march_cfg, None,
                               torch.full((3, n), float("nan")),
                               torch.from_numpy(band))
    np.testing.assert_array_equal(
        np.flatnonzero(torch.isfinite(rgb).all(dim=0).numpy()), ref)


# test_fused.py:188's refined configuration.
REFINED = dict(refine_band=0.5, refine_budget=256, refine_step_rate=0.08,
               refine_max_steps=192)


@functools.cache
def _port(fused: bool, use_pallas: bool, refined: bool = True):
    cfg = dict(REFINED) if refined else {}
    scene = _scene(96, 48, 0.97, use_pallas=use_pallas, fused=fused, **cfg)
    return render_radiance(scene, device="cpu").numpy()


@pytest.fixture(scope="module")
def jax_staged_refined():
    jcam = JCamera.create(r=30.0, theta=THETA, fov=0.5, width=96, height=48)
    js = JScene.create(mass=1.0, spin=0.97, camera=jcam,
                       march_cfg=JMarchConfig(**BASE, **REFINED))
    with jax.disable_jit():
        return np.asarray(j_render_radiance(js, dtype=jnp.float32))


@pytest.mark.parametrize("order", ["row-major", "block"])
def test_staged_refined_matches_jax(jax_staged_refined, order):
    out = _port(False, order == "block")
    ref = jax_staged_refined
    assert out.shape == ref.shape == (48, 96, 3) and np.isfinite(out).all()
    d = np.abs(out - ref)
    assert np.percentile(d, 99) < 1e-4, np.percentile(d, 99)
    assert d.mean() < 1e-5, d.mean()
    # The pass changed the image.
    assert np.abs(out - _port(False, order == "block", False)).max() > 1e-3


def test_fused_refined_matches_staged_refined():
    fused, staged = _port(True, True), _port(False, False)
    assert np.isfinite(fused).all()
    assert np.percentile(np.abs(fused - staged), 99) < 1e-3


def test_pixels_outside_the_band_untouched():
    m, a = _tms(0.97)
    cam = Camera.create(r=30.0, theta=THETA, fov=0.5, width=96, height=48)
    band = tpre.critical_band_metric_u(m, a, camera_rays_u(cam, m, a))
    out_band = (band >= REFINED["refine_band"]).reshape(48, 96).numpy()
    d = np.abs(_port(True, True) - _port(True, True, False)).max(axis=2)
    assert np.percentile(d[out_band], 99.9) < 1e-5
    assert d[~out_band].max() > 1e-3


def test_certified_scene_runs_both_branches_on_the_cpu():
    """The certified configuration (bench.py:195-196) at a small size: the
    fused branch's four planes and a finite image on either branch."""
    cfg = dict(refine_band=0.6, refine_budget=16384, refine_max_steps=64)
    for fused in (True, False):
        scene = _scene(32, 16, 0.999, use_pallas=True, fused=fused, **cfg)
        img = render_radiance(scene, device="cpu")
        assert img.shape == (16, 32, 3) and bool(torch.isfinite(img).all())
    row, st = kernel_inputs(_scene(32, 16, 0.999, use_pallas=True,
                                   fused=True, **cfg), None, "cpu")
    assert render_planes(row, st).shape == (4, 16, 32)
    st3 = dc.replace(st, cfg=dc.replace(st.cfg, refine_band=0.0))
    assert render_planes(row, st3).shape == (3, 16, 32)


def test_refinement_takes_pixel_ids():
    """``pix_ids`` (the JAX twin's): the pass on planes in another pixel
    order, with each position's row-major pixel id, is that order of the
    pass on the row-major planes (a single top_k selection, no ties: the
    same rays)."""
    w, h = 24, 16
    cfg = dict(refine_band=0.6, refine_budget=64, refine_max_steps=96)
    scene = _scene(w, h, 0.97, **cfg)
    m, a = _tms(0.97)
    band = tpre.critical_band_metric_u(m, a, camera_rays_u(scene.camera, m,
                                                           a))
    g = torch.Generator().manual_seed(0)
    rgb = torch.rand((3, w * h), generator=g)
    ref = refine_critical_band(scene, scene.march_cfg, None, rgb, band)
    ids = torch.randperm(w * h, generator=g)
    got = refine_critical_band(scene, scene.march_cfg, None,
                               rgb[:, ids], band[ids], pix_ids=ids)
    assert not torch.equal(ref, rgb)
    assert torch.equal(got, ref[:, ids])
