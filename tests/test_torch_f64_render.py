"""The float64 render against the JAX package's, on the CPU, route by route.

The JAX package renders with ``dtype=jnp.float64`` on three routes:

* staged jnp (``use_pallas=False``): float64 end to end. The port's
  ``render_radiance``, ``render`` and ``render_sample_scaled`` with
  ``dtype=torch.float64`` are held to JAX's on scenes with and without
  jets, with ``start_jitter``, the spectral disk's LUTs, ``multistep`` (which
  both staged routes ignore), supersampling with the shadow overlay, and the
  disk scales. Bar: |port - JAX| <= 5e-8 + 1e-6 |JAX| per value, and the
  output float64. (Jitted without fused multiply-adds, JAX agrees with the
  port to ~1e-8 absolute at 256 steps; jitted with them, to ~1.5e-3, the
  chaotic photon-ring rays amplifying the contraction even in float64.)
* fused (``use_pallas`` and ``fused``): float32 planes from the render
  kernel on a parameter row built from the float64 mass and spin. The
  port's image is float32, held to JAX's interpret-mode kernel at the
  fused bars (tests/test_fused.py:56-73: p99 |d| < 1e-4, mean < 1e-5);
  it differs from the port's float32 image only through the row, as JAX's
  float64 image differs from its float32 one.
* staged with ``use_pallas`` and no jets: TypeError in both packages.

The JAX references run jitted in a child process with
``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2`` (no fused multiply-add to contract
into; tests/test_torch_render_ad.py's ``JaxChild``). 12x12 pixels, 256
steps, spin 0.7, r = 30, theta = pi/2 - 0.25, fov 0.5; the fused scenes 48
steps on the flagship march settings. About 60 s on one worker (75 s under
the suite's six), nearly all of it the child's compiles.
"""

import dataclasses as dc
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render import render as j_render
from blackhole_simulation_tpu.render import render_radiance as j_render_radiance
from blackhole_simulation_tpu.render.pipeline import Features as JFeatures
from blackhole_simulation_tpu.render.pipeline import (
    render_sample_scaled as j_render_sample_scaled,
)
from blackhole_simulation_tpu_torch.ops.render import (
    build_param_row,
    render_planes,
)
from blackhole_simulation_tpu_torch.render.camera import camera_rays_u
from blackhole_simulation_tpu_torch.render.march import (
    march_rows,
    march_rows_ad,
)
from blackhole_simulation_tpu_torch.render.pipeline import (
    kernel_inputs,
    render,
    render_radiance,
    render_sample_scaled,
    scene_from_numpy,
)
from test_torch_render_ad import JaxChild

torch.set_num_threads(1)

F64 = torch.float64
THETA = math.pi / 2 - 0.25
W = H = 12
STEPS = 256
SPIN = 0.7
SCALES = (0.8, 1.3)   # render_sample_scaled's density and intensity
# name -> (MarchConfig overrides, Features, entry)
CASES = {
    "analytic": ({}, {}, "radiance"),
    "jets": ({}, dict(jets=True), "radiance"),
    "start_jitter": (dict(start_jitter=0.5), {}, "radiance"),
    "lut": ({}, dict(spectral_lut=True), "radiance"),
    "multistep": (dict(multistep=True), {}, "radiance"),
    "render_overlay": ({}, dict(shadow_overlay=True), "render2"),
    "scaled": ({}, {}, "scaled"),
}
FUSED_CFG = dict(max_steps=48, use_pallas=True, fused=True,
                 shadow_precull=True, far_step_cap_rate=0.4,
                 far_boost_radius=20.0, midpoint_iters=1)


def scenes(cfg_over, feats):
    """The JAX scene and the port's, the same numbers."""
    cfg = JMarchConfig(**{"max_steps": STEPS, "remat_every": 0, **cfg_over})
    jcam = JCamera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5,
                          width=W, height=H)
    js = JScene.create(mass=1.0, spin=SPIN, camera=jcam, march_cfg=cfg,
                       features=JFeatures(**feats))
    ts = scene_from_numpy(
        mass=1.0, spin=SPIN,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=W, height=H),
        march_cfg=dc.asdict(cfg), features=dc.asdict(js.features),
        disk=dc.asdict(js.disk), stars=dc.asdict(js.stars),
        post=dc.asdict(js.post), jet_params=dc.asdict(js.jet_params),
        device="cpu")
    return js, ts


def jax_image(name):
    """JAX's float64 output of the case (run in the child)."""
    over, feats, entry = CASES[name]
    js, _ = scenes(over, feats)
    if entry == "render2":
        out = j_render(js, n_samples=2, dtype=jnp.float64)
    elif entry == "scaled":
        out = j_render_sample_scaled(js, dtype=jnp.float64,
                                     density_scale=SCALES[0],
                                     intensity_scale=SCALES[1])
    else:
        out = j_render_radiance(js, dtype=jnp.float64)
    return out


def port_image(name):
    over, feats, entry = CASES[name]
    _, ts = scenes(over, feats)
    if entry == "render2":
        return render(ts, n_samples=2, device="cpu", dtype=F64)
    if entry == "scaled":
        return render_sample_scaled(ts, density_scale=SCALES[0],
                                    intensity_scale=SCALES[1], device="cpu",
                                    dtype=F64)
    return render_radiance(ts, device="cpu", dtype=F64)


def child_main(names):
    out = {}
    for name in names:
        img = jax_image(name)
        out[name] = {"dtype": str(img.dtype),
                     "img": np.asarray(img, np.float64).tolist()}
    js, _ = scenes(FUSED_CFG, {})
    for dt in ("float32", "float64"):
        img = j_render_radiance(js, dtype=getattr(jnp, dt))
        out[f"fused_{dt}"] = {"dtype": str(img.dtype),
                              "img": np.asarray(img, np.float64).tolist()}
    staged = dc.replace(js, march_cfg=dc.replace(js.march_cfg, fused=False))
    try:
        j_render_radiance(staged, dtype=jnp.float64)
        out["staged_use_pallas"] = "no error"
    except TypeError as e:
        out["staged_use_pallas"] = f"TypeError: {str(e)[:80]}"
    return out


@pytest.fixture(scope="module")
def jax_refs():
    child = JaxChild(__file__, *CASES)
    try:
        return child.result()
    finally:
        child.close()


@pytest.mark.parametrize("name", list(CASES))
def test_float64_staged_matches_jax(jax_refs, name):
    got = port_image(name)
    ref = jax_refs[name]
    assert ref["dtype"] == "float64" and got.dtype == F64
    want = np.asarray(ref["img"])
    got = got.numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    bad = np.abs(got - want) > 5e-8 + 1e-6 * np.abs(want)
    assert not bad.any(), (np.abs(got - want).max(), int(bad.sum()))


def test_float64_differs_from_float32():
    """The float64 route is not the float32 one cast: most pixels move by
    float32's rounding along the march (median |d| below 1e-6), a chaotic
    photon-ring pixel by more (5e-3 here)."""
    _, ts = scenes({}, {})
    a = render_radiance(ts, device="cpu", dtype=F64)
    b = render_radiance(ts, device="cpu")
    assert b.dtype == torch.float32
    d = (a - b.double()).abs()
    assert float(d.max()) > 1e-9 and float(d.median()) < 1e-6, (
        float(d.max()), float(d.median()))


def test_fused_float64_returns_float32_at_the_fused_bars(jax_refs):
    _, ts = scenes(FUSED_CFG, {})
    got = render_radiance(ts, device="cpu", dtype=F64)
    ref = jax_refs["fused_float64"]
    assert got.dtype == torch.float32 and ref["dtype"] == "float32"
    d = np.abs(got.numpy() - np.asarray(ref["img"]))
    assert np.percentile(d, 99) < 1e-4, np.percentile(d, 99)
    assert d.mean() < 1e-5, d.mean()


def test_fused_float64_differs_only_through_the_row(jax_refs):
    """The port's fused float64 image is the render kernel's plain version
    on the float64-built row, bit for bit; that row differs from the
    float32 route's, and so the images do, as little as JAX's do."""
    _, ts = scenes(FUSED_CFG, {})
    img64 = render_radiance(ts, device="cpu", dtype=F64)
    img32 = render_radiance(ts, device="cpu")
    row, st = kernel_inputs(ts, None, "cpu", F64)
    assert torch.equal(img64, render_planes(row, st).permute(1, 2, 0))
    row32 = build_param_row(ts, None)
    row64 = build_param_row(ts, None, F64)
    assert row64.dtype == row32.dtype == np.float32
    assert (row64 != row32).any()
    port_d = float((img64 - img32).abs().max())
    jax_d = float(np.abs(np.asarray(jax_refs["fused_float64"]["img"])
                         - np.asarray(jax_refs["fused_float32"]["img"])).max())
    assert 0.0 < port_d < 1e-4 and 0.0 < jax_d < 1e-4, (port_d, jax_d)


def test_staged_use_pallas_raises_in_float64(jax_refs):
    """JAX's Pallas march fails to trace on float64 rays (its while_loop
    carry turns float32); the port raises TypeError wherever it would
    march them there, and takes float64 with jets (JAX's jnp march)."""
    assert jax_refs["staged_use_pallas"].startswith("TypeError"), jax_refs[
        "staged_use_pallas"]
    _, ts = scenes(dict(FUSED_CFG, fused=False), {})
    for call in (lambda: render_radiance(ts, device="cpu", dtype=F64),
                 lambda: render(ts, device="cpu", dtype=F64),
                 lambda: render_sample_scaled(ts, device="cpu", dtype=F64)):
        with pytest.raises(TypeError):
            call()
    m = torch.tensor(1.0, dtype=F64)
    a = torch.tensor(SPIN, dtype=F64)
    rays = camera_rays_u(ts.camera, m, a, dtype=F64)
    with pytest.raises(TypeError):
        march_rows(rays, m, a, ts.march_cfg)
    with pytest.raises(TypeError):
        march_rows_ad(rays, m, a, ts.march_cfg)
    _, jets = scenes(dict(FUSED_CFG, fused=False), dict(jets=True))
    img = render_radiance(jets, device="cpu", dtype=F64)
    assert img.dtype == F64 and bool(torch.isfinite(img).all())


def test_dtype_is_float32_or_float64():
    _, ts = scenes({}, {})
    with pytest.raises(ValueError):
        render_radiance(ts, device="cpu", dtype=torch.float16)


if __name__ == "__main__":
    # The child process of the jax_refs fixture: one JSON line.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(child_main(sys.argv[1:])))
