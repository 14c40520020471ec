"""The port's render against the JAX package's, end to end, on the CPU.

The port runs its plain PyTorch version of the render kernel
(``device="cpu"``). The reference is JAX ``render_radiance`` / ``render`` on
the staged jnp path (``use_pallas=False``), executed op by op
(``jax.disable_jit``): each operation then rounds once, as in the port's
plain version and in its CUDA kernel. (Compiled as one program, XLA
contracts multiply-adds and rewrites divisions, and those last-bit
differences grow without bound along the chaotic photon-ring orbits.)
For the spectral disk the JAX scene carries ``spectral_kernel_tables`` so it
shades with the Chebyshev twin (shading.py:726-740), as the fused kernel
does. Bars are tests/test_fused.py's: p99 |d| < 1e-4 and mean |d| < 1e-5.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.render import (
    Camera as JCamera,
    MarchConfig as JMarchConfig,
    Scene as JScene,
    render as j_render,
    render_radiance as j_render_radiance,
)
from blackhole_simulation_tpu.render.pipeline import Features as JFeatures
from blackhole_simulation_tpu.render.shading import spectral_kernel_tables
from blackhole_simulation_tpu_torch.ops.render import (
    render_planes,
    render_planes_kernel,
)
from blackhole_simulation_tpu_torch.render.pipeline import (
    kernel_inputs,
    render,
    render_radiance,
    scene_from_numpy,
)

torch.set_num_threads(1)

THETA = float(jnp.pi / 2 - 0.25)
# test_fused.py's short-horizon config; remat_every=0 runs the JAX march as
# one loop (its forward values do not depend on it).
BASE = dict(max_steps=48, shadow_precull=True, far_step_cap_rate=0.4,
            far_boost_radius=20.0, midpoint_iters=1, remat_every=0)


def _scenes(width, height, spin, features, **cfg_over):
    cfg = JMarchConfig(**{**BASE, **cfg_over})
    cam = JCamera.create(r=30.0, theta=THETA, fov=0.5, width=width,
                         height=height)
    js = JScene.create(mass=1.0, spin=spin, camera=cam, march_cfg=cfg,
                       features=features)
    if features.spectral_lut:
        js = dc.replace(js, spectral_coeffs=spectral_kernel_tables(
            1.0, spin, js.disk))
    ts = scene_from_numpy(
        mass=1.0, spin=spin,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=width, height=height),
        march_cfg=dc.asdict(dc.replace(cfg, use_pallas=True, fused=True)),
        features=dc.asdict(features), disk=dc.asdict(js.disk),
        stars=dc.asdict(js.stars), post=dc.asdict(js.post),
        spectral_coeffs=js.spectral_coeffs,
    )
    return js, ts


CASES = {
    "analytic-a0.9-96x54": (96, 54, 0.9, JFeatures()),
    "spectral-a0.9-96x54": (96, 54, 0.9, JFeatures(spectral_lut=True)),
    "analytic-a0.999-96x54": (96, 54, 0.999, JFeatures()),
    "spectral-a0.999-96x54": (96, 54, 0.999, JFeatures(spectral_lut=True)),
    "spectral-a0.9-50x21": (50, 21, 0.9, JFeatures(spectral_lut=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_radiance_matches_jax(case):
    width, height, spin, feats = CASES[case]
    js, ts = _scenes(width, height, spin, feats)
    with jax.disable_jit():
        ref = np.asarray(j_render_radiance(js, dtype=jnp.float32))
    out = render_radiance(ts, device="cpu")
    assert out.shape == (height, width, 3) and out.dtype == torch.float32
    d = np.abs(out.numpy() - ref)
    assert np.isfinite(out.numpy()).all()
    assert np.percentile(d, 99) < 1e-4, np.percentile(d, 99)
    assert d.mean() < 1e-5, d.mean()


def test_render_supersampled_tonemapped_matches_jax():
    js, ts = _scenes(64, 32, 0.9, JFeatures())
    with jax.disable_jit():
        ref = np.asarray(j_render(js, n_samples=2, dtype=jnp.float32))
    out = render(ts, n_samples=2, device="cpu").numpy()
    assert out.shape == (32, 64, 3)
    assert np.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0
    assert np.abs(out - ref).mean() < 1e-4


def _port_scene(features=None, nrs_params=None, **cfg_over):
    cfg = {**BASE, "use_pallas": True, "fused": True, **cfg_over}
    ts = scene_from_numpy(
        mass=1.0, spin=0.9,
        camera=dict(r=30.0, theta=THETA, phi=0.0, fov=0.5, roll=0.0,
                    width=16, height=8),
        march_cfg=cfg, features=features,
    )
    return dc.replace(ts, nrs_params=nrs_params)


def test_nrs_far_field_raises_only_with_weights():
    # Without trained weights the JAX package renders as if it were off.
    img = render_radiance(_port_scene(dict(nrs_far_field=True)), device="cpu")
    assert img.shape == (8, 16, 3)
    assert torch.equal(img, render_radiance(_port_scene(), device="cpu"))


@pytest.mark.parametrize("entry", ["render", "render_radiance"])
def test_no_silent_cpu_fallback(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = render if entry == "render" else render_radiance
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(_port_scene())
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(_port_scene(), device="cuda")


def test_wrapper_takes_plain_version_only_for_cpu_rows():
    row, st = kernel_inputs(_port_scene(), None, "cpu")
    before = render_planes_kernel.launches
    out = render_planes_kernel(row, st)
    assert render_planes_kernel.launches == before  # no kernel launch on CPU
    assert torch.equal(out, render_planes(row, st))
    steps = torch.empty((st.height, st.width), dtype=torch.int32)
    render_planes_kernel(row, st, steps)
    assert int(steps.max()) <= st.cfg.max_steps and int(steps.min()) >= 0
    with pytest.raises(ValueError):
        render_planes_kernel(row.double(), st)


@pytest.mark.parametrize("size", [(250, 141), (16, 8), (31, 1), (1920, 1080)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_launch_pixel_order_covers_the_frame_in_patches(size):
    """The render kernel's launch order: every pixel of a ragged frame
    once, and each warp's 32 threads an 8 x 4 patch (cut at the frame's
    edge)."""
    from blackhole_simulation_tpu_torch.ops.render import launch_pixel_order

    width, height = size
    order = launch_pixel_order(width, height)
    assert order.numel() == -(-width // 16) * -(-height // 8) * 128
    inside = order[order >= 0]
    assert torch.equal(torch.sort(inside).values,
                       torch.arange(width * height))
    for warp in order.reshape(-1, 32):
        pix = warp[warp >= 0]
        if pix.numel() == 0:
            continue
        x, y = pix % width, pix // width
        assert int(x.min()) % 8 == 0 and int(y.min()) % 4 == 0
        assert int(x.max() - x.min()) < 8 and int(y.max() - y.min()) < 4
        full = (int(x.min()) + 8 <= width) and (int(y.min()) + 4 <= height)
        if full:
            assert pix.numel() == 32
            lane = torch.arange(32)
            assert torch.equal(x - x.min(), lane % 8)
            assert torch.equal(y - y.min(), lane // 8)


def test_launch_steps_follows_the_order():
    from blackhole_simulation_tpu_torch.ops.render import (
        launch_pixel_order,
        launch_steps,
    )

    steps = torch.arange(20 * 9, dtype=torch.int32).reshape(9, 20)
    got = launch_steps(steps)
    order = launch_pixel_order(20, 9)
    assert torch.equal(got[order >= 0], steps.reshape(-1)[order[order >= 0]])
    assert not bool(got[order < 0].any())


def test_lane_efficiency_known_answer():
    """Two warps: one of equal rays (efficiency 1), one with a single
    32-step ray among 4-step rays; and a ragged tail of zeros."""
    from blackhole_simulation_tpu_torch.ops.pallas_march import (
        lane_efficiency,
    )

    steps = torch.tensor([5] * 32 + [32] + [4] * 31)
    want = (5 * 32 + 32 + 4 * 31) / (32 * 5 + 32 * 32)
    assert lane_efficiency(steps) == pytest.approx(want, rel=1e-12)
    assert lane_efficiency(torch.full((32,), 7)) == 1.0
    # a 33rd ray makes a third warp of one ray and 31 empty lanes
    assert lane_efficiency(torch.full((33,), 2)) == pytest.approx(
        66 / (32 * 2 * 2), rel=1e-12)
    assert lane_efficiency(torch.zeros(64, dtype=torch.int32)) == 1.0

